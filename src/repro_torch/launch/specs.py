"""Abstract params, caches and inputs for the dry run (port of
``repro/launch/specs.py``): built on ``torch.device("meta")`` at one
rank's cut of a given mesh, so nothing is allocated, with the rank's bytes.

The JAX module gives ShapeDtypeStructs and NamedShardings for GSPMD to
place. The port has no partitioner: a rank's view is what it holds. Params
are the serving cut of distributed/sharding.py (``slicing_leaves``): the
rank's slice of every leaf the rules cut, whole leaves elsewhere, and
Mamba2's whole B / C columns (sharding.py's docstring). Caches are the
engine's dense plane at the rank's width (KV heads over the model axis
where they divide, the recurrent states of a cut mixer), float32 as the
engine allocates them (the JAX dry run's caches are bfloat16), for the
rows ``batch_spec`` gives the rank. Under ``kv_shard="seq_model"`` the
attention buffers hold the rank's span of the positions over the model
axis, every KV head (the JAX spec's ``PS(b, "model", ...)``; the caller
resolves the knob first, ``shd.resolve_kv_shard``). A batch that the data
axes do not divide (long_500k's one row) is whole on every data rank, and
under the heads cut its attention buffers hold the rank's span of the
positions over the data axes with its model rank's KV heads (the JAX
default ``cache_spec``: ``PS(None, dp, mdl(KH), None)``, ``PS(None, dp,
None)``; ``resolve_kv_shard(..., batch=)`` sets ``kv_shard="seq_data"``).

The train state (``abstract_train_state``) is the training cut (the JAX
``params_shardings``: the embedding vocabulary-cut) in float32 master
weights, AdamW's moments (under ZeRO-1 the rank's data slice of each leaf:
``state_specs``, the JAX ``state_shardings``) and, with ``compress``, the
error-feedback buffers.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib

META = torch.device("meta")


def abstract_params(cfg, mesh=None) -> tf.Transformer:
    """The serving model (``dtype=None`` storage) on meta, at the rank's
    cut of ``mesh`` (whole without one); ``.mesh`` set, as ``tf.init``."""
    cut = shd.slicing_leaves(mesh) if mesh is not None else contextlib.nullcontext()
    with torch.no_grad(), cut:
        model = tf.Transformer(cfg, device=META, dtype=None)
    model.mesh = mesh
    return model


def abstract_train_state(cfg, mesh=None, zero1: bool = False,
                         compress: bool = False) -> step_lib.TrainState:
    """The rank's train state on meta: float32 master weights at the
    training cut of ``mesh``, the AdamW moments (under ``zero1`` the rank's
    data slice of each leaf) and, with ``compress``, the error-feedback
    buffers."""
    cut = (shd.slicing_leaves(mesh, train=True) if mesh is not None
           else contextlib.nullcontext())
    with torch.no_grad(), cut:
        model = tf.Transformer(cfg, device=META, dtype=torch.float32)
    model.mesh = mesh
    named = step_lib.named_params(model)
    slices = shd.zero1_slices(model, mesh) if zero1 else {}
    opt = adamw.init({k: step_lib._narrow(p, slices.get(k)) for k, p in named.items()})
    return step_lib.TrainState(model, opt, comp.init_error_state(named) if compress
                               else None)


def state_specs(cfg, mesh, zero1: bool = False) -> Dict[str, tuple]:
    """{parameter name: (param spec, moment spec)} of every leaf, the JAX
    ``state_shardings`` specs (trailing whole dims dropped): the rules on
    the whole leaf, and under ``zero1`` the moments extended over the data
    axes (``shd.zero1_spec``)."""
    with torch.no_grad():
        model = tf.Transformer(cfg, device=META, dtype=torch.float32)
    out = {}
    for name, axes in shd.param_axes(model).items():
        shape = tuple(model.get_parameter(name).shape)
        spec = shd.spec_for_axes(axes, shape, mesh)
        out[name] = (spec, shd.zero1_spec(spec, shape, mesh) if zero1 else spec)
    return out


def train_input_specs(cfg, mesh, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """{"tokens", "labels"}: (rows, seq_len) int64 on meta, the rank's rows
    of the global batch (an embeds arch trains on token ids, as the
    port's launcher trains it)."""
    rows = rank_rows(mesh, shape)
    return {k: torch.empty((rows, shape.seq_len), dtype=torch.int64, device=META)
            for k in ("tokens", "labels")}


def rank_rows(mesh, shape: ShapeConfig) -> int:
    """The rows of the global batch one rank serves (``batch_spec``); the
    whole batch when the data axes do not divide it."""
    if mesh is None:
        return shape.global_batch
    spec = shd.batch_spec(mesh, shape.global_batch, shape.seq_len)
    return shape.global_batch // shd.dp_size(mesh) if spec and spec[0] else shape.global_batch


def abstract_cache(cfg, mesh, shape: ShapeConfig) -> tf.DenseCache:
    """The dense plane's cache of the rank's rows at ``shape.seq_len``
    positions (the rank's span of them under ``kv_shard="seq_model"`` or
    "seq_data"), on meta."""
    return tf.init_cache(cfg, rank_rows(mesh, shape), shape.seq_len, torch.float32,
                         device=META, kv_heads=shd.local_kv_heads(cfg, mesh),
                         mesh=mesh)


def prefill_input_specs(cfg, mesh, shape: ShapeConfig) -> torch.Tensor:
    """(rows, seq_len) int64 token ids on meta: the engine's prefill
    tokens (an embeds arch is served on token ids, as its launcher)."""
    return torch.empty((rank_rows(mesh, shape), shape.seq_len), dtype=torch.int64,
                       device=META)


def decode_input_specs(cfg, mesh, shape: ShapeConfig) -> torch.Tensor:
    """(rows, 1) int64 token ids on meta."""
    return torch.empty((rank_rows(mesh, shape), 1), dtype=torch.int64, device=META)


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def memory(params: tf.Transformer, cache: tf.DenseCache = None,
           opt: adamw.AdamWState = None, err=None) -> Dict[str, int]:
    """The rank's resident bytes: params, cache (KV buffers and recurrent
    state), the optimizer's moments and the error-feedback buffers (a
    train state), and their sum. Replaces XLA's ``memory_analysis``."""
    p = nbytes(params.parameters())
    layers = cache.layers if cache is not None else []
    c = nbytes(v for layer in layers for k, v in layer.items() if k != "idx")
    state = nbytes(v for layer in layers if "idx" not in layer
                   for v in layer.values())
    o = nbytes(list(opt.mu.values()) + list(opt.nu.values())) if opt is not None else 0
    e = nbytes(err.values()) if err is not None else 0
    return {"params_bytes": p, "cache_bytes": c, "state_bytes": state,
            "opt_bytes": o, "err_bytes": e, "total_bytes": p + c + o + e}
