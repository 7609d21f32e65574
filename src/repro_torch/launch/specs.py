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
rows ``batch_spec`` gives the rank. A batch that the data axes do not
divide (long_500k's one row) is whole on every rank: the port has no
sequence-parallel attention to split its positions (ROADMAP A.17,
``kv_shard="seq_model"``), so every data rank holds the whole row.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as tf

META = torch.device("meta")


def abstract_params(cfg, mesh=None) -> tf.Transformer:
    """The serving model (``dtype=None`` storage) on meta, at the rank's
    cut of ``mesh`` (whole without one); ``.mesh`` set, as ``tf.init``."""
    cut = shd.slicing_leaves(mesh) if mesh is not None else contextlib.nullcontext()
    with torch.no_grad(), cut:
        model = tf.Transformer(cfg, device=META, dtype=None)
    model.mesh = mesh
    return model


def rank_rows(mesh, shape: ShapeConfig) -> int:
    """The rows of the global batch one rank serves (``batch_spec``); the
    whole batch when the data axes do not divide it."""
    if mesh is None:
        return shape.global_batch
    spec = shd.batch_spec(mesh, shape.global_batch, shape.seq_len)
    return shape.global_batch // shd.dp_size(mesh) if spec and spec[0] else shape.global_batch


def abstract_cache(cfg, mesh, shape: ShapeConfig) -> tf.DenseCache:
    """The dense plane's cache of the rank's rows at ``shape.seq_len``
    positions, on meta."""
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


def memory(params: tf.Transformer, cache: tf.DenseCache) -> Dict[str, int]:
    """The rank's resident bytes: params, cache (KV buffers and recurrent
    state) and their sum. Replaces XLA's ``memory_analysis``."""
    p = nbytes(params.parameters())
    c = nbytes(v for layer in cache.layers for k, v in layer.items() if k != "idx")
    state = nbytes(v for layer in cache.layers if "idx" not in layer
                   for v in layer.values())
    return {"params_bytes": p, "cache_bytes": c, "state_bytes": state,
            "total_bytes": p + c}
