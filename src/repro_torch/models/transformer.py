"""Decoder over ``cfg.block_pattern`` (port of ``repro/models/transformer.py``
for the block kinds ``dense`` (GQA + SwiGLU), ``mla_dense`` (MLA + SwiGLU of
width ``d_ff_dense``) and ``mla_moe`` (MLA + GShard MoE)).

Public API, with the JAX names:
    init(cfg, seed, device, dtype)             -> Transformer (random weights)
    load_jax_params(cfg, flat, device, dtype)  -> Transformer (the weight bridge)
    flatten_params(tree)                       -> the bridge's flat input
    jax_tree(cfg, named) / from_jax_flat(cfg, flat)
                                               -> the JAX param layout
    init_paged_cache(cfg, slots, num_blocks, block_len, max_blocks, ...)
    apply(params, batch, cfg, cache)           -> (logits, aux, cache)
    loss_fn(params, batch, cfg)                -> (loss, metrics)

The JAX tree groups runs of equal block kinds into segments
(``execution_plan``: DeepSeek-V2-Lite has ``seg0`` = one ``mla_dense``
block, unstacked, and ``seg1`` = 26 ``mla_moe`` blocks stacked); the port
keeps one module per layer, and ``jax_layout`` maps each parameter to its
segment path and index.

Storage. With ``dtype=None`` (serving) each weight is stored in the dtype the
JAX ``apply`` casts it to where it is used: block weights, norm scales and
the embedding table in ``cfg.dtype``, the untied ``lm_head`` in float32
(``apply`` unembeds in float32). That changes no value and keeps Yi-9B at
about 18 GB on the card; the weights do not require grad. With a ``dtype``
(training: ``torch.float32`` master weights, as JAX ``init(cfg, key,
dtype)``) every leaf is stored in it and requires grad; every use casts to
the compute dtype (``.to(x.dtype)``, as JAX ``astype``), a no-op for
serving storage. ``gqa_moe``, the recurrent blocks and shared blocks come
with ROADMAP A.10.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlpm
from repro_torch.models import moe as moem

#: block kinds the port runs
BLOCK_KINDS = ("dense", "mla_dense", "mla_moe")


def _check_cfg(cfg) -> None:
    kinds = set(cfg.block_pattern)
    if not kinds <= set(BLOCK_KINDS) or cfg.shared_block is not None:
        raise NotImplementedError(
            f"block pattern {sorted(kinds)} is not ported yet; the port runs "
            f"{', '.join(BLOCK_KINDS)} blocks (ROADMAP A.10)")
    if kinds & {"mla_dense", "mla_moe"} and cfg.mla is None:
        raise ValueError("MLA blocks need cfg.mla")
    if "mla_moe" in kinds and cfg.moe is None:
        raise ValueError("MoE blocks need cfg.moe")
    if cfg.mlp_kind != "swiglu" or cfg.tie_embeddings:
        raise NotImplementedError(
            "the port runs untied SwiGLU models (ROADMAP A.10)")
    if cfg.input_mode != "tokens":
        raise NotImplementedError("the port takes token inputs")
    if cfg.remat != "none":
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported yet (ROADMAP A.11: per-layer "
            "activation checkpointing)")


class DenseBlock(nn.Module):
    def __init__(self, cfg, *, dtype, device, gen=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                requires_grad=False)
        self.attn = attn.GQAttention(cfg, dtype=dtype, device=device, gen=gen)
        self.ln2 = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                requires_grad=False)
        self.mlp = mlpm.SwiGLU(d, cfg.d_ff, dtype=dtype, device=device, gen=gen)

    def forward_block(self, x, cfg, cache):
        x = x + attn.gqa_apply(self.attn, cm.rmsnorm(self.ln1, x, cfg.norm_eps),
                               cfg, cache=cache)
        h_in = cm.rmsnorm(self.ln2, x, cfg.norm_eps)
        return x + mlpm.swiglu_apply(self.mlp, h_in, cfg), None


class MLABlock(nn.Module):
    """``mla_dense`` (ffn: SwiGLU of width d_ff_dense) or ``mla_moe`` (ffn:
    the GShard MoE), as the JAX ``_mla_spec_factory``."""

    def __init__(self, cfg, kind: str, *, dtype, device, gen=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                requires_grad=False)
        self.attn = attn.MLAttention(cfg, dtype=dtype, device=device, gen=gen)
        self.ln2 = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                requires_grad=False)
        self.is_moe = kind == "mla_moe"
        self.ffn = (moem.MoE(cfg, dtype=dtype, device=device, gen=gen) if self.is_moe
                    else mlpm.SwiGLU(d, cfg.d_ff_dense, dtype=dtype,
                                     device=device, gen=gen))

    def forward_block(self, x, cfg, cache):
        x = x + attn.mla_apply(self.attn, cm.rmsnorm(self.ln1, x, cfg.norm_eps),
                               cfg, cache=cache)
        h_in = cm.rmsnorm(self.ln2, x, cfg.norm_eps)
        if self.is_moe:
            h, aux = moem.moe_apply(self.ffn, h_in, cfg)
            return x + h, aux
        return x + mlpm.swiglu_apply(self.ffn, h_in, cfg), None


def _block(cfg, kind, **kw) -> nn.Module:
    return DenseBlock(cfg, **kw) if kind == "dense" else MLABlock(cfg, kind, **kw)


class Transformer(nn.Module):
    """``dtype=None``: serving storage; a dtype: every leaf in it, trainable
    (see the module docstring)."""

    def __init__(self, cfg, *, device, gen: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        _check_cfg(cfg)
        self.cfg = cfg
        trainable = dtype is not None
        head_dtype = torch.float32 if dtype is None else dtype
        dtype = cm.dtype_of(cfg.dtype) if dtype is None else dtype
        V, d = cfg.vocab_size, cfg.d_model

        def leaf(shape, dt, std):
            w = (cm.init_normal(shape, gen, dt, device, std) if gen is not None
                 else torch.empty(shape, dtype=dt, device=device))
            return nn.Parameter(w, requires_grad=False)

        self.embed = leaf((V, d), dtype, 1.0)
        self.blocks = nn.ModuleList(
            _block(cfg, kind, dtype=dtype, device=device, gen=gen)
            for kind in cfg.block_pattern)
        self.final_norm = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                       requires_grad=False)
        self.lm_head = leaf((V, d), head_dtype, 0.02)
        self.requires_grad_(trainable)


def init(cfg, seed: int = 0, device=None, dtype: Optional[torch.dtype] = None
         ) -> Transformer:
    """Random weights from a seeded ``torch.Generator`` on the target device
    (JAX spec scales: normal/sqrt(fan_in), embed 1.0, lm_head 0.02, norms 1).
    ``dtype``: None for serving storage, ``torch.float32`` for trainable
    master weights."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        return Transformer(cfg, device=dev, gen=gen, dtype=dtype)


def flatten_params(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict of arrays (a JAX param tree, a checkpoint) -> flat
    {"seg0/attn/wq": ndarray} paths, the form ``load_jax_params`` takes."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten_params(v, path + "/"))
        else:
            flat[path] = np.asarray(v)
    return flat


_SWIGLU = ("w_gate", "w_up", "w_down")
_NORMS = ("ln1", "ln2", "kv_norm")


def _block_leaves(cfg, kind: str) -> Tuple[str, ...]:
    """A block's parameter names, relative to the block module."""
    if kind == "dense":
        return (("ln1", "ln2") + tuple(f"attn.{w}" for w in ("wq", "wk", "wv", "wo"))
                + tuple(f"mlp.{w}" for w in _SWIGLU))
    out = (("ln1", "ln2")
           + tuple(f"attn.{w}" for w in ("wq", "wkv_a", "kv_norm", "wkv_b", "wo")))
    if kind == "mla_dense":
        return out + tuple(f"ffn.{w}" for w in _SWIGLU)
    out += ("ffn.router",) + tuple(f"ffn.{w}" for w in _SWIGLU)
    if cfg.moe.num_shared_experts:
        out += tuple(f"ffn.shared.{w}" for w in _SWIGLU)
    return out


def _jax_leaf_path(mod: str) -> str:
    """"attn.kv_norm" -> "attn/kv_norm/scale" (norms are {"scale": ...})."""
    path = mod.replace(".", "/")
    return path + "/scale" if mod.rsplit(".", 1)[-1] in _NORMS else path


def segments(cfg) -> List[Tuple[int, str, int, int]]:
    """The JAX ``execution_plan`` without shared blocks: runs of equal block
    kinds as (segment index, kind, first layer, count)."""
    out, i = [], 0
    pattern = cfg.block_pattern
    while i < len(pattern):
        j = i
        while j < len(pattern) and pattern[j] == pattern[i]:
            j += 1
        out.append((len(out), pattern[i], i, j - i))
        i = j
    return out


def jax_layout(cfg) -> List[Tuple[str, str, Optional[int]]]:
    """(parameter name of the port's module, JAX flat path, index or None):
    layer i of segment k maps to ``seg{k}/...``, stacked at index i - first
    when the segment has more than one layer (a ``lax.scan`` segment)."""
    out = [("embed", "embed/table", None)]
    for k, kind, first, count in segments(cfg):
        leaves = _block_leaves(cfg, kind)
        for i in range(first, first + count):
            out += [(f"blocks.{i}.{mod}", f"seg{k}/{_jax_leaf_path(mod)}",
                     i - first if count > 1 else None) for mod in leaves]
    out += [("final_norm", "final_norm/scale", None),
            ("lm_head", "lm_head/table", None)]
    return out


def _nest(flat: Dict[str, object]) -> Dict[str, object]:
    tree: Dict[str, object] = {}
    for path, leaf in flat.items():
        *heads, last = path.split("/")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return tree


def jax_tree(cfg, named: Dict[str, torch.Tensor], like: bool = False):
    """Tensors keyed by the module's parameter names (the params, or the
    AdamW moments) -> the JAX param tree: nested dicts of host numpy copies,
    ``seg0`` leaves stacked over layers. ``like=True`` gives meta tensors of
    the same shapes instead (a restore template, nothing copied)."""
    groups: Dict[str, list] = {}
    for name, path, _ in jax_layout(cfg):
        groups.setdefault(path, []).append(named[name])
    flat = {}
    for path, ts in groups.items():
        if like:
            shape = (len(ts),) + tuple(ts[0].shape) if len(ts) > 1 else ts[0].shape
            flat[path] = torch.empty(shape, dtype=ts[0].dtype, device="meta")
        else:
            # stacked where the tensors live, then one copy to the host
            # (torch.stack already made a new tensor)
            ts = [t.detach() for t in ts]
            leaf = torch.stack(ts) if len(ts) > 1 else ts[0]
            flat[path] = leaf.to("cpu", copy=len(ts) == 1).numpy()
    return _nest(flat)


def from_jax_flat(cfg, flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Flat JAX paths ("seg0/attn/wq", ``flatten_params`` of a JAX tree or a
    checkpoint) -> arrays keyed by the module's parameter names (``seg0``
    unstacked)."""
    return {name: (flat[path][i] if i is not None else flat[path])
            for name, path, i in jax_layout(cfg)}


def copy_into(named: Dict[str, torch.Tensor], arrays: Dict[str, np.ndarray]) -> None:
    """Copy host arrays into tensors of the same names and shapes, each cast
    to its tensor's dtype (floating arrays by way of float32, which also
    reads JAX's bfloat16)."""
    with torch.no_grad():
        for name, t in named.items():
            a = np.asarray(arrays[name], dtype=np.float32
                           if t.is_floating_point() else None)
            a = torch.from_numpy(a if a.flags.writeable else a.copy())
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(a.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(a)


def load_jax_params(cfg, flat: Dict[str, np.ndarray], device=None,
                    dtype: Optional[torch.dtype] = None) -> Transformer:
    """The weight bridge: JAX params flattened to "seg0/attn/wq"-style paths
    (a segment's leaves stacked over its layers when it has more than one) ->
    the port's modules, each leaf in its storage dtype (``dtype`` as in
    ``init``)."""
    model = Transformer(cfg, device=resolve_device(device), dtype=dtype)
    copy_into(dict(model.named_parameters()), from_jax_flat(cfg, flat))
    return model


def _pools(layer: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in layer.items() if k.endswith("_pool")}


class PagedCache:
    """The paged KV plane of the whole model: per-layer pools (K/V for GQA,
    compressed latent and rope key for MLA) and one (slots, max_blocks)
    block table and (slots,) length vector shared by every layer. Updated
    in place."""

    def __init__(self, layers, tables: torch.Tensor, lens: torch.Tensor):
        self.layers = layers
        self.tables = tables
        self.lens = lens

    def view(self, tables: torch.Tensor, lens: torch.Tensor) -> "PagedCache":
        """The same pools seen through caller-supplied table rows and
        lengths (a prefill row); replaces paged_pool_view/_merge."""
        return PagedCache([{**_pools(c), "tables": tables, "lens": lens}
                           for c in self.layers], tables, lens)

    def pool_bytes(self) -> int:
        """Resident bytes of every layer's pools."""
        return sum(t.numel() * t.element_size()
                   for c in self.layers for t in _pools(c).values())


#: per-layer paged cache of each block kind
PAGED_CACHE_FNS = {
    "dense": attn.gqa_init_paged_cache,
    "mla_dense": attn.mla_init_paged_cache,
    "mla_moe": attn.mla_init_paged_cache,
}


def init_paged_cache(cfg, slots: int, num_blocks: int, block_len: int,
                     max_blocks: int, dtype=torch.float32, device=None) -> PagedCache:
    """Paged decode cache for kv_impl="paged" (block 0 is scratch)."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    tables = torch.zeros((slots, max_blocks), dtype=torch.int32, device=dev)
    lens = torch.zeros((slots,), dtype=torch.int32, device=dev)
    layers = [PAGED_CACHE_FNS[kind](cfg, slots, num_blocks, block_len,
                                    max_blocks, dtype, device=dev,
                                    tables=tables, lens=lens)
              for kind in cfg.block_pattern]
    return PagedCache(layers, tables, lens)


def apply(params: Transformer, batch: Dict[str, torch.Tensor], cfg=None,
          cache: Optional[PagedCache] = None):
    """batch {"tokens": (B,S) int}. Returns (logits f32, aux, cache): aux is
    the MoE layers' load-balancing losses summed (a float32 scalar tensor),
    0.0 for a model without MoE layers.

    With a paged cache, positions start at ``cache.lens`` and the lengths
    advance by S, in place, after the last layer."""
    cfg = params.cfg if cfg is None else cfg
    x = cm.embed(params.embed, batch["tokens"]).to(cm.dtype_of(cfg.dtype))
    S = x.shape[1]
    aux_total = 0.0
    for i, blk in enumerate(params.blocks):
        c = cache.layers[i] if cache is not None else None
        x, aux = blk.forward_block(x, cfg, c)
        if aux is not None:
            aux_total = aux_total + aux
    if cache is not None:
        cache.lens.add_(S)
    x = cm.rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = cm.unembed(params.lm_head, x.to(torch.float32))
    return logits, aux_total, cache


def loss_fn(params: Transformer, batch: Dict[str, torch.Tensor], cfg=None):
    """Next-token cross entropy against ``batch["labels"]`` (masked by
    ``batch["mask"]`` when given), through the log-softmax of
    ``cfg.loss_impl`` (train/losses.py). Returns (loss + aux, metrics)."""
    from repro_torch.train import losses  # keeps models importable alone

    cfg = params.cfg if cfg is None else cfg
    logits, aux, _ = apply(params, batch, cfg)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=logits.device)
    labels = batch["labels"]
    mask = batch.get("mask")
    loss = losses.cross_entropy(logits, labels, mask,
                                impl=getattr(cfg, "loss_impl", "exact"))
    return loss + aux, {"loss": loss, "aux": aux, "ppl_proxy": loss}
