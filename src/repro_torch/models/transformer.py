"""Decoder of dense GQA blocks (port of the dense path of
``repro/models/transformer.py``).

Public API, with the JAX names:
    init(cfg, seed, device, dtype)             -> Transformer (random weights)
    load_jax_params(cfg, flat, device, dtype)  -> Transformer (the weight bridge)
    flatten_params(tree)                       -> the bridge's flat input
    jax_tree(cfg, named) / from_jax_flat(cfg, flat)
                                               -> the JAX param layout
    init_paged_cache(cfg, slots, num_blocks, block_len, max_blocks, ...)
    apply(params, batch, cfg, cache)           -> (logits, aux, cache)
    loss_fn(params, batch, cfg)                -> (loss, metrics)

Storage. With ``dtype=None`` (serving) each weight is stored in the dtype the
JAX ``apply`` casts it to where it is used: block weights, norm scales and
the embedding table in ``cfg.dtype``, the untied ``lm_head`` in float32
(``apply`` unembeds in float32). That changes no value and keeps Yi-9B at
about 18 GB on the card; the weights do not require grad. With a ``dtype``
(training: ``torch.float32`` master weights, as JAX ``init(cfg, key,
dtype)``) every leaf is stored in it and requires grad; every use casts to
the compute dtype (``.to(x.dtype)``, as JAX ``astype``), a no-op for
serving storage. Other block kinds (MLA, MoE, recurrent) and shared blocks
come with ROADMAP A.10.
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


def _check_cfg(cfg) -> None:
    if set(cfg.block_pattern) != {"dense"} or cfg.shared_block is not None:
        raise NotImplementedError(
            f"block pattern {sorted(set(cfg.block_pattern))} is not ported "
            "yet; the port runs dense GQA blocks (ROADMAP A.10)")
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
            DenseBlock(cfg, dtype=dtype, device=device, gen=gen)
            for _ in range(cfg.num_layers))
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


#: a dense block's leaves: (module path, JAX path under seg0)
_BLOCK_LEAVES = (("ln1", "ln1/scale"), ("ln2", "ln2/scale"),
                 ("attn.wq", "attn/wq"), ("attn.wk", "attn/wk"),
                 ("attn.wv", "attn/wv"), ("attn.wo", "attn/wo"),
                 ("mlp.w_gate", "mlp/w_gate"), ("mlp.w_up", "mlp/w_up"),
                 ("mlp.w_down", "mlp/w_down"))


def jax_layout(cfg) -> List[Tuple[str, str, Optional[int]]]:
    """(parameter name of the port's module, JAX flat path, layer index or
    None): the JAX tree stacks each ``seg0`` leaf over the layers when there
    is more than one (a ``lax.scan`` segment)."""
    n = cfg.num_layers
    out = [("embed", "embed/table", None)]
    for i in range(n):
        out += [(f"blocks.{i}.{mod}", f"seg0/{path}", i if n > 1 else None)
                for mod, path in _BLOCK_LEAVES]
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
    (``seg0`` leaves stacked over layers when there is more than one) ->
    the port's modules, each leaf in its storage dtype (``dtype`` as in
    ``init``)."""
    model = Transformer(cfg, device=resolve_device(device), dtype=dtype)
    copy_into(dict(model.named_parameters()), from_jax_flat(cfg, flat))
    return model


class PagedCache:
    """The paged KV plane of the whole model: per-layer K/V pools and one
    (slots, max_blocks) block table and (slots,) length vector shared by
    every layer. Updated in place."""

    def __init__(self, layers, tables: torch.Tensor, lens: torch.Tensor):
        self.layers = layers
        self.tables = tables
        self.lens = lens

    def view(self, tables: torch.Tensor, lens: torch.Tensor) -> "PagedCache":
        """The same pools seen through caller-supplied table rows and
        lengths (a prefill row); replaces paged_pool_view/_merge."""
        return PagedCache([{"k_pool": c["k_pool"], "v_pool": c["v_pool"],
                            "tables": tables, "lens": lens}
                           for c in self.layers], tables, lens)

    def pool_bytes(self) -> int:
        return sum(c[k].numel() * c[k].element_size()
                   for c in self.layers for k in ("k_pool", "v_pool"))


def init_paged_cache(cfg, slots: int, num_blocks: int, block_len: int,
                     max_blocks: int, dtype=torch.float32, device=None) -> PagedCache:
    """Paged decode cache for kv_impl="paged" (block 0 is scratch)."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    tables = torch.zeros((slots, max_blocks), dtype=torch.int32, device=dev)
    lens = torch.zeros((slots,), dtype=torch.int32, device=dev)
    layers = [attn.gqa_init_paged_cache(cfg, slots, num_blocks, block_len,
                                        max_blocks, dtype, device=dev,
                                        tables=tables, lens=lens)
              for _ in range(cfg.num_layers)]
    return PagedCache(layers, tables, lens)


def apply(params: Transformer, batch: Dict[str, torch.Tensor], cfg=None,
          cache: Optional[PagedCache] = None):
    """batch {"tokens": (B,S) int}. Returns (logits f32, aux 0.0, cache).

    With a paged cache, positions start at ``cache.lens`` and the lengths
    advance by S, in place, after the last layer."""
    cfg = params.cfg if cfg is None else cfg
    x = cm.embed(params.embed, batch["tokens"]).to(cm.dtype_of(cfg.dtype))
    S = x.shape[1]
    for i, blk in enumerate(params.blocks):
        c = cache.layers[i] if cache is not None else None
        x = x + attn.gqa_apply(blk.attn, cm.rmsnorm(blk.ln1, x, cfg.norm_eps),
                               cfg, cache=c)
        h_in = cm.rmsnorm(blk.ln2, x, cfg.norm_eps)
        x = x + mlpm.swiglu_apply(blk.mlp, h_in, cfg)
    if cache is not None:
        cache.lens.add_(S)
    x = cm.rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = cm.unembed(params.lm_head, x.to(torch.float32))
    return logits, 0.0, cache


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
