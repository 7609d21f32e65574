"""Decoder of dense GQA blocks (port of the dense path of
``repro/models/transformer.py``).

Public API, with the JAX names:
    init(cfg, seed, device)                    -> Transformer (random weights)
    load_jax_params(cfg, flat, device)         -> Transformer (the weight bridge)
    flatten_params(tree)                       -> the bridge's flat input
    init_paged_cache(cfg, slots, num_blocks, block_len, max_blocks, ...)
    apply(params, batch, cfg, cache)           -> (logits, aux, cache)

Each weight is stored in the dtype the JAX ``apply`` casts it to where it is
used: block weights, norm scales and the embedding table in ``cfg.dtype``,
the untied ``lm_head`` in float32 (``apply`` unembeds in float32). That
changes no value and keeps Yi-9B at about 18 GB on the card. Other block
kinds (MLA, MoE, recurrent) and shared blocks come with ROADMAP A.10.
"""
from __future__ import annotations

from typing import Dict, Optional

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
    def __init__(self, cfg, *, device, gen: Optional[torch.Generator] = None):
        super().__init__()
        _check_cfg(cfg)
        self.cfg = cfg
        dtype = cm.dtype_of(cfg.dtype)
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
        self.lm_head = leaf((V, d), torch.float32, 0.02)


def init(cfg, seed: int = 0, device=None) -> Transformer:
    """Random weights from a seeded ``torch.Generator`` on the target device
    (JAX spec scales: normal/sqrt(fan_in), embed 1.0, lm_head 0.02, norms 1)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        return Transformer(cfg, device=dev, gen=gen)


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


def load_jax_params(cfg, flat: Dict[str, np.ndarray], device=None) -> Transformer:
    """The weight bridge: JAX params flattened to "seg0/attn/wq"-style paths
    (``seg0`` leaves stacked over layers when there is more than one) ->
    the port's modules, each leaf in its storage dtype."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    n = cfg.num_layers

    def put(param: nn.Parameter, arr: np.ndarray) -> None:
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if tuple(t.shape) != tuple(param.shape):
            raise ValueError(f"shape {tuple(t.shape)} != {tuple(param.shape)}")
        param.data.copy_(t.to(param.dtype))

    def layer(key: str, i: int) -> np.ndarray:
        arr = flat[f"seg0/{key}"]
        return arr[i] if n > 1 else arr

    with torch.no_grad():
        put(model.embed, flat["embed/table"])
        put(model.final_norm, flat["final_norm/scale"])
        put(model.lm_head, flat["lm_head/table"])
        for i, blk in enumerate(model.blocks):
            put(blk.ln1, layer("ln1/scale", i))
            put(blk.ln2, layer("ln2/scale", i))
            for w in ("wq", "wk", "wv", "wo"):
                put(getattr(blk.attn, w), layer(f"attn/{w}", i))
            for w in ("w_gate", "w_up", "w_down"):
                put(getattr(blk.mlp, w), layer(f"mlp/{w}", i))
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
