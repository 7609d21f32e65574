"""Decoder over ``cfg.block_pattern`` (port of ``repro/models/transformer.py``
for the block kinds ``dense`` (GQA + SwiGLU, or the GELU MLP under
``cfg.mlp_kind="gelu"``), ``gqa_moe`` (GQA + GShard MoE), ``mla_dense``
(MLA + SwiGLU of width ``d_ff_dense``), ``mla_moe`` (MLA + GShard MoE),
``mamba2`` (models/ssm.py), ``mlstm`` and ``slstm`` (models/xlstm.py), and
a shared block).

Public API, with the JAX names:
    init(cfg, seed, device, dtype, mesh)       -> Transformer (random weights)
    load_jax_params(cfg, flat, device, dtype, mesh)
                                               -> Transformer (the weight bridge)
    flatten_params(tree)                       -> the bridge's flat input
    jax_tree(cfg, named) / from_jax_flat(cfg, flat)
                                               -> the JAX param layout
    execution_plan(cfg) / num_shared_apps(cfg)
    init_paged_cache(cfg, slots, num_blocks, block_len, max_blocks, ...)
    init_cache(cfg, batch, max_len, ...)       -> DenseCache (kv_impl="dense")
    override_cache_length(cache, length)       pins the positions, in place
    stack_caches / insert_slot / take_slot     slot rows of a DenseCache
    apply(params, batch, cfg, cache)           -> (logits, aux, cache)
    loss_fn(params, batch, cfg)                -> (loss, metrics)

The JAX tree groups runs of equal block kinds into segments
(``execution_plan``: DeepSeek-V2-Lite has ``seg0`` = one ``mla_dense``
block, unstacked, and ``seg1`` = 26 ``mla_moe`` blocks stacked; xLSTM's 7:1
pattern gives 12 segments, runs of seven ``mlstm`` blocks each followed by
one ``slstm``); a shared-block application ends a run, and the shared
block's weights are the top-level ``shared`` subtree. The port keeps one
module per layer (and ``shared`` once), and ``jax_layout`` maps each
parameter to its segment path and index.

A shared block (``cfg.shared_block``, any block kind; Zamba2's is
``"dense"``) is applied after every ``shared_period``-th layer with the same
weights, each application with a cache of its own (the DenseCache's layers
after the blocks' own).

Inputs are token ids (``batch["tokens"]``) or, under
``cfg.input_mode="embeds"``, precomputed (B,S,d) embeddings
(``batch["embeds"]``, models/frontends.py), prefill and decode alike; the
``embed`` table then stays a leaf of the tree and is not read. With
``cfg.tie_embeddings`` the logits come from the ``embed`` table and there
is no ``lm_head`` leaf. ``cfg.remat`` rematerialises each block of the
blocks' runs in the backward pass (``torch.utils.checkpoint``): ``"full"``
recomputes the whole block, ``"dots"`` keeps the outputs of the matrix
products without batch dims (``aten.mm`` / ``aten.addmm``, the counterpart
of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``) and
recomputes the rest; as in JAX, the shared block's applications are not
wrapped. Only a forward without a cache and with grad mode on is wrapped:
the values, and so the gradients, are those of ``remat="none"`` bit for bit.

Storage. With ``dtype=None`` (serving) each weight is stored in the dtype the
JAX ``apply`` casts it to where it is used: block weights, norm scales and
the embedding table in ``cfg.dtype``, the untied ``lm_head`` in float32
(``apply`` unembeds in float32). That changes no value and keeps Yi-9B at
about 18 GB on the card; the weights do not require grad. With a ``dtype``
(training: ``torch.float32`` master weights, as JAX ``init(cfg, key,
dtype)``) every leaf is stored in it and requires grad; every use casts to
the compute dtype (``.to(x.dtype)``, as JAX ``astype``), a no-op for
serving storage. The recurrent caches hold float32 state whatever cache
dtype is asked for, as the JAX ``_mamba_cache`` / ``_mlstm_cache`` /
``_slstm_cache``.

Tensor parallelism. ``init`` and ``load_jax_params`` with a ``mesh``
(launch/mesh.py) build one rank's shard (distributed/sharding.py): each
leaf is drawn or loaded whole, then cut to the rank's slice, so the shard
holds the tp = 1 weights exactly and a rank's peak is its shard plus the
largest leaf. The model keeps its mesh (``model.mesh``); ``apply`` enters
it for the blocks' reductions and gathers the vocabulary-parallel logits
(``gather_logits=False`` returns the rank's slice, for a caller that
gathers them itself). The caches take a rank's KV heads
(``kv_heads``) and, under a ``mesh``, a rank's recurrent state (a cut
mixer's heads: models/ssm.py, models/xlstm.py).

Training on a mesh (train/step.py) takes the training cut (``train=True``:
the JAX ``params_shardings``, so the embedding is vocabulary-cut, and a
tied head with it): a rank looks up the tokens of its rows of the table,
zeros elsewhere, and one sum over the model axis gives every rank the
whole embedding; the head's input takes its gradient summed over the
model axis, and the loss reads the gathered logits. Every collective of
the blocks has its backward (distributed/sharding.py).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlpm
from repro_torch.models import moe as moem
from repro_torch.models import ssm as ssmm
from repro_torch.models import xlstm as xlm

#: block kinds with an attention KV cache (the paged plane's), and the
#: recurrent ones, whose O(1) state rides on the dense plane only
ATTENTION_KINDS = ("dense", "gqa_moe", "mla_dense", "mla_moe")
RECURRENT_KINDS = ("mamba2", "mlstm", "slstm")
BLOCK_KINDS = ATTENTION_KINDS + RECURRENT_KINDS
MOE_KINDS = ("gqa_moe", "mla_moe")
MLP_KINDS = ("swiglu", "gelu")
INPUT_MODES = ("tokens", "embeds")
REMAT_MODES = ("none", "full", "dots")


def attention_only(cfg) -> bool:
    """Every block kind (the shared block's too) has an attention KV cache:
    the archs the paged plane and bucket-padded prefill serve. A recurrent
    scan folds every pad token into its state, so the others prefill at
    exact length on the dense plane."""
    kinds = set(cfg.block_pattern) | ({cfg.shared_block} if cfg.shared_block
                                      else set())
    return kinds <= set(ATTENTION_KINDS)


def _check_cfg(cfg) -> None:
    kinds = set(cfg.block_pattern) | ({cfg.shared_block} if cfg.shared_block else set())
    if not kinds <= set(BLOCK_KINDS):
        raise ValueError(f"block kinds {sorted(kinds - set(BLOCK_KINDS))} not in "
                         f"{BLOCK_KINDS}")
    if kinds & {"mla_dense", "mla_moe"} and cfg.mla is None:
        raise ValueError("MLA blocks need cfg.mla")
    if kinds & set(MOE_KINDS) and cfg.moe is None:
        raise ValueError("MoE blocks need cfg.moe")
    if "mamba2" in kinds and cfg.ssm is None:
        raise ValueError("mamba2 blocks need cfg.ssm")
    if kinds & {"mlstm", "slstm"} and cfg.xlstm is None:
        raise ValueError("xLSTM blocks need cfg.xlstm")
    if cfg.mlp_kind not in MLP_KINDS:
        raise ValueError(f"mlp_kind {cfg.mlp_kind!r} not in {MLP_KINDS}")
    if cfg.input_mode not in INPUT_MODES:
        raise ValueError(f"input_mode {cfg.input_mode!r} not in {INPUT_MODES}")
    if cfg.remat not in REMAT_MODES:
        raise ValueError(f"remat {cfg.remat!r} not in {REMAT_MODES}")


def _norm(d, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                        requires_grad=False)


class DenseBlock(nn.Module):
    """``dense`` (ffn: SwiGLU of width d_ff, or the GELU MLP under
    ``cfg.mlp_kind="gelu"``) or ``gqa_moe`` (ffn: the GShard MoE), both on
    GQA attention."""

    def __init__(self, cfg, kind: str = "dense", *, dtype, device, gen=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _norm(d, dtype, device)
        self.attn = attn.GQAttention(cfg, dtype=dtype, device=device, gen=gen)
        self.ln2 = _norm(d, dtype, device)
        self.is_moe = kind == "gqa_moe"
        if self.is_moe:
            self.ffn = moem.MoE(cfg, dtype=dtype, device=device, gen=gen)
        else:
            mlp = mlpm.SwiGLU if cfg.mlp_kind == "swiglu" else mlpm.GeluMLP
            self.mlp = mlp(d, cfg.d_ff, dtype=dtype, device=device, gen=gen)

    def forward_block(self, x, cfg, cache):
        x = x + attn.gqa_apply(self.attn, cm.rmsnorm(self.ln1, x, cfg.norm_eps),
                               cfg, cache=cache)
        h_in = cm.rmsnorm(self.ln2, x, cfg.norm_eps)
        if self.is_moe:
            h, aux = moem.moe_apply(self.ffn, h_in, cfg)
            return x + h, aux
        mlp_apply = (mlpm.swiglu_apply if cfg.mlp_kind == "swiglu"
                     else mlpm.gelu_mlp_apply)
        return x + mlp_apply(self.mlp, h_in, cfg, cm.products_of(cache)), None


#: the recurrent mixers: (module, apply)
MIXERS = {"mamba2": (ssmm.Mamba2, ssmm.mamba2_apply),
          "mlstm": (xlm.MLSTM, xlm.mlstm_apply),
          "slstm": (xlm.SLSTM, xlm.slstm_apply)}


class RecurrentBlock(nn.Module):
    """``mamba2``, ``mlstm`` or ``slstm``: x + mixer(rmsnorm(x)), as the JAX
    ``_mamba_apply`` / ``_mlstm_apply`` / ``_slstm_apply``."""

    def __init__(self, cfg, kind: str, *, dtype, device, gen=None):
        super().__init__()
        self.ln = _norm(cfg.d_model, dtype, device)
        module, self._apply = MIXERS[kind]
        self.mixer = module(cfg, dtype=dtype, device=device, gen=gen)

    def forward_block(self, x, cfg, cache):
        return x + self._apply(self.mixer, cm.rmsnorm(self.ln, x, cfg.norm_eps),
                               cfg, cache), None


class MLABlock(nn.Module):
    """``mla_dense`` (ffn: SwiGLU of width d_ff_dense) or ``mla_moe`` (ffn:
    the GShard MoE), as the JAX ``_mla_spec_factory``."""

    def __init__(self, cfg, kind: str, *, dtype, device, gen=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _norm(d, dtype, device)
        self.attn = attn.MLAttention(cfg, dtype=dtype, device=device, gen=gen)
        self.ln2 = _norm(d, dtype, device)
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
        return x + mlpm.swiglu_apply(self.ffn, h_in, cfg, cm.products_of(cache)), None


def _block(cfg, kind, **kw) -> nn.Module:
    if kind in ("dense", "gqa_moe"):
        return DenseBlock(cfg, kind, **kw)
    if kind in RECURRENT_KINDS:
        return RecurrentBlock(cfg, kind, **kw)
    return MLABlock(cfg, kind, **kw)


def execution_plan(cfg) -> List[Tuple[str, object]]:
    """The JAX ``execution_plan``: [("seg", (seg_idx, kind, count)) |
    ("shared", app_idx)]: runs of equal block kinds, each run ended by a
    shared-block application."""
    plan, seg_idx, app_idx, i = [], 0, 0, 0
    pattern = cfg.block_pattern
    while i < len(pattern):
        j = i
        while j < len(pattern) and pattern[j] == pattern[i]:
            j += 1
            if _shared_after(cfg, j - 1):
                break
        plan.append(("seg", (seg_idx, pattern[i], j - i)))
        seg_idx += 1
        if _shared_after(cfg, j - 1):
            plan.append(("shared", app_idx))
            app_idx += 1
        i = j
    return plan


def _shared_after(cfg, layer: int) -> bool:
    return cfg.shared_block is not None and (layer + 1) % cfg.shared_period == 0


def num_shared_apps(cfg) -> int:
    if cfg.shared_block is None:
        return 0
    return sum(1 for i in range(cfg.num_layers) if _shared_after(cfg, i))


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
        self.shared = (_block(cfg, cfg.shared_block, dtype=dtype, device=device, gen=gen)
                       if cfg.shared_block is not None else None)
        self.final_norm = _norm(d, dtype, device)
        # tied: the logits come from ``embed``, and there is no lm_head leaf
        self.lm_head = (None if cfg.tie_embeddings
                        else leaf((V, d), head_dtype, 0.02))
        self.requires_grad_(trainable)


def _sharding(mesh, train: bool = False):
    """The leaf-slicing context of a rank's model (none without a mesh)."""
    return (shd.slicing_leaves(mesh, train) if mesh is not None
            else contextlib.nullcontext())


def init(cfg, seed: int = 0, device=None, dtype: Optional[torch.dtype] = None,
         mesh=None, train: bool = False) -> Transformer:
    """Random weights from a seeded ``torch.Generator`` on the target device
    (JAX spec scales: normal/sqrt(fan_in), embed 1.0, lm_head 0.02, norms 1).
    ``dtype``: None for serving storage, ``torch.float32`` for trainable
    master weights. ``mesh``: this rank's shard of the same weights, the
    serving cut or (``train``) the training one."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad(), _sharding(mesh, train):
        model = Transformer(cfg, device=dev, gen=gen, dtype=dtype)
    model.mesh = mesh
    return model


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
_GELU_MLP = ("w_in", "b_in", "w_out", "b_out")
_NORMS = ("ln1", "ln2", "kv_norm", "ln", "norm")
#: each recurrent mixer's leaves, in the JAX spec's order
_MIXER_LEAVES = {
    "mamba2": ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D", "norm",
               "out_proj"),
    "mlstm": ("up_proj", "conv_w", "conv_b", "wq", "wk", "wv", "w_if", "b_if",
              "norm", "down_proj"),
    "slstm": ("w", "b", "r", "norm") + tuple(f"ffn.{w}" for w in _SWIGLU),
}


def _moe_leaves(cfg) -> Tuple[str, ...]:
    out = ("ffn.router",) + tuple(f"ffn.{w}" for w in _SWIGLU)
    if cfg.moe.num_shared_experts:
        out += tuple(f"ffn.shared.{w}" for w in _SWIGLU)
    return out


def _block_leaves(cfg, kind: str) -> Tuple[str, ...]:
    """A block's parameter names, relative to the block module."""
    if kind in RECURRENT_KINDS:
        return ("ln",) + tuple(f"mixer.{w}" for w in _MIXER_LEAVES[kind])
    if kind in ("dense", "gqa_moe"):
        out = ("ln1", "ln2") + tuple(f"attn.{w}" for w in ("wq", "wk", "wv", "wo"))
        if cfg.qkv_bias:
            out += tuple(f"attn.{w}" for w in ("bq", "bk", "bv"))
        mlp = _SWIGLU if cfg.mlp_kind == "swiglu" else _GELU_MLP
        return out + (_moe_leaves(cfg) if kind == "gqa_moe"
                      else tuple(f"mlp.{w}" for w in mlp))
    out = (("ln1", "ln2")
           + tuple(f"attn.{w}" for w in ("wq", "wkv_a", "kv_norm", "wkv_b", "wo")))
    if kind == "mla_dense":
        return out + tuple(f"ffn.{w}" for w in _SWIGLU)
    return out + _moe_leaves(cfg)


def _jax_leaf_path(mod: str) -> str:
    """"attn.kv_norm" -> "attn/kv_norm/scale" (norms are {"scale": ...})."""
    path = mod.replace(".", "/")
    return path + "/scale" if mod.rsplit(".", 1)[-1] in _NORMS else path


def segments(cfg) -> List[Tuple[int, str, int, int]]:
    """The JAX ``execution_plan``'s segments: runs of equal block kinds
    (ended early by a shared-block application) as (segment index, kind,
    first layer, count)."""
    out, first = [], 0
    for item, payload in execution_plan(cfg):
        if item == "seg":
            seg_idx, kind, count = payload
            out.append((seg_idx, kind, first, count))
            first += count
    return out


def jax_layout(cfg) -> List[Tuple[str, str, Optional[int]]]:
    """(parameter name of the port's module, JAX flat path, index or None):
    layer i of segment k maps to ``seg{k}/...``, stacked at index i - first
    when the segment has more than one layer (a ``lax.scan`` segment); the
    shared block's leaves to ``shared/...``."""
    out = [("embed", "embed/table", None)]
    for k, kind, first, count in segments(cfg):
        leaves = _block_leaves(cfg, kind)
        for i in range(first, first + count):
            out += [(f"blocks.{i}.{mod}", f"seg{k}/{_jax_leaf_path(mod)}",
                     i - first if count > 1 else None) for mod in leaves]
    out += [("final_norm", "final_norm/scale", None)]
    if not cfg.tie_embeddings:
        out += [("lm_head", "lm_head/table", None)]
    if cfg.shared_block is not None:
        out += [(f"shared.{mod}", f"shared/{_jax_leaf_path(mod)}", None)
                for mod in _block_leaves(cfg, cfg.shared_block)]
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


def copy_into(named: Dict[str, torch.Tensor], arrays: Dict[str, np.ndarray],
              mesh=None, cuts: Optional[Dict[str, int]] = None,
              parts: Optional[Dict[str, tuple]] = None) -> None:
    """Copy host arrays into tensors of the same names and shapes, each cast
    to its tensor's dtype (floating arrays by way of float32, which also
    reads JAX's bfloat16); with a ``mesh``, each array's slice along its
    leaf's cut dim (``cuts``), part by part for a packed leaf (``parts``)."""
    cuts, parts = cuts or {}, parts or {}
    with torch.no_grad():
        for name, t in named.items():
            a = np.asarray(arrays[name], dtype=np.float32
                           if t.is_floating_point() else None)
            a = torch.from_numpy(a if a.flags.writeable else a.copy())
            if name in cuts:
                a = shd.take_slice(a, cuts[name], mesh, parts.get(name))
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(a.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(a)


def load_jax_params(cfg, flat: Dict[str, np.ndarray], device=None,
                    dtype: Optional[torch.dtype] = None, mesh=None) -> Transformer:
    """The weight bridge: JAX params flattened to "seg0/attn/wq"-style paths
    (a segment's leaves stacked over its layers when it has more than one) ->
    the port's modules, each leaf in its storage dtype (``dtype`` as in
    ``init``); with a ``mesh``, this rank's slice of each."""
    with torch.no_grad(), _sharding(mesh):
        model = Transformer(cfg, device=resolve_device(device), dtype=dtype)
    copy_into(dict(model.named_parameters()), from_jax_flat(cfg, flat), mesh,
              shd.leaf_cuts(model), shd.leaf_parts(model))
    model.mesh = mesh
    return model


def _pools(layer: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in layer.items() if k.endswith("_pool")}


class DenseCache:
    """The dense KV plane of the whole model: per-layer max_len buffers
    (K/V for GQA, compressed latent and rope key for MLA) or recurrent
    state (a layer without ``idx``: Mamba2 / mLSTM / sLSTM, float32), one
    row per slot, then the shared block's applications' K/V (Zamba2), and
    one (slots,) position vector ``idx`` shared by every attention layer
    (the JAX stacked cache's per-slot ``idx`` leaves). Updated in place."""

    def __init__(self, layers, idx: torch.Tensor):
        self.layers = layers
        self.idx = idx

    @property
    def positions(self) -> torch.Tensor:
        return self.idx

    def rows(self, lo: int, hi: int) -> "DenseCache":
        """Slots [lo, hi) as a view: writes through it land here."""
        idx = self.idx[lo:hi]
        return DenseCache([{k: (idx if k == "idx" else v[lo:hi])
                            for k, v in c.items()} for c in self.layers], idx)

    def copy_from(self, other: "DenseCache") -> None:
        """Copy another cache of the same row count into this one."""
        for dst, src in zip(self.layers, other.layers):
            for k, v in dst.items():
                if k != "idx":
                    v.copy_(src[k])
        self.idx.copy_(other.idx)

    def reset_state(self) -> None:
        """Every recurrent layer's state back to its initial value (m at
        -1e30, the rest zeros), in place: a request admitted to a slot
        starts from fresh state, never from the previous occupant's, as the
        JAX engine's fresh per-request cache. Attention buffers need no
        reset: positions past ``idx`` are masked."""
        for c in self.layers:
            if "idx" not in c:
                for k, v in c.items():
                    v.fill_(xlm.NEG if k == "m" else 0.0)

    def nbytes(self) -> int:
        """Resident bytes of every layer's buffers and states."""
        return sum(v.numel() * v.element_size()
                   for c in self.layers for k, v in c.items() if k != "idx")


class PagedCache:
    """The paged KV plane of the whole model: per-layer pools (K/V for GQA,
    compressed latent and rope key for MLA) and one (slots, max_blocks)
    block table and (slots,) length vector shared by every layer. Updated
    in place. ``products`` (``cm.Products``) are the products a forward
    through it runs, each layer's dict carrying them too."""

    def __init__(self, layers, tables: torch.Tensor, lens: torch.Tensor,
                 products: cm.Products = cm.LIBRARY):
        self.layers = layers
        self.tables = tables
        self.lens = lens
        self.products = products

    def view(self, tables: torch.Tensor, lens: torch.Tensor,
             products: cm.Products = cm.LIBRARY) -> "PagedCache":
        """The same pools seen through caller-supplied table rows and
        lengths (a prefill row), its forward running ``products``; replaces
        paged_pool_view/_merge."""
        return PagedCache([{**_pools(c), "tables": tables, "lens": lens,
                            "products": products} for c in self.layers],
                          tables, lens, products)

    @property
    def positions(self) -> torch.Tensor:
        return self.lens

    def pool_bytes(self) -> int:
        """Resident bytes of every layer's pools."""
        return sum(t.numel() * t.element_size()
                   for c in self.layers for t in _pools(c).values())


#: per-layer paged cache of each attention block kind
PAGED_CACHE_FNS = {
    "dense": attn.gqa_init_paged_cache,
    "gqa_moe": attn.gqa_init_paged_cache,
    "mla_dense": attn.mla_init_paged_cache,
    "mla_moe": attn.mla_init_paged_cache,
}


def init_paged_cache(cfg, slots: int, num_blocks: int, block_len: int,
                     max_blocks: int, dtype=torch.float32, device=None,
                     kv_heads: Optional[int] = None) -> PagedCache:
    """Paged decode cache for kv_impl="paged" (block 0 is scratch);
    attention-only archs (the engine refuses the others first). GQA pools
    hold ``kv_heads`` heads (a rank's share; default all, padded); MLA's
    latent pools are whole on every rank."""
    _check_cfg(cfg)
    if not attention_only(cfg) or cfg.shared_block:
        raise ValueError("paged KV requires an attention-cache-only arch "
                         "without a shared block")
    dev = resolve_device(device)
    tables = torch.zeros((slots, max_blocks), dtype=torch.int32, device=dev)
    lens = torch.zeros((slots,), dtype=torch.int32, device=dev)
    layers = [PAGED_CACHE_FNS[kind](cfg, slots, num_blocks, block_len,
                                    max_blocks, dtype, device=dev,
                                    tables=tables, lens=lens,
                                    **_kv_kw(kind, kv_heads))
              for kind in cfg.block_pattern]
    return PagedCache(layers, tables, lens)


def _kv_kw(kind: str, kv_heads: Optional[int]) -> dict:
    return {"kv_heads": kv_heads} if kv_heads and kind in ("dense", "gqa_moe") else {}


def _recurrent_cache(init):
    """A recurrent kind's cache: float32 state, whatever max_len and dtype
    (the JAX ``_mamba_cache`` / ``_mlstm_cache`` / ``_slstm_cache``), at a
    rank's width under a ``mesh``."""
    return lambda cfg, batch, max_len, dtype, *, device, idx, mesh=None: init(
        cfg, batch, device=device, mesh=mesh)


#: per-layer dense cache of each block kind (the third entry of the JAX
#: ``BLOCKS``)
CACHE_FNS = {
    "dense": attn.gqa_init_cache,
    "gqa_moe": attn.gqa_init_cache,
    "mla_dense": attn.mla_init_cache,
    "mla_moe": attn.mla_init_cache,
    "mamba2": _recurrent_cache(ssmm.mamba2_init_cache),
    "mlstm": _recurrent_cache(xlm.mlstm_init_cache),
    "slstm": _recurrent_cache(xlm.slstm_init_cache),
}


def init_cache(cfg, batch: int, max_len: int, dtype=torch.float32,
               device=None, kv_heads: Optional[int] = None,
               mesh=None) -> DenseCache:
    """Dense decode cache for kv_impl="dense": every layer's buffers for
    ``batch`` rows of ``max_len`` positions (or its recurrent state), then
    one GQA cache per shared-block application; zeros (m at -1e30),
    positions 0. GQA buffers hold ``kv_heads`` heads (as
    ``init_paged_cache``); under a ``mesh`` the recurrent states are a
    rank's (models/ssm.py, models/xlstm.py), and with ``cfg.kv_shard ==
    "seq_model"`` (``shd.seq_cut``) the attention buffers hold the rank's
    span of ``max_len / tp`` positions, with "seq_data" its data rank's span
    of ``max_len / dp`` (``shd.seq_axis``; a length the axis does not divide
    raises: ``shd.resolve_kv_shard`` turns the knob off there first)."""
    _check_cfg(cfg)
    dev = resolve_device(device)
    axis = shd.seq_axis(cfg, mesh)
    if axis is not None:
        n = mesh.tp if axis == "model" else mesh.dp
        if max_len % n:
            raise ValueError(f"kv_shard={cfg.kv_shard!r} cuts {max_len} positions over "
                             f"the {axis} axis, of {n} ranks: {n} does not divide them")
        max_len //= n
    idx = torch.zeros((batch,), dtype=torch.int32, device=dev)
    kinds = list(cfg.block_pattern) + [cfg.shared_block] * num_shared_apps(cfg)
    return DenseCache([CACHE_FNS[kind](cfg, batch, max_len, dtype, device=dev,
                                       idx=idx, **_kv_kw(kind, kv_heads),
                                       **({"mesh": mesh} if kind in RECURRENT_KINDS
                                          else {}))
                       for kind in kinds], idx)


def override_cache_length(cache, length) -> None:
    """Pin every row's position (``idx`` dense, ``lens`` paged) to
    ``length``, in place: a bucketed prefill advanced it past the prompt's
    true length."""
    cache.positions.fill_(int(length))


def stack_caches(caches: List[DenseCache]) -> DenseCache:
    """Per-request dense caches -> one cache with a row per request."""
    idx = torch.cat([c.idx for c in caches])
    layers = [{k: (idx if k == "idx" else torch.cat([c.layers[i][k] for c in caches]))
               for k in layer}
              for i, layer in enumerate(caches[0].layers)]
    return DenseCache(layers, idx)


def insert_slot(stacked: DenseCache, cache: DenseCache, slot: int) -> DenseCache:
    """Copy a one-row cache into row ``slot`` of ``stacked``, in place
    (leaf dtypes follow ``stacked``); returns ``stacked``."""
    take_slot(stacked, slot).copy_from(cache)
    return stacked


def take_slot(stacked: DenseCache, slot: int) -> DenseCache:
    """Row ``slot`` of a dense cache as a one-row view (not a copy, unlike
    the JAX ``take_slot``: writes through it land in ``stacked``)."""
    return stacked.rows(slot, slot + 1)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of the matrix products without
    batch dims, recompute everything else (``bmm``, the attention products
    with batch dims, included)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, cfg):
    """A block's ``forward_block`` under ``cfg.remat`` (the JAX
    ``_remat_wrap``). The recompute runs in the backward pass, outside
    ``apply``'s mesh context: it enters the mesh again, so a rank's
    recompute runs the same collectives as its forward."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    mesh = shd.active_serving_mesh()

    def run(x, cfg, cache):
        with shd.serving_mesh(mesh):
            return fn(x, cfg, cache)

    return lambda x, cfg, cache: ckpt.checkpoint(run, x, cfg, cache,
                                                 use_reentrant=False, **kw)


def apply(params: Transformer, batch: Dict[str, torch.Tensor], cfg=None,
          cache=None, gather_logits: bool = True):
    """batch {"tokens": (B,S) int} or, under ``cfg.input_mode="embeds"``,
    {"embeds": (B,S,d)}. Returns (logits f32, aux, cache): aux is the MoE
    layers' load-balancing losses summed (a float32 scalar tensor), 0.0 for
    a model without MoE layers.

    With a cache (PagedCache or DenseCache), positions start at each row's
    ``cache.positions`` (``lens`` / ``idx``) and advance by S, in place,
    after the last layer. A rank's shard (``params.mesh``) runs its slice
    and reduces over the model axis; ``gather_logits=False`` returns its
    vocabulary slice of the logits when the head is cut."""
    with shd.serving_mesh(getattr(params, "mesh", None)):
        return _apply(params, batch, params.cfg if cfg is None else cfg,
                      cache, gather_logits)


def _embed(params, tokens):
    """The embedding of ``tokens``; a vocabulary-cut table (the training
    cut) looks up the rank's rows, zeros elsewhere, summed over the model
    axis (exact: one rank holds each row)."""
    table = params.embed
    if not shd.is_cut(params, "embed"):
        return cm.embed(table, tokens)
    n = table.shape[0]
    local = tokens - shd.active_serving_mesh().model_rank * n
    hit = (local >= 0) & (local < n)
    rows = cm.embed(table, local.clamp(0, n - 1))
    return shd.row_sum(torch.where(hit[..., None], rows, torch.zeros_like(rows)))


def _apply(params, batch, cfg, cache, gather_logits):
    x = (_embed(params, batch["tokens"]) if cfg.input_mode == "tokens"
         else batch["embeds"])
    x = x.to(cm.dtype_of(cfg.dtype))
    S = x.shape[1]
    aux_total = 0.0
    n_layers, app = len(params.blocks), 0
    remat = cache is None and torch.is_grad_enabled()
    for i, blk in enumerate(params.blocks):
        c = cache.layers[i] if cache is not None else None
        fwd = _remat_wrap(blk.forward_block, cfg) if remat else blk.forward_block
        x, aux = fwd(x, cfg, c)
        if aux is not None:
            aux_total = aux_total + aux
        if _shared_after(cfg, i):
            c = cache.layers[n_layers + app] if cache is not None else None
            x, _ = params.shared.forward_block(x, cfg, c)
            app += 1
    if cache is not None:
        cache.positions.add_(S)
    x = cm.rmsnorm(params.final_norm, x, cfg.norm_eps)
    head = params.embed if cfg.tie_embeddings else params.lm_head
    if head.shape[0] < cfg.vocab_size:       # vocabulary-parallel logits
        x = shd.to_ranks(x)
    logits = getattr(cache, "products", cm.LIBRARY).unembed(head, x)
    if gather_logits and logits.shape[-1] < cfg.vocab_size:
        logits = shd.gather_vocab(logits, cfg.vocab_size)
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
                                impl=getattr(cfg, "loss_impl", "exact"),
                                mesh=getattr(params, "mesh", None))
    return loss + aux, {"loss": loss, "aux": aux, "ppl_proxy": loss}
