"""Logical-axis -> mesh-axis sharding rules (port of
``repro/distributed/sharding.py``), and the rank-local cut they make.

The JAX package annotates every parameter with logical axis names and lets
the GSPMD partitioner split one program over a ("data", "model") mesh. The
port runs one process per rank (``launch/mesh.py``): each rank holds the
slice of every weight that the rules give it and writes the collectives out
at the Megatron points. The rules are the JAX ones:

    RULES (ordered; first applicable wins, one mesh axis used at most once
    per tensor, divisibility checked: kv_heads=4 on a 16-way model axis
    falls back to replicated rather than failing):

        vocab    -> model        (logits vocab-parallel)
        mlp      -> model        (FFN tensor-parallel)
        heads    -> model        (attention head-parallel)
        kv_heads -> model        (when divisible)
        experts  -> model        (expert parallelism)
        embed    -> None         (d_model replicated across model axis)
        layers   -> None         (scan dim)

What a rank computes follows from what the rules cut (``shard_model``):

- a column-parallel cut (``wq/wk/wv`` and their biases, ``w_gate/w_up``,
  ``w_in/b_in``): the rank computes its heads or its FFN columns alone;
- a row-parallel cut (``wo``, ``w_down``, ``w_out``): the rank's product is
  a partial sum, followed by one ``all_reduce_`` of the activation
  (``b_out`` is added once, after it);
- experts over ranks (both MoEs): every rank routes with the whole router
  and runs its experts on the tokens dispatched to them; the combine is a
  partial sum, reduced once, the shared experts' partial sum with it;
- the untied ``lm_head`` over the vocabulary: local logits, then one
  gather of the vocabulary slices (``gather_vocab``).

A tensor the rules leave whole is computed whole on every rank: with a KV
head count that does not divide tp, ``wk/wv`` and the KV pools are whole,
and a rank attends with the KV heads its own query heads read. Two
serving carve-outs, as ``serve_param_shardings`` makes them: the embedding
is replicated (a lookup in a vocabulary-cut table would need a collective
inside the datapath), and with it a tied head. A third is the port's: the
MoE router is replicated (its (d, E) leaf would be cut on "experts"), so
every rank routes every token without a gather.

Collectives run on the process group's model axis (``Mesh.group``). The
gloo backend takes CUDA tensors for ``all_reduce`` only through its own
copies; the port stages them through host memory itself
(``Mesh.staged``), and counts what it moved (``Mesh.stats``). A vocabulary
gather is an ``all_reduce`` of a zero-filled full-width buffer, exact since
x + 0 = x, so one collective serves every backend.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

#: logical axis -> candidate mesh axis (None = replicate)
DEFAULT_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("vocab", "model"),
    ("mlp", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("experts", "model"),
    ("embed", None),
    ("layers", None),
)

Spec = Tuple[Optional[str], ...]


def _mesh_shape(mesh) -> Mapping[str, int]:
    return mesh.shape if hasattr(mesh, "shape") else mesh


def spec_for_axes(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                  mesh, rules=DEFAULT_RULES) -> Spec:
    """The PartitionSpec of one tensor, as a tuple of mesh axis names (None
    for a whole dim, trailing Nones dropped): divisibility enforced, each
    mesh axis used at most once. ``mesh``: a Mesh or a {axis: size}
    mapping."""
    sizes = _mesh_shape(mesh)
    rule_map = dict(rules)
    used = set()
    parts = []
    for dim, ax in zip(shape, axes):
        target = rule_map.get(ax) if ax is not None else None
        if (target is not None and target in sizes and target not in used
                and dim % sizes[target] == 0):
            parts.append(target)
            used.add(target)
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


# ---------------------------------------------------------------------------
# Logical axes of the port's leaves: (module class, leaf name) -> axes, the
# JAX specs' annotations (models/{attention,mlp,moe,ssm,xlstm,transformer})
# ---------------------------------------------------------------------------
_NORM = ("embed",)
LEAF_AXES: Dict[Tuple[str, str], Tuple[Optional[str], ...]] = {
    ("Transformer", "embed"): ("vocab", "embed"),
    ("Transformer", "lm_head"): ("vocab", "embed"),
    ("Transformer", "final_norm"): _NORM,
    ("DenseBlock", "ln1"): _NORM, ("DenseBlock", "ln2"): _NORM,
    ("MLABlock", "ln1"): _NORM, ("MLABlock", "ln2"): _NORM,
    ("RecurrentBlock", "ln"): _NORM,
    ("GQAttention", "wq"): ("embed", "heads", None),
    ("GQAttention", "wk"): ("embed", "kv_heads", None),
    ("GQAttention", "wv"): ("embed", "kv_heads", None),
    ("GQAttention", "wo"): ("heads", None, "embed"),
    ("GQAttention", "bq"): ("heads", None),
    ("GQAttention", "bk"): ("kv_heads", None),
    ("GQAttention", "bv"): ("kv_heads", None),
    ("MLAttention", "wq"): ("embed", "heads", None),
    ("MLAttention", "wkv_a"): ("embed", None),
    ("MLAttention", "kv_norm"): _NORM,
    ("MLAttention", "wkv_b"): (None, "heads", None),
    ("MLAttention", "wo"): ("heads", None, "embed"),
    ("SwiGLU", "w_gate"): ("embed", "mlp"),
    ("SwiGLU", "w_up"): ("embed", "mlp"),
    ("SwiGLU", "w_down"): ("mlp", "embed"),
    ("GeluMLP", "w_in"): ("embed", "mlp"),
    ("GeluMLP", "b_in"): ("mlp",),
    ("GeluMLP", "w_out"): ("mlp", "embed"),
    ("GeluMLP", "b_out"): ("embed",),
    ("MoE", "router"): ("embed", "experts"),
    ("MoE", "w_gate"): ("experts", "embed", "mlp"),
    ("MoE", "w_up"): ("experts", "embed", "mlp"),
    ("MoE", "w_down"): ("experts", "mlp", "embed"),
    ("Mamba2", "in_proj"): ("embed", "mlp"),
    ("Mamba2", "conv_w"): (None, "mlp"),
    ("Mamba2", "conv_b"): ("mlp",),
    ("Mamba2", "dt_bias"): (None,),
    ("Mamba2", "A_log"): (None,),
    ("Mamba2", "D"): (None,),
    ("Mamba2", "norm"): _NORM,
    ("Mamba2", "out_proj"): ("mlp", "embed"),
    ("MLSTM", "up_proj"): ("embed", "mlp"),
    ("MLSTM", "conv_w"): (None, "mlp"),
    ("MLSTM", "conv_b"): ("mlp",),
    ("MLSTM", "wq"): ("mlp", None),
    ("MLSTM", "wk"): ("mlp", None),
    ("MLSTM", "wv"): ("mlp", None),
    ("MLSTM", "w_if"): ("mlp", None),
    ("MLSTM", "b_if"): (None,),
    ("MLSTM", "norm"): _NORM,
    ("MLSTM", "down_proj"): ("mlp", "embed"),
    ("SLSTM", "w"): ("embed", "mlp"),
    ("SLSTM", "b"): ("mlp",),
    ("SLSTM", "r"): (None, None, None, None),
    ("SLSTM", "norm"): _NORM,
}

#: leaves the serving cut keeps whole whatever the rules say (module doc)
SERVE_REPLICATED = {("Transformer", "embed"), ("MoE", "router")}


def param_axes(model: nn.Module) -> Dict[str, Tuple[Optional[str], ...]]:
    """{parameter name: logical axes} of every leaf of a port model."""
    out = {}
    for mname, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            key = (type(mod).__name__, leaf)
            if key not in LEAF_AXES:
                raise KeyError(f"no logical axes for {key}")
            out[f"{mname}.{leaf}" if mname else leaf] = LEAF_AXES[key]
    return out


# ---------------------------------------------------------------------------
# Ambient serving mesh, as in the JAX package: the engine (and ``tf.apply``
# on a sharded model) enter ``serving_mesh`` and the model code reads
# ``active_serving_mesh()`` to place its collectives. Thread-local.
# ---------------------------------------------------------------------------
_SERVING_MESH = threading.local()


def active_serving_mesh():
    """The mesh entered by the innermost ``serving_mesh(...)``, or None."""
    return getattr(_SERVING_MESH, "mesh", None)


@contextlib.contextmanager
def serving_mesh(mesh):
    """Make ``mesh`` visible to the model code run inside this block."""
    prev = getattr(_SERVING_MESH, "mesh", None)
    _SERVING_MESH.mesh = mesh
    try:
        yield mesh
    finally:
        _SERVING_MESH.mesh = prev


# ---------------------------------------------------------------------------
# The rank's cut
# ---------------------------------------------------------------------------
def _cut_dim(spec: Spec) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def leaf_cut(mod_class: str, leaf: str, shape, mesh) -> Optional[int]:
    """The dim the serving cut splits over the model axis for one leaf, or
    None when the rank keeps it whole."""
    if (mod_class, leaf) in SERVE_REPLICATED:
        return None
    return _cut_dim(spec_for_axes(LEAF_AXES[(mod_class, leaf)], tuple(shape), mesh))


def take_slice(t: torch.Tensor, dim: Optional[int], mesh) -> torch.Tensor:
    """This rank's contiguous slice of ``t`` along ``dim``, or ``t`` itself
    for a whole leaf. The slice is a copy even where the narrowed view is
    contiguous (a cut of dim 0), so the whole leaf's storage can go."""
    if dim is None:
        return t
    n = t.shape[dim] // mesh.tp
    return t.narrow(dim, mesh.model_rank * n, n).clone(memory_format=torch.contiguous_format)


def check_servable(cfg) -> None:
    """Raises for an arch the port cannot cut yet: recurrent blocks
    (ROADMAP A.12b; the JAX rules cut their ``mlp`` axes)."""
    from repro_torch.models import transformer as tf

    if not tf.attention_only(cfg):
        raise NotImplementedError("tensor parallelism over recurrent blocks is "
                                  "not ported yet (ROADMAP A.12b)")


@contextlib.contextmanager
def slicing_leaves(mesh):
    """Cut every parameter registered inside this block to this rank's
    slice as it is registered: a model built here (``tf.init`` with its
    seeded generator, which still draws each whole leaf, so the slices are
    the tp = 1 weights exactly) holds its shard plus, transiently, the
    largest leaf. Each module records the leaves cut in ``tp_cut`` {leaf:
    dim}."""
    from torch.nn.modules import module as nn_module

    def hook(mod, name, param):
        if param is None:
            return None
        dim = leaf_cut(type(mod).__name__, name, param.shape, mesh)
        if dim is None:
            return None
        mod.__dict__.setdefault("tp_cut", {})[name] = dim
        return nn.Parameter(take_slice(param.data, dim, mesh),
                            requires_grad=param.requires_grad)

    handle = nn_module.register_module_parameter_registration_hook(hook)
    try:
        yield
    finally:
        handle.remove()


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """A new model holding this rank's slice of every leaf of ``model``
    (the counterpart of ``serve_param_shardings``; ``model`` is untouched).
    Raises for the recurrent archs (ROADMAP A.12b)."""
    from repro_torch.models import transformer as tf

    cfg = model.cfg
    check_servable(cfg)
    with torch.no_grad(), slicing_leaves(mesh):
        out = tf.Transformer(cfg, device="meta", dtype=None)
    src = dict(model.named_parameters())
    with torch.no_grad():
        for mname, mod in out.named_modules():
            cut = mod.__dict__.get("tp_cut", {})
            for leaf, p in list(mod.named_parameters(recurse=False)):
                full = src[f"{mname}.{leaf}" if mname else leaf]
                # a whole leaf shares the source's storage
                t = take_slice(full.detach(), cut.get(leaf), mesh)
                setattr(mod, leaf, nn.Parameter(t, requires_grad=False))
    out.mesh = mesh
    return out


def is_cut(mod: nn.Module, leaf: str) -> bool:
    return leaf in mod.__dict__.get("tp_cut", {})


def leaf_cuts(model: nn.Module) -> Dict[str, int]:
    """{parameter name: cut dim} of a rank's model's cut leaves."""
    return {(f"{m}.{leaf}" if m else leaf): dim
            for m, mod in model.named_modules()
            for leaf, dim in mod.__dict__.get("tp_cut", {}).items()}


def local_kv_heads(cfg, mesh) -> int:
    """KV heads of one rank's GQA pools: KH' / tp when it divides, else
    the whole KH' (padded)."""
    from repro_torch.models.attention import padded_heads

    kh = padded_heads(cfg)[1]
    return kh // mesh.tp if mesh is not None and kh % mesh.tp == 0 else kh


# ---------------------------------------------------------------------------
# Collectives on the model axis
# ---------------------------------------------------------------------------
def all_reduce_(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum ``t`` over the model axis in place (the ambient mesh by
    default); through host memory when the backend cannot take the
    tensor's device (``Mesh.staged``). Returns ``t``."""
    import torch.distributed as dist

    mesh = active_serving_mesh() if mesh is None else mesh
    if mesh is None or mesh.tp == 1:
        return t
    stats = mesh.stats
    stats["all_reduce"] += 1
    stats["bytes"] += t.numel() * t.element_size()
    if mesh.staged and t.device.type != "cpu":
        h = t.to("cpu")
        dist.all_reduce(h, group=mesh.group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=mesh.group)
    return t


def gather_vocab(local: torch.Tensor, vocab: int, mesh=None) -> torch.Tensor:
    """(..., V/tp) logits of this rank's vocabulary slice -> (..., V) on
    every rank: its slice written into a zero-filled full-width buffer,
    summed over the model axis (exact: every other entry adds 0)."""
    mesh = active_serving_mesh() if mesh is None else mesh
    n = local.shape[-1]
    full = local.new_zeros(local.shape[:-1] + (vocab,))
    full[..., mesh.model_rank * n:(mesh.model_rank + 1) * n] = local
    return all_reduce_(full, mesh)
