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

The recurrent mixers are cut by head (``mixer_layout``). Their leaves
pack several tensors along the dim the rules cut: Mamba2's ``in_proj``
columns are [z | x | B | C | dt] and its ``conv_w`` / ``conv_b`` [x | B |
C], the mLSTM's ``up_proj`` [xm | z], the sLSTM's ``w`` / ``b`` the four
gates [i | f | z | o]. GSPMD cuts such a leaf contiguously and reshards
behind the program's back; the port has no partitioner, so a packed leaf
is cut part by part (``take_slice`` with parts): each per-head part (z, x,
dt, a gate, xm) into the rank's heads, Mamba2's B and C by group where the
groups divide tp and whole otherwise (Zamba2 has one group, so every rank
holds the whole B / C columns: 2 * G * N of the in_proj and conv columns,
beyond the 1/tp the JAX rules give). The rows the rules cut (``out_proj``,
``down_proj``, the mLSTM's ``wq/wk/wv/w_if``) are contiguous slices that
line up with the rank's heads. ``dt_bias``, ``A_log``, ``D``, the norms
and the sLSTM's block-diagonal ``r`` stay whole, as the rules leave them,
and a rank reads its heads' entries. A mixer whose heads do not divide tp
keeps every leaf whole and runs whole on every rank (as ``spec_for_axes``
falls back for the attention archs). What a cut mixer computes is in
models/ssm.py and models/xlstm.py: the gated RMSNorms over d_inner reduce
their sums of squares, the row-parallel products are summed once, and the
sLSTM gathers its hidden state (``gather_heads``) after its time loop.

``cfg.kv_shard="seq_model"`` cuts the dense KV caches by position over
the model axis instead of by KV head (``seq_cut``; ``resolve_kv_shard``
keeps the heads cut where the axis does not divide the length, and on the
paged plane); the parameters keep their cut, and the attention step
gathers the queries over the heads and reduces its softmax and P.V over
the ranks (models/attention.py). Under the heads cut a batch the data
axes do not divide (long_500k's one row) is whole on every data rank, and
its dense caches' positions are cut over the data axes instead, the JAX
default ``cache_spec``: ``resolve_kv_shard`` turns "auto" into
"seq_data" for such a batch, and the attention step reduces its softmax
and P.V over the data group, each rank keeping its own heads
(``seq_axis``).

Collectives run on the process group's model axis (``Mesh.group``), and
the train step's on its data axis (``Mesh.data_group``). The gloo backend
takes CUDA tensors for ``all_reduce`` only through its own copies; the
port stages them through host memory itself (``Mesh.staged``), and counts
what it moved (``Mesh.stats``). A vocabulary gather is an ``all_reduce``
of a zero-filled full-width buffer, exact since x + 0 = x, so one
collective serves every backend. On a dry mesh (``Mesh.dry``:
``make_production_mesh``, or a rank's view without a group) the
collectives do not communicate: they book their kind and bytes in
``Mesh.stats`` and return a tensor of the right shape, which is what the
dry run (launch/dryrun.py) counts.

Training (train/step.py) takes the training cut (``TRAIN_REPLICATED``:
the embedding vocabulary-cut, as the JAX ``params_shardings``) and the
collectives' backward (``row_sum``, ``to_ranks``, ``shared_sum``,
``data_sum``, the gathers); the whole leaves a rank reads only in part
(``partial_leaves``) get partial gradients, summed over the model axis
once; ZeRO-1 cuts the moments over the data axes (``zero1_slices``).
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
#: the training cut's: the JAX train state takes ``params_shardings``, so
#: the embedding is vocabulary-cut there (and a tied head with it); the
#: router stays whole
TRAIN_REPLICATED = {("MoE", "router")}


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


#: a packed leaf's parts along its cut dim: ((width, units), ...), each part
#: cut into tp equal pieces when its units (heads or groups) divide tp,
#: else kept whole on every rank
Parts = Tuple[Tuple[int, int], ...]


def mixer_layout(mod_class: str, cfg) -> Optional[Tuple[int, Dict[str, Tuple[int, Parts]]]]:
    """(heads, {leaf: (cut dim, parts)}) of a recurrent mixer, whose cut
    follows its heads (module docstring); None for any other module."""
    if cfg is None:
        return None
    if mod_class == "Mamba2":
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        H = d_inner // s.head_dim
        x, bc = (d_inner, H), (s.n_groups * s.d_state, s.n_groups)
        return H, {"in_proj": (1, (x, x, bc, bc, (H, H))),
                   "conv_w": (1, (x, bc, bc)), "conv_b": (0, (x, bc, bc))}
    if mod_class == "MLSTM":
        d_inner, H = int(cfg.d_model * cfg.xlstm.proj_factor), cfg.num_heads
        return H, {"up_proj": (1, ((d_inner, H), (d_inner, H)))}
    if mod_class == "SLSTM":
        d, H = cfg.d_model, cfg.num_heads
        return H, {"w": (1, ((d, H),) * 4), "b": (0, ((d, H),) * 4)}
    return None


def mixer_is_cut(heads: int, mesh) -> bool:
    """A recurrent mixer is cut when its heads divide tp; else every leaf
    of it stays whole and it runs whole on every rank."""
    return mesh is not None and mesh.tp > 1 and heads % mesh.tp == 0


def leaf_cut(mod_class: str, leaf: str, shape, mesh, cfg=None,
             replicated=SERVE_REPLICATED) -> Optional[Tuple[int, Optional[Parts]]]:
    """(dim, parts) the cut splits over the model axis for one leaf (parts
    None: one contiguous slice), or None when the rank keeps it whole.
    ``cfg``: the module's config, which a recurrent mixer's cut reads;
    ``replicated``: the leaves kept whole whatever the rules say (the
    serving cut's by default, ``TRAIN_REPLICATED`` for training)."""
    if (mod_class, leaf) in replicated:
        return None
    layout = mixer_layout(mod_class, cfg)
    if layout is not None:
        heads, packed = layout
        if not mixer_is_cut(heads, mesh):
            return None
        if leaf in packed:
            return packed[leaf]
    dim = _cut_dim(spec_for_axes(LEAF_AXES[(mod_class, leaf)], tuple(shape), mesh))
    return None if dim is None else (dim, None)


def take_slice(t: torch.Tensor, dim: Optional[int], mesh,
               parts: Optional[Parts] = None) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim`` (one contiguous slice, or
    with ``parts`` its piece of each part, concatenated), or ``t`` itself
    for a whole leaf. The slice is a copy even where the narrowed view is
    contiguous (a cut of dim 0), so the whole leaf's storage can go."""
    if dim is None:
        return t
    if parts is None:
        parts = ((t.shape[dim], mesh.tp),)
    pieces, lo = [], 0
    for w, units in parts:
        if units % mesh.tp == 0:
            n = w // mesh.tp
            pieces.append(t.narrow(dim, lo + mesh.model_rank * n, n))
        else:
            pieces.append(t.narrow(dim, lo, w))
        lo += w
    if lo != t.shape[dim]:
        raise ValueError(f"parts {parts} do not cover dim {dim} of {tuple(t.shape)}")
    if len(pieces) == 1:
        return pieces[0].clone(memory_format=torch.contiguous_format)
    return torch.cat(pieces, dim=dim)


def head_range(heads: int, mesh=None) -> Tuple[int, int]:
    """[lo, hi) of the heads a cut mixer's rank holds (the ambient mesh by
    default)."""
    mesh = active_serving_mesh() if mesh is None else mesh
    n = heads // mesh.tp
    return mesh.model_rank * n, (mesh.model_rank + 1) * n


@contextlib.contextmanager
def slicing_leaves(mesh, train: bool = False):
    """Cut every parameter registered inside this block to this rank's
    slice as it is registered: a model built here (``tf.init`` with its
    seeded generator, which still draws each whole leaf, so the slices are
    the tp = 1 weights exactly) holds its shard plus, transiently, the
    largest leaf. Each module records the leaves cut in ``tp_cut`` {leaf:
    dim}, their whole shapes in ``tp_full`` and a packed leaf's parts in
    ``tp_parts`` {leaf: parts}. ``train``: the training cut
    (``TRAIN_REPLICATED``), else the serving one."""
    from torch.nn.modules import module as nn_module

    replicated = TRAIN_REPLICATED if train else SERVE_REPLICATED

    def hook(mod, name, param):
        if param is None:
            return None
        cut = leaf_cut(type(mod).__name__, name, param.shape, mesh,
                       getattr(mod, "cfg", None), replicated)
        if cut is None:
            return None
        dim, parts = cut
        mod.__dict__.setdefault("tp_cut", {})[name] = dim
        mod.__dict__.setdefault("tp_full", {})[name] = tuple(param.shape)
        if parts is not None:
            mod.__dict__.setdefault("tp_parts", {})[name] = parts
        return nn.Parameter(take_slice(param.data, dim, mesh, parts),
                            requires_grad=param.requires_grad)

    handle = nn_module.register_module_parameter_registration_hook(hook)
    try:
        yield
    finally:
        handle.remove()


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """A new model holding this rank's slice of every leaf of ``model``
    (the counterpart of ``serve_param_shardings``; ``model`` is untouched)."""
    from repro_torch.models import transformer as tf

    cfg = model.cfg
    with torch.no_grad(), slicing_leaves(mesh):
        out = tf.Transformer(cfg, device="meta", dtype=None)
    src = dict(model.named_parameters())
    with torch.no_grad():
        for mname, mod in out.named_modules():
            cut = mod.__dict__.get("tp_cut", {})
            parts = mod.__dict__.get("tp_parts", {})
            for leaf, p in list(mod.named_parameters(recurse=False)):
                full = src[f"{mname}.{leaf}" if mname else leaf]
                # a whole leaf shares the source's storage
                t = take_slice(full.detach(), cut.get(leaf), mesh, parts.get(leaf))
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


def leaf_parts(model: nn.Module) -> Dict[str, Parts]:
    """{parameter name: parts} of a rank's model's packed cut leaves."""
    return {(f"{m}.{leaf}" if m else leaf): parts
            for m, mod in model.named_modules()
            for leaf, parts in mod.__dict__.get("tp_parts", {}).items()}


#: (dim, lo, hi): a range of a rank's leaf along one dim
Range = Tuple[int, int, int]

#: the leaf whose cut marks a module as cut (its computation rank-local),
#: and the whole leaves of a cut module that a rank reads only in part
#: (the rank's heads or KV heads, its slice of a norm): their gradients on
#: a rank are partial sums
_CUT_BY = {"GQAttention": "wo", "MLAttention": "wo", "Mamba2": "out_proj",
           "MLSTM": "down_proj", "SLSTM": "w"}
_PARTIAL_WHOLE = {"GQAttention": ("wk", "wv", "bk", "bv"),
                  "MLAttention": ("wkv_a", "kv_norm"),
                  "Mamba2": ("dt_bias", "A_log", "D", "norm"),
                  "MLSTM": ("b_if", "norm"),
                  "SLSTM": ("r",)}


def _part_ranges(shape, dim: int, parts: Parts, tp: int):
    """([cut ranges], [whole ranges]) of a rank's packed leaf along its cut
    dim: each part cut into tp pieces when its units divide tp, else
    whole."""
    cut, whole, lo = [], [], 0
    for w, units in parts:
        n = w // tp if units % tp == 0 else w
        (cut if units % tp == 0 else whole).append((dim, lo, lo + n))
        lo += n
    if lo != shape[dim]:
        raise ValueError(f"parts {parts} do not cover dim {dim} of {tuple(shape)}")
    return cut, whole


def leaf_ranges(model: nn.Module) -> Dict[str, Tuple[list, list]]:
    """{parameter name: ([cut ranges], [whole ranges])} of a rank's leaves:
    the parts cut over the model axis and the parts every model rank
    holds whole (a whole leaf: one whole range over its dim 0; a cut leaf:
    one cut range; a packed leaf: its parts)."""
    out = {}
    for mname, mod in model.named_modules():
        cut = mod.__dict__.get("tp_cut", {})
        parts = mod.__dict__.get("tp_parts", {})
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{leaf}" if mname else leaf
            every = [(0, 0, p.shape[0])]
            if leaf not in cut:
                out[name] = ([], every)
            elif leaf in parts:
                out[name] = _part_ranges(p.shape, cut[leaf], parts[leaf],
                                         model.mesh.tp)
            else:
                out[name] = (every, [])
    return out


def partial_leaves(model: nn.Module, cfg=None) -> Dict[str, list]:
    """{parameter name: [ranges]} of a rank's gradients that are partial
    sums over the model axis: the whole leaves of a cut module that the
    rank reads in part (``_PARTIAL_WHOLE``; the sLSTM's ``r`` unless its
    state is replicated, when every rank runs every head) and the whole
    parts of a packed leaf (Mamba2's B / C columns when its groups do not
    divide tp). Every other whole leaf's gradient is alike on every rank.
    The train step sums these ranges over the model axis once."""
    cfg = model.cfg if cfg is None else cfg
    out = {}
    for mname, mod in model.named_modules():
        cls = type(mod).__name__
        cut = mod.__dict__.get("tp_cut", {})
        if cls not in _CUT_BY or _CUT_BY[cls] not in cut:
            continue
        pre = f"{mname}." if mname else ""
        leaves = _PARTIAL_WHOLE[cls]
        if cls == "SLSTM" and cfg.slstm_state == "replicated":
            leaves = ()
        for leaf in leaves:
            p = getattr(mod, leaf, None)
            if p is not None and leaf not in cut:
                out[pre + leaf] = [(0, 0, p.shape[0])]
        for leaf, parts in mod.__dict__.get("tp_parts", {}).items():
            whole = _part_ranges(getattr(mod, leaf).shape, cut[leaf], parts,
                                 model.mesh.tp)[1]
            if whole:
                out[pre + leaf] = whole
    return out


def full_leaf(t: torch.Tensor, mesh, dim: Optional[int],
              parts: Optional[Parts] = None) -> torch.Tensor:
    """The whole leaf of a rank's cut ``t`` (``dim`` None: ``t`` itself),
    gathered over the model axis and put together part by part, as
    ``take_slice`` cut it."""
    if dim is None or mesh.tp == 1:
        return t
    pieces = all_gather(t, mesh, "model")
    if parts is None:
        return torch.cat(pieces, dim=dim)
    out, lo = [], 0
    for w, units in parts:
        n = w // mesh.tp if units % mesh.tp == 0 else w
        if units % mesh.tp == 0:
            out += [p.narrow(dim, lo, n) for p in pieces]
        else:
            out.append(pieces[0].narrow(dim, lo, n))
        lo += n
    return torch.cat(out, dim=dim)


def full_tensors(model: nn.Module, named: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``named`` (tensors shaped as the rank's leaves: its params, their
    gradients or moments) as whole leaves, gathered over the model axis."""
    cuts, parts = leaf_cuts(model), leaf_parts(model)
    return {k: full_leaf(v, model.mesh, cuts.get(k), parts.get(k))
            for k, v in named.items()}


# ---------------------------------------------------------------------------
# ZeRO-1: the optimizer moments over the data axes (the JAX ``_zero1_extend``)
# ---------------------------------------------------------------------------
def zero1_spec(spec: Spec, shape, mesh) -> Spec:
    """``spec`` of a leaf of ``shape`` extended over the data axes on the
    first dim it leaves whole that they divide (unchanged when none does,
    or over one data rank): the JAX ``_zero1_extend``."""
    dp_axes, dpn = _dp_axes(mesh), dp_size(mesh)
    if not dp_axes or dpn == 1:
        return spec
    s = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, cur) in enumerate(zip(shape, s)):
        if cur is None and dim % dpn == 0 and dim >= dpn:
            s[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
            while s and s[-1] is None:
                s.pop()
            return tuple(s)
    return spec


def full_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """{parameter name: the whole leaf's shape} of a rank's model."""
    out = {}
    for mname, mod in model.named_modules():
        full = mod.__dict__.get("tp_full", {})
        for leaf, p in mod.named_parameters(recurse=False):
            out[f"{mname}.{leaf}" if mname else leaf] = full.get(leaf, tuple(p.shape))
    return out


def zero1_slices(model: nn.Module, mesh) -> Dict[str, Range]:
    """{parameter name: (dim, lo, hi)} of the slice of each leaf whose
    moments this data rank keeps and updates under ZeRO-1 (``zero1_spec``
    on the JAX param spec of the whole leaf); a leaf no data dim divides is
    absent (its moments whole on every data rank)."""
    if mesh is None or mesh.dp == 1:
        return {}
    axes, shapes = param_axes(model), full_shapes(model)
    out = {}
    for name, shape in shapes.items():
        spec = spec_for_axes(axes[name], shape, mesh)
        z = zero1_spec(spec, shape, mesh)
        if z == spec:
            continue
        dim = next(i for i, (a, b) in enumerate(zip(
            list(z), list(spec) + [None] * len(z))) if a != b)
        n = shape[dim] // mesh.dp
        out[name] = (dim, mesh.data_rank * n, (mesh.data_rank + 1) * n)
    return out


def local_kv_heads(cfg, mesh) -> int:
    """KV heads of one rank's GQA pools and buffers: KH' / tp when it
    divides, else the whole KH' (padded); every KV head when the dense
    caches' positions are cut instead (``seq_cut``)."""
    from repro_torch.models.attention import padded_heads

    kh = padded_heads(cfg)[1]
    if seq_cut(cfg, mesh):
        return kh
    return kh // mesh.tp if mesh is not None and kh % mesh.tp == 0 else kh


# ---------------------------------------------------------------------------
# kv_shard: the dense caches' positions over the model or the data axes
# ---------------------------------------------------------------------------
#: the values of ``cfg.kv_shard``: "seq_data" is what ``resolve_kv_shard``
#: makes of "auto" for a batch the data axes do not divide
KV_SHARDS = ("auto", "seq_model", "seq_data")
#: the softmax datapaths whose split form keeps the whole row's sum order,
#: which needs every rank's span to be whole 32-lane windows
_WINDOWED = ("cordic_pallas", "cordic_fixed")


def seq_cut(cfg, mesh=None) -> bool:
    """Whether a dense KV cache on ``mesh`` (the ambient serving mesh by
    default) holds a span of the positions with every KV head, rank r the
    positions [r T / tp, (r + 1) T / tp) (the JAX ``kv_shard="seq_model"``
    cache spec), rather than the heads cut: ``cfg.kv_shard == "seq_model"``
    on more than one model rank. ``resolve_kv_shard`` has already turned
    the knob off where the axis does not divide the length."""
    return seq_axis(cfg, mesh) == "model"


def seq_axis(cfg, mesh=None) -> Optional[str]:
    """The mesh axis a dense KV cache's positions are cut over on ``mesh``
    (the ambient serving mesh by default): "model" under
    ``kv_shard="seq_model"`` on more than one model rank, "data" under
    "seq_data" on more than one data rank (each rank then holds the
    positions [d T / dp, (d + 1) T / dp) of its model rank's KV heads),
    else None (the heads cut)."""
    mesh = active_serving_mesh() if mesh is None else mesh
    kv = getattr(cfg, "kv_shard", "auto")
    if mesh is None:
        return None
    if kv == "seq_model" and mesh.tp > 1:
        return "model"
    if kv == "seq_data" and mesh.dp > 1:
        return "data"
    return None


def resolve_kv_shard(cfg, mesh, max_len: int, dense: bool = True,
                     batch: Optional[int] = None):
    """``cfg`` as the KV plane of ``max_len`` positions on ``mesh`` serves
    it. ``"seq_model"`` cuts the dense plane's positions where the model
    axis divides ``max_len`` (the JAX spec's ``S % model == 0``); elsewhere,
    and on the paged plane, which never reads the knob, the heads cut stays
    and the knob reads ``"auto"``. Under the heads cut a dense plane whose
    ``batch`` rows the data axes do not divide (``cache_spec``) cuts its
    positions over them where they divide ``max_len``: the knob then reads
    ``"seq_data"`` (without a ``batch``, or where it does not apply,
    "auto"). A CORDIC softmax (``cordic_pallas``, ``cordic_fixed``) whose
    span is not whole 32-lane windows is refused: its split row sum would
    leave the whole row's order. Raises ValueError on an unknown value."""
    import dataclasses

    kv = getattr(cfg, "kv_shard", "auto")
    if kv not in KV_SHARDS:
        raise ValueError(f"unknown kv_shard {kv!r}, not in {KV_SHARDS}")
    if kv == "seq_model" and mesh is not None and mesh.tp > 1:
        if not dense or max_len % mesh.tp:
            return dataclasses.replace(cfg, kv_shard="auto")
        span = max_len // mesh.tp
    elif kv == "seq_model":
        return cfg
    else:
        dp = mesh.dp if mesh is not None else 1
        if (batch is None or not dense or dp == 1 or max_len % dp
                or (batch % dp == 0 and batch >= dp)):
            return dataclasses.replace(cfg, kv_shard="auto") if kv != "auto" else cfg
        cfg, span = dataclasses.replace(cfg, kv_shard="seq_data"), max_len // dp
    if getattr(cfg, "softmax_impl", "exact") in _WINDOWED:
        from repro_torch.kernels.softmax_cordic import check_span

        check_span(span)
    return cfg


# ---------------------------------------------------------------------------
# Data-axis specs (the JAX ``batch_spec`` / ``cache_spec``)
# ---------------------------------------------------------------------------
def _dp_axes(mesh) -> Tuple[str, ...]:
    sizes = _mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def dp_size(mesh) -> int:
    """Ranks over the data axes ("pod" x "data")."""
    sizes = _mesh_shape(mesh)
    n = 1
    for a in _dp_axes(mesh):
        n *= sizes[a]
    return n


def batch_spec(mesh, global_batch: int, seq_len: int,
               extra_dims: int = 0) -> Spec:
    """The spec of (B, S, ...) activations and inputs: the batch over
    ("pod", "data") when it divides, else the sequence (long-context decode
    at batch 1), else whole: a mesh axis or a tuple of them per dim, as
    the JAX PartitionSpec's."""
    dp_axes = _dp_axes(mesh)
    dp = dp_size(mesh)
    # a one-axis group is its name, as a PartitionSpec normalises it
    ax = dp_axes[0] if len(dp_axes) == 1 else dp_axes
    if global_batch % dp == 0 and global_batch >= dp:
        return (ax,) + (None,) * (1 + extra_dims)
    if seq_len % dp == 0:
        return (None, ax) + (None,) * extra_dims
    return ()


def cache_spec(mesh, batch: int, seq_len: int, kv_heads: int) -> dict:
    """The axes of (B, S, KH, D) cache buffers: batch over the data axes
    when it divides, else the sequence; KV heads over the model axis when
    they divide."""
    dp_axes = _dp_axes(mesh)
    dp = dp_size(mesh)
    model = _mesh_shape(mesh).get("model", 1)
    kh = "model" if kv_heads % model == 0 else None
    if batch % dp == 0 and batch >= dp:
        return {"batch_axis": dp_axes, "seq_axis": None, "kv_axis": kh}
    return {"batch_axis": None, "seq_axis": dp_axes, "kv_axis": kh}


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------
def _book(mesh, kind: str, nbytes: int, axis: str = "model") -> None:
    """Count one collective of ``kind`` ("all_reduce" or "all_gather") and
    its buffer's bytes in ``mesh.stats`` (the all-reduce's bytes under
    "bytes", as ever); one over the data axes also under "data_<kind>" and
    "data_<kind>_bytes"."""
    mesh.stats[kind] += 1
    mesh.stats["bytes" if kind == "all_reduce" else f"{kind}_bytes"] += nbytes
    if axis == "data":
        mesh.stats[f"data_{kind}"] += 1
        mesh.stats[f"data_{kind}_bytes"] += nbytes


def _axis(mesh, axis: str):
    """(ranks, process group) of ``mesh``'s "model" or "data" axis."""
    if axis == "model":
        return mesh.tp, mesh.group
    return mesh.dp, mesh.data_group


def reduce_(t: torch.Tensor, mesh, axis: str = "model",
            op: str = "sum") -> torch.Tensor:
    """``t`` summed (``op="max"``: its maximum) over ``mesh``'s ``axis``,
    in place; booked and not run on a dry mesh, staged through host memory
    where the backend cannot take the tensor's device. Returns ``t``."""
    import torch.distributed as dist

    n, group = _axis(mesh, axis) if mesh is not None else (1, None)
    if n == 1:
        return t
    _book(mesh, "all_reduce", t.numel() * t.element_size(), axis)
    if mesh.dry:
        return t
    rop = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    if mesh.staged and t.device.type != "cpu":
        h = t.to("cpu")
        dist.all_reduce(h, op=rop, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=rop, group=group)
    return t


def all_reduce_(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum ``t`` over the model axis in place (the ambient mesh by
    default); through host memory when the backend cannot take the
    tensor's device (``Mesh.staged``). Returns ``t``. On a dry mesh
    (``make_production_mesh``, a rank's view without a group) it is booked,
    not communicated, and ``t`` keeps its shape."""
    mesh = active_serving_mesh() if mesh is None else mesh
    return reduce_(t, mesh, "model")


def all_gather(t: torch.Tensor, mesh, axis: str = "model") -> list:
    """Every rank's ``t`` (equal shapes) over ``mesh``'s ``axis``, in rank
    order; [t] over one rank, and ``t`` for every rank on a dry mesh."""
    import torch.distributed as dist

    n, group = _axis(mesh, axis)
    if n == 1:
        return [t]
    _book(mesh, "all_gather", n * t.numel() * t.element_size(), axis)
    if mesh.dry:
        return [t] * n
    staged = mesh.staged and t.device.type != "cpu"
    h = t.to("cpu") if staged else t.contiguous()
    out = [torch.empty_like(h) for _ in range(n)]
    dist.all_gather(out, h, group=group)
    return [o.to(t.device) for o in out] if staged else out


# -- the collectives under autograd -----------------------------------------
# Under grad a collective's backward follows what consumes its output (the
# Megatron f / g pair): a sum whose output feeds computation replicated on
# every rank passes its gradient through (each rank's gradient is already
# the whole one); a replicated value entering rank-local computation, or a
# sum whose output each rank reads in part, sums its gradient. Without grad
# (serving) each runs as before: ``all_reduce_`` in place, or nothing.
def _grad_mode(t: torch.Tensor, mesh) -> bool:
    return (mesh is not None and mesh.tp > 1 and torch.is_grad_enabled()
            and t.requires_grad)


class _Sum(torch.autograd.Function):
    """Sum over an axis; backward the identity (``grad_sum=False``) or the
    same sum (``grad_sum=True``)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, grad_sum):
        ctx.mesh, ctx.axis, ctx.grad_sum = mesh, axis, grad_sum
        return reduce_(t.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = reduce_(g.clone(), ctx.mesh, ctx.axis)
        return g, None, None, None


class _ToRanks(torch.autograd.Function):
    """Identity forward; the gradient summed over the axis."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return reduce_(g.clone(), ctx.mesh, ctx.axis), None, None


def row_sum(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """A row-parallel product's partial sum over the model axis, read whole
    and alike by every rank after it: backward the identity."""
    mesh = active_serving_mesh() if mesh is None else mesh
    if _grad_mode(t, mesh):
        return _Sum.apply(t, mesh, "model", False)
    return all_reduce_(t, mesh)


def shared_sum(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """A partial sum over the model axis that each rank reads only in part
    after it (a cut norm's sum of squares, the mLSTM's reduced q/k/v and
    gates): backward the same sum."""
    mesh = active_serving_mesh() if mesh is None else mesh
    if _grad_mode(t, mesh):
        return _Sum.apply(t, mesh, "model", True)
    return all_reduce_(t, mesh)


def to_ranks(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """A replicated activation entering rank-local (column-parallel)
    computation: the identity, with its gradient summed over the model
    axis under grad (the rank-local consumers each give a partial one)."""
    mesh = active_serving_mesh() if mesh is None else mesh
    if _grad_mode(t, mesh):
        return _ToRanks.apply(t, mesh, "model")
    return t


def data_sum(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """``t`` summed over the data axes into a new tensor, the gradient
    passed through: a reduction of the global batch (the loss's numerator
    and count, the MoE aux loss's token means) computed alike on every data
    rank, whose gradients the train step sums over the data axes."""
    mesh = active_serving_mesh() if mesh is None else mesh
    if mesh is None or mesh.dp == 1:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _Sum.apply(t, mesh, "data", False)
    return reduce_(t.clone(), mesh, "data")


class _Gather(torch.autograd.Function):
    """(..., parts * n) of this rank's slices -> (..., parts * n * tp):
    each part's slice at the rank's place of a zero-filled buffer, summed
    over the model axis; backward the rank's own slices of the gradient."""

    @staticmethod
    def forward(ctx, local, parts, mesh):
        ctx.parts, ctx.mesh = parts, mesh
        return _gather(local, parts, mesh)

    @staticmethod
    def backward(ctx, g):
        g = g.unflatten(-1, (ctx.parts, g.shape[-1] // ctx.parts))
        n, r = g.shape[-1] // ctx.mesh.tp, ctx.mesh.model_rank
        return g[..., r * n:(r + 1) * n].flatten(-2), None, None


def _gather(local: torch.Tensor, parts: int, mesh) -> torch.Tensor:
    local = local.unflatten(-1, (parts, local.shape[-1] // parts))
    n, r = local.shape[-1], mesh.model_rank
    full = local.new_zeros(local.shape[:-1] + (n * mesh.tp,))
    full[..., r * n:(r + 1) * n] = local
    return all_reduce_(full, mesh).flatten(-2)


def gather_vocab(local: torch.Tensor, vocab: int, mesh=None) -> torch.Tensor:
    """(..., V/tp) logits of this rank's vocabulary slice -> (..., V) on
    every rank: its slice written into a zero-filled full-width buffer,
    summed over the model axis (exact: every other entry adds 0). Under
    grad the backward is the rank's slice of the gradient."""
    mesh = active_serving_mesh() if mesh is None else mesh
    if local.shape[-1] * mesh.tp != vocab:
        raise ValueError(f"{local.shape[-1]} logits a rank at tp {mesh.tp} are not "
                         f"a vocabulary of {vocab}")
    return gather_heads(local, 1, mesh)


def gather_heads(local: torch.Tensor, parts: int = 1, mesh=None) -> torch.Tensor:
    """(..., parts * n) of this rank's heads -> (..., parts * n * tp) on
    every rank: each of the ``parts`` equal slices (the sLSTM's four gates,
    or one) placed at the rank's place in its part of a zero-filled buffer,
    summed over the model axis (exact, as ``gather_vocab``); under grad the
    backward is the rank's slices of the gradient."""
    mesh = active_serving_mesh() if mesh is None else mesh
    if _grad_mode(local, mesh):
        return _Gather.apply(local, parts, mesh)
    return _gather(local, parts, mesh)
