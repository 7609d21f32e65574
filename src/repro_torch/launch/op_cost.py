"""Per-op cost accounting of a step (the counterpart of
``repro/launch/hlo_cost.py`` and ``hlo_analysis.py``).

The JAX package counts a compiled HLO module's ops with loop-trip
multipliers. The port runs eagerly, op by op, so it counts the ops as they
are dispatched: ``OpCost`` is a ``TorchDispatchMode`` that sees every aten
op a step runs (on real or meta tensors alike) and applies hlo_cost.py's
rules to it:

    flops       products: 2 * prod(output) * prod(contracted dims)
                (mm, bmm, addmm, baddbmm, and matmul and einsum, which
                reach the dispatcher whole under inference mode),
                plus 1 per output element for elementwise arithmetic and
                1 per input element for a reduction;
    hbm bytes   operands + outputs of every op that is not a view. PyTorch
                runs every op unfused, so this is hlo_cost's unfused count,
                with four refinements where an operand is only partly read
                or written: a gather (embedding, index, index_select) moves
                its output and indices, a scatter or in-place copy its
                values and indices, a fill its output;
    collectives from the mesh's ``stats`` (distributed/sharding.py books
                each collective's kind and bytes there), weighted by
                ``COLL_FACTOR`` (an all-reduce moves 2x its buffer).

A loop whose steps do the same work is run once on meta tensors and each
of its ops counted for every step (``kernels/cost.repeated``; the sLSTM's
time loop).

A kernel entered through ctypes never reaches the dispatcher: each wrapper
in ``kernels/*.py`` books one op with its function's own work
(``kernels/cost.py``: bytes in and out, and the INT32 and FP32 operations
of ``pipeline_ops`` and ``dequant_flops``), whatever route runs, and the
ops of its plain version are not counted beside it.

``roofline_terms`` sets the counts against the card's peaks
(``kernels/cost.PEAKS``, the H100 SXM data sheet): products at dense BF16
tensor-core FLOP/s, the rest of the float work at FP32 FLOP/s, the
kernels' integer work at the INT32 rate, bytes at 3.35 TB/s, collective
bytes at NVLink's 450 GB/s a direction. These are seconds of a model
against those peaks, not measurements.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import cost as kcost

aten = torch.ops.aten

#: the port's collectives by their HLO kinds, and hlo_cost's weights
COLL_FACTOR = {"all-reduce": 2.0}

_PRODUCTS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
             aten.baddbmm.default}
_ELEMENTWISE = {
    "add", "sub", "mul", "div", "maximum", "minimum", "pow", "exp", "exp2",
    "tanh", "sigmoid", "log", "log1p", "rsqrt", "sqrt", "neg", "eq", "ne", "lt",
    "le", "gt", "ge", "where", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_left_shift", "bitwise_right_shift", "__lshift__", "__rshift__",
    "floor", "ceil", "abs", "round", "clamp", "clamp_min", "clamp_max",
    "expm1", "reciprocal", "sign", "logical_and", "logical_or", "logical_not",
    "remainder", "fmod", "floor_divide", "square", "erf", "softplus", "silu",
    "log_sigmoid_forward", "trunc", "fma", "lerp", "addcmul", "addcdiv",
    "isnan", "isinf", "masked_fill", "relu", "gelu", "frexp", "ldexp",
}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "cumsum", "prod",
               "argmax", "argmin", "any", "all", "logsumexp", "_softmax",
               "_log_softmax", "softmax", "log_softmax", "norm", "var", "std",
               "topk", "sort"}
#: ops that move no data: views and metadata
_VIEWS = {
    "view", "_unsafe_view", "reshape", "expand", "slice", "select", "t",
    "transpose", "permute", "unsqueeze", "squeeze", "as_strided", "detach",
    "alias", "unflatten", "flatten", "narrow", "split", "split_with_sizes",
    "chunk", "unbind", "view_as", "expand_as", "diagonal", "lift_fresh",
    "_reshape_alias", "unfold", "movedim", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense",
    "sym_size", "sym_stride", "sym_numel", "is_same_size", "resize_",
    "set_", "conj", "_conj", "resolve_conj", "resolve_neg", "_to_copy_meta",
}
#: reads only its indexed rows: the output and the indices move
_GATHERS = {"embedding", "index", "index_select", "gather", "take"}
#: writes values at indices: the values (read and written) and indices
_SCATTERS = {"index_put", "index_put_", "index_copy", "index_copy_", "scatter",
             "scatter_", "scatter_add", "scatter_add_", "index_add_",
             "index_add", "masked_scatter_", "_index_put_impl_"}
_FILLS = {"fill_", "zero_", "zeros", "zeros_like", "ones", "ones_like", "full",
          "full_like", "new_zeros", "new_ones", "new_full", "arange", "fill",
          "scalar_tensor", "randn", "rand", "normal_", "uniform_"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _base(func) -> str:
    return func.__name__.split(".")[0]


def _einsum_flops(equation: str, operands) -> float:
    """2 * (the product of every index's size) for each product of an
    einsum's operands, taken pairwise: its output elements times the
    contracted sizes."""
    lhs = equation.replace(" ", "").split("->")[0].split(",")
    sizes = {}
    for sub, t in zip(lhs, operands):
        for ch, n in zip(sub, t.shape):
            sizes[ch] = n
    total = 1
    for n in sizes.values():
        total *= n
    return 2.0 * total * max(1, len(operands) - 1)


class OpCost(TorchDispatchMode):
    """Counts the ops run inside it (module docstring). ``mesh``: the mesh
    whose ``stats`` delta gives the collectives. Read ``result()`` after
    the block."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.product_flops = 0.0
        self.other_flops = 0.0
        self.hbm_bytes = 0.0
        self.kernel_int_ops = 0.0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.ops: collections.Counter = collections.Counter()
        self.kernels: collections.Counter = collections.Counter()
        self._stats0: Dict[str, int] = {}

    # -- the dispatch hook ------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not kcost.MUTED[0]:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = _base(func)
        if name in _VIEWS:
            return
        outs = list(_tensors(out))
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        if name in ("to", "_to_copy") and outs and ins and outs[0] is ins[0]:
            return                                      # a no-op cast
        rep = kcost.REPEAT[0]
        self.ops[name] += rep
        out_b = sum(_nbytes(t) for t in outs)
        if func in _PRODUCTS or name in ("matmul", "linear"):
            add = func in (aten.addmm.default, aten.baddbmm.default)
            k = (args[1] if add else args[0]).shape[-1]
            self.product_flops += rep * 2.0 * outs[0].numel() * k
            if add:
                self.other_flops += rep * outs[0].numel()
        elif name == "einsum":
            self.product_flops += rep * _einsum_flops(args[0], args[1])
        elif name in _ELEMENTWISE or name.rstrip("_") in _ELEMENTWISE:
            self.other_flops += rep * sum(t.numel() for t in outs)
        elif name in _REDUCTIONS:
            self.other_flops += rep * sum(t.numel() for t in ins[:1])
        if name in _GATHERS:
            idx = sum(_nbytes(t) for t in ins[1:] if not t.is_floating_point())
            nbytes = 2 * out_b + idx
        elif name in _SCATTERS:
            nbytes = 2 * _nbytes(ins[-1]) + sum(_nbytes(t) for t in ins[1:-1])
        elif name == "copy_":
            nbytes = 2 * _nbytes(args[1])
        elif name in _FILLS:
            nbytes = out_b
        else:
            nbytes = out_b + sum(_nbytes(t) for t in ins)
        self.hbm_bytes += rep * nbytes

    # -- the kernels' bookings (kernels/cost.py) ----------------------------
    def book_kernel(self, name: str, nbytes: float, int_ops: float,
                    flops: float) -> None:
        rep = kcost.REPEAT[0]
        self.kernels[name] += rep
        self.kernel_bytes += rep * nbytes
        self.kernel_int_ops += rep * int_ops
        self.kernel_flops += rep * flops

    # -- enter / exit -------------------------------------------------------
    def __enter__(self):
        if self.mesh is not None:
            self._stats0 = dict(self.mesh.stats)
        kcost.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kcost.COUNTERS.remove(self)
        if self.mesh is not None:
            self._stats1 = dict(self.mesh.stats)
        return super().__exit__(*exc)

    # -- the record -----------------------------------------------------------
    def collectives(self) -> dict:
        """hlo_cost's collective keys from the mesh's stats delta: the
        port's collectives are all-reduces (a gather of vocabulary or head
        slices is an all-reduce of a zero-filled buffer) and the ZeRO-1
        step's all-gathers of the parameters over the data axes."""
        if self.mesh is None:
            return {"per_kind_bytes": {}, "op_counts": {}, "weighted_bytes": 0.0,
                    "data_op_counts": {}}
        s0, s1 = self._stats0, getattr(self, "_stats1", dict(self.mesh.stats))
        per_kind, counts = {}, {}
        for kind, key, nkey in (("all-reduce", "all_reduce", "bytes"),
                                ("all-gather", "all_gather", "all_gather_bytes")):
            n = s1.get(key, 0) - s0.get(key, 0)
            if n:
                counts[kind] = float(n)
                per_kind[kind] = float(s1.get(nkey, 0) - s0.get(nkey, 0))
        weighted = sum(COLL_FACTOR.get(k, 1.0) * v for k, v in per_kind.items())
        data = {kind: float(s1.get(f"data_{key}", 0) - s0.get(f"data_{key}", 0))
                for kind, key in (("all-reduce", "all_reduce"), ("all-gather", "all_gather"))}
        return {"per_kind_bytes": per_kind, "op_counts": counts,
                "weighted_bytes": weighted,
                "data_op_counts": {k: v for k, v in data.items() if v}}

    def result(self) -> dict:
        coll = self.collectives()
        return {
            "flops": self.product_flops + self.other_flops + self.kernel_flops,
            "product_flops": self.product_flops,
            "other_flops": self.other_flops + self.kernel_flops,
            "kernel_int_ops": self.kernel_int_ops,
            "hbm_bytes": self.hbm_bytes + self.kernel_bytes,
            "kernel_bytes": self.kernel_bytes,
            "kernel_calls": dict(self.kernels),
            "aten_ops": sum(self.ops.values()),
            "collective_bytes_by_kind": coll["per_kind_bytes"],
            "collective_op_counts": coll["op_counts"],
            "collective_weighted_bytes": coll["weighted_bytes"],
            "collective_data_op_counts": coll["data_op_counts"],
        }


def roofline_terms(counts: dict, peaks: Optional[dict] = None) -> Dict[str, float]:
    """The three roofline terms of ``OpCost.result()`` against the card's
    peaks (``kernels/cost.PEAKS`` by default): compute is the largest of
    the products at BF16, the other float work at FP32 and the kernels'
    integer work at the INT32 rate (separate units, which may overlap: the
    least time); memory is bytes over HBM; collective the weighted bytes
    over NVLink. ``bound_s`` is the largest, ``dominant`` its name."""
    p = kcost.PEAKS if peaks is None else peaks
    compute = max(counts["product_flops"] / p["bf16_flop_s"],
                  counts["other_flops"] / p["fp32_flop_s"],
                  counts["kernel_int_ops"] / p["int32_op_s"])
    memory = counts["hbm_bytes"] / p["hbm_bytes_s"]
    collective = counts["collective_weighted_bytes"] / p["nvlink_bytes_s"]
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective}
    dom = max(terms, key=terms.get)
    bound = max(compute, memory, collective)
    terms["dominant"] = dom
    terms["bound_s"] = bound
    terms["roofline_fraction"] = compute / bound if bound > 0 else 0.0
    terms["peaks"] = p["name"]
    return terms


def count(fn, *args, mesh=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under an ``OpCost``; returns (its output,
    the counts)."""
    with OpCost(mesh) as oc:
        out = fn(*args, **kwargs)
    return out, oc.result()
