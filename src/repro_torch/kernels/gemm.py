"""Row-count-invariant matrix products: plain PyTorch version and two CUDA
kernels, a float32 chain (``csrc/gemm.cu``) and a bf16 tensor-core product
(``csrc/gemm_tc.cu``).

No TPU kernel of the JAX package corresponds: it leaves these products to
XLA. The port needs them on the card, where cuBLAS picks its kernel and its
split of the reduction by the problem's shape, so an element's bits follow
the launch's row count (ROADMAP F6, B.10). The paged prefill runs its
products through here (``models/common.py`` ``INVARIANT``): a position's
K, V and logits are then the same bits whatever row count, row width and
start its prefill dispatch had, which is what lets a prefix-cache hit read
the bytes its own prefill would have written.

Two routes, chosen by the operands' dtypes alone (``gemm_route``):

``"tc"``, both operands bf16 (the row projections, the MLPs, the logits of
a bf16 model): ``wgmma`` on Hopper's tensor cores, float32 accumulation,
one rounding to the output dtype. Every launch runs one instruction shape
and one CTA tile and walks K from 0 in fixed 64-wide slices, with no split
of K across CTAs, so an element's bits depend on K, its row and its column
alone (the kernel's header states the contract). No plain version can
replay a tensor core's sum order, so this route is held on the card by
invariance (every row bit-equal across row and batch counts) and by the
bound ``|c - c64| <= tc_gamma(K) * sum_k |a_k b_k|`` against a float64
product (``gemm_bound``).

``"simt"``, any float32 operand (the attention's scores and P.V under the
default float32 score dtype): one float32 chain over k = 0 .. K-1 in order
an element, ``acc = acc + a[m, k] * b[k, n]`` from 0, the product rounded
before the add (never fused), then one rounding to the output dtype. TF32
would drop 13 of a float32 operand's mantissa bits, so a float32 product
never reaches the tensor cores. ``gemm_plain`` replays the chain in K
vectorized steps, so it and the kernel agree bit for bit on the card.

``matmul`` and ``einsum`` lay torch's signatures over it (the products of
``_project``, ``_out_project``, the MLPs, ``_scores``, ``_pv``, MLA's
projections and decompression, ``unembed``): operands are permuted and
reshaped to (batch, M, K) and (batch, K, N) (a copy where the strides do not
allow a view), the result back to the caller's layout. The tensor-core
route also copies an operand whose strides TMA cannot describe
(``tma_ready``, ``tma_operand``).

On a CPU tensor every wrapper runs the plain version; on a CUDA tensor it
launches its route's kernel or raises; on a meta tensor it returns an empty
result of the right shape (the dry run).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cost

#: the card's SMs: the 128 x 128 tiling when the output tiles fill them
_SMS = 132


def _out_dtype(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype]) -> torch.dtype:
    return out_dtype if out_dtype is not None else torch.result_type(a, b)


def gemm_plain(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of ``gemm``: a (batch, M, K) x b (batch, K, N) ->
    (batch, M, N) in ``out_dtype`` (torch's promotion of the operands'
    dtypes by default), one float32 chain over k an element in order, each
    product rounded before its add (module docstring)."""
    nb, M, K = a.shape
    N = b.shape[-1]
    dtype = _out_dtype(a, b, out_dtype)
    af, bf = a.to(torch.float32), b.to(torch.float32)
    acc = torch.zeros((nb, M, N), dtype=torch.float32, device=a.device)
    prod = torch.empty_like(acc)
    for k in range(K):
        torch.mul(af[:, :, k:k + 1], bf[:, k:k + 1, :], out=prod)
        acc.add_(prod)
    return acc.to(dtype)


def wide_tiles(M: int, N: int, batch: int) -> bool:
    """The kernel's 128 x 128 tiling when its tiles fill the card's SMs, the
    32 x 64 one otherwise (the bits are the same either way)."""
    return batch * -(-M // 128) * -(-N // 128) >= _SMS


def gemm_route(a_dtype: torch.dtype, b_dtype: torch.dtype) -> str:
    """The kernel a ``gemm`` of these operand dtypes launches on the card:
    ``"tc"`` (csrc/gemm_tc.cu) for two bf16 operands, ``"simt"``
    (csrc/gemm.cu) when either is float32."""
    return "tc" if a_dtype == b_dtype == torch.bfloat16 else "simt"


def tma_ready(t: torch.Tensor, unit: int) -> bool:
    """Whether TMA can describe the bf16 operand ``t`` (batch, rows, cols)
    with dim ``unit`` (1 or 2) the unit-stride one: its base 16-byte
    aligned, its other dim's stride a multiple of 8 elements (16 bytes),
    its batch stride 0 (shared by the batch) or a multiple of 8, as
    ``_tma_strides`` gives them."""
    st = _tma_strides(t, unit)
    other = 3 - unit
    return (t.data_ptr() % 16 == 0 and st[unit] == 1 and st[other] > 0
            and st[other] % 8 == 0 and st[0] % 8 == 0)


def _tma_strides(t: torch.Tensor, unit: int):
    """t's element strides as the kernel takes them: a one-element dim is
    never stepped, so its stride is the contiguous layout's (the unit dim
    1, the other dim its row rounded up to 8 elements), and a batch of one
    reads batch 0 alone (stride 0)."""
    st = list(t.stride())
    other = 3 - unit
    if t.shape[unit] == 1:
        st[unit] = 1
    if t.shape[other] == 1:
        st[other] = -(-t.shape[unit] // 8) * 8
    if t.shape[0] == 1:
        st[0] = 0
    return st


def tma_operand(t: torch.Tensor, unit: int) -> torch.Tensor:
    """``t`` itself when ``tma_ready(t, unit)``, else a copy that is: the
    same values in a buffer whose ``unit`` dim is contiguous and whose
    other dim's stride is padded up to a multiple of 8 (the padding never
    read: the kernel's extents are the operand's own)."""
    if tma_ready(t, unit):
        return t
    nb, r, c = t.shape
    if unit == 2:
        buf = torch.empty((nb, r, -(-c // 8) * 8), dtype=t.dtype, device=t.device)
        out = buf[:, :, :c]
    else:
        buf = torch.empty((nb, c, -(-r // 8) * 8), dtype=t.dtype, device=t.device)
        out = buf[:, :, :r].transpose(1, 2)
    out.copy_(t)
    return out


def tc_gamma(K: int, out_dtype: torch.dtype = torch.float32) -> float:
    """The tensor-core route's bound factor: |c - c64| <= gamma * sum_k
    |a_k b_k| against a float64 product of the same bf16 operands.

    A product of two bf16 values is exact in float32. The kernel takes K in
    n = ceil(K / 16) wgmma k16 steps, each adding 16 products onto the
    float32 accumulator. Round-to-nearest is not assumed inside the
    instruction: each of a step's 17 addends (the accumulator and 16
    products) may lose up to 2u of the largest one's magnitude when aligned
    and truncated, and the step's sum up to u of itself when it is put back
    into float32 (u = 2^-23, a truncation of a 24-bit significand). With
    S_j the sum of |a_k b_k| up to step j and the accumulator at most
    (1 + gamma) S_{j-1}, step j adds at most 35 u (1 + gamma) S_j of error,
    so over n steps gamma = 35 n u / (1 - 35 n u). A bf16 output adds its
    own rounding, 2^-8 of |c| <= (1 + gamma) S (bf16 keeps 8 significant
    bits): gamma_bf16 = gamma + 2^-8 (1 + gamma)."""
    n = -(-K // 16)
    t = 35 * n * 2.0 ** -23
    if t >= 1:
        raise ValueError(f"tc_gamma: K {K} too wide for the bound")
    g = t / (1 - t)
    return g + 2.0 ** -8 * (1 + g) if out_dtype == torch.bfloat16 else g


def chain_gamma(K: int, out_dtype: torch.dtype = torch.float32) -> float:
    """The float32 chain's bound factor (``"simt"``, ``gemm_plain``): a
    recursive sum of K rounded products, gamma_K = K u / (1 - K u) with u =
    2^-24, then a bf16 output's own rounding as in ``tc_gamma``."""
    t = K * 2.0 ** -24
    g = t / (1 - t)
    return g + 2.0 ** -8 * (1 + g) if out_dtype == torch.bfloat16 else g


def gemm_bound(a: torch.Tensor, b: torch.Tensor, gamma: float):
    """(c64, bound): the float64 product of a (batch, M, K) and b (batch, K,
    N) and gamma * sum_k |a_k b_k| per element, on the operands' device."""
    a64, b64 = a.double(), b.double()
    return a64 @ b64, gamma * (a64.abs() @ b64.abs())


def gemm_work(a, b, out_dtype=None):
    """(bytes, INT32 operations, floating operations) of a ``gemm``: each
    operand read once, the output written once; 2MNK (a product and an add
    an element and k)."""
    nb, M, K = a.shape
    N = b.shape[-1]
    nbytes = (a.numel() * a.element_size() + b.numel() * b.element_size()
              + nb * M * N * _out_dtype(a, b, out_dtype).itemsize)
    return nbytes, 0, 2 * nb * M * N * K


@cost.booked("gemm", gemm_work)
def gemm(a: torch.Tensor, b: torch.Tensor,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a (batch, M, K) x b (batch, K, N) -> (batch, M, N), bf16 or float32
    operands of any strides, in the row-count-invariant order (module
    docstring); ``out_dtype`` float32 or bf16 (default torch's promotion)."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"gemm takes (batch, M, K) x (batch, K, N), got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gemm_plain(a, b, out_dtype)
    dtype = _out_dtype(a, b, out_dtype)
    codes = build.DTYPE_CODE
    if (a.device != b.device or a.dtype not in codes or b.dtype not in codes
            or dtype not in codes):
        raise ValueError("gemm: the kernel takes float32 or bfloat16 operands and "
                         "output on one device")
    nb, M, K = a.shape
    N = b.shape[-1]
    c = torch.empty((nb, M, N), dtype=dtype, device=a.device)
    if a.device.type == "meta" or c.numel() == 0:
        return c
    if K == 0:
        return c.zero_()
    if nb > 65535:
        raise ValueError(f"gemm: batch {nb} beyond the kernel's grid (65535)")
    if gemm_route(a.dtype, b.dtype) == "tc":
        # b N-major (a (K, N) weight) or K-major (an (N, K) table's transpose)
        unit_b = 1 if b.stride(1) == 1 and b.shape[1] > 1 and b.stride(2) != 1 else 2
        a, b = tma_operand(a, 2), tma_operand(b, unit_b)
        sa, sb = _tma_strides(a, 2), _tma_strides(b, unit_b)
        rc = build.library("gemm_tc").tc_gemm(
            a.data_ptr(), *sa, b.data_ptr(), *sb, c.data_ptr(), codes[dtype],
            nb, M, N, K, build.stream_ptr(a))
        build.check(rc, "gemm_tc")
        build.count("gemm_tc")
        return c
    rc = build.library("gemm").invariant_gemm(
        a.data_ptr(), codes[a.dtype], *a.stride(), b.data_ptr(), codes[b.dtype],
        *b.stride(), c.data_ptr(), codes[dtype], nb, M, N, K,
        int(wide_tiles(M, N, nb)), build.stream_ptr(a))
    build.check(rc, "gemm")
    build.count("gemm")
    return c


def _matmul(product, a, b, out_dtype):
    if b.dim() != 2:
        raise ValueError(f"matmul takes a (K, N) weight, got {tuple(b.shape)}")
    lead = a.shape[:-1]
    out = product(a.reshape(1, -1, a.shape[-1]), b[None], out_dtype)
    return out.view(*lead, b.shape[-1])


def matmul(a: torch.Tensor, b: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` for a (..., K) and a weight b (K, N) shared by every row:
    one ``gemm`` over the rows flattened into M."""
    return _matmul(gemm, a, b, out_dtype)


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``matmul`` through ``gemm_plain``, on any device."""
    return _matmul(gemm_plain, a, b, out_dtype)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` for two operands as one batched ``gemm``:
    labels in both operands and the output are the batch, in both operands
    only the reduction (flattened in ``a``'s order), in one operand and the
    output that operand's rows or columns. A label in one operand only (a
    sum of it alone) or repeated in an operand is refused."""
    return _einsum(gemm, eq, a, b)


def einsum_plain(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` through ``gemm_plain``, on any device."""
    return _einsum(gemm_plain, eq, a, b)


def _einsum(product, eq, a, b):
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")
    if (len(set(la)) != len(la) or len(set(lb)) != len(lb) or len(set(out)) != len(out)
            or len(la) != a.dim() or len(lb) != b.dim()):
        raise ValueError(f"einsum {eq!r}: unsupported for shapes "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    batch = [c for c in la if c in lb and c in out]
    red = [c for c in la if c in lb and c not in out]
    rows = [c for c in la if c not in lb and c in out]
    cols = [c for c in lb if c not in la and c in out]
    if set(out) != set(batch + rows + cols) or (
            set(la) | set(lb) != set(batch + red + rows + cols)):
        raise ValueError(f"einsum {eq!r}: a label summed in one operand alone")
    size = {**dict(zip(la, a.shape)), **dict(zip(lb, b.shape))}
    for c in batch + red:
        if a.shape[la.index(c)] != b.shape[lb.index(c)]:
            raise ValueError(f"einsum {eq!r}: label {c} has sizes "
                             f"{a.shape[la.index(c)]} and {b.shape[lb.index(c)]}")

    def n(labels):
        return math.prod(size[c] for c in labels)

    a3 = a.permute([la.index(c) for c in batch + rows + red]).reshape(
        n(batch), n(rows), n(red))
    b3 = b.permute([lb.index(c) for c in batch + red + cols]).reshape(
        n(batch), n(red), n(cols))
    c = product(a3, b3, None).view([size[x] for x in batch + rows + cols])
    got = batch + rows + cols
    return c.permute([got.index(x) for x in out])


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Float32 logits of ``x`` (..., d) against a (vocab, d) table: the
    operands' own dtypes go in (a bf16 product is exact in float32, so the
    bits are those of float32 operands) and the chain sums in float32."""
    return matmul(x, table.t(), out_dtype=torch.float32)

