"""Row-count-invariant matrix products: plain PyTorch version and the CUDA
kernel (``csrc/gemm.cu``).

No TPU kernel of the JAX package corresponds: it leaves these products to
XLA. The port needs them on the card, where cuBLAS picks its kernel and its
split of the reduction by the problem's shape, so an element's bits follow
the launch's row count (ROADMAP F6, B.10). The paged prefill runs its
products through here (``models/common.py`` ``INVARIANT``): a position's
K, V and logits are then the same bits whatever row count, row width and
start its prefill dispatch had, which is what lets a prefix-cache hit read
the bytes its own prefill would have written.

The order. ``gemm(a, b)``: a (batch, M, K), b (batch, K, N) -> (batch, M,
N). Each output element is one chain over k = 0 .. K-1 in order: ``acc =
acc + a[m, k] * b[k, n]`` in float32 from 0, the product rounded to float32
before the add (the kernel never fuses a multiply-add), then one rounding to
the output dtype. bf16 operands convert to float32 exactly, and a product of
two of them is exact in float32. The order depends on K and the dtypes
alone: not on M, the batch, the element's place or the launch's tiling.
``gemm_plain`` replays it in K vectorized steps, so it and the kernel agree
bit for bit on the card.

``matmul`` and ``einsum`` lay torch's signatures over it (the products of
``_project``, ``_out_project``, the MLPs, ``_scores``, ``_pv``, MLA's
projections and decompression, ``unembed``): operands are permuted and
reshaped to (batch, M, K) and (batch, K, N) (a copy where the strides do not
allow a view; the kernel reads any strides), the result back to the
caller's layout.

On a CPU tensor every wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises; on a meta tensor it returns an empty result
of the right shape (the dry run).
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

