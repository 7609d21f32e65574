"""Cross-entropy losses with a selectable log-softmax datapath (port of
``repro/train/losses.py``):

    cfg.loss_impl = "exact"         - max-subtract, exp, log in float32 (the
                                      formula of jax.nn.log_softmax)
    cfg.loss_impl = "cordic"        - cordic_engine.functions.log_softmax
                                      (the plain fixed-point library)
    cfg.loss_impl = "cordic_pallas" - kernels.ops.log_softmax (the CORDIC
                                      log-softmax kernel)

``token_nll`` is an ``autograd.Function`` whatever the datapath: its
backward is the analytic softmax-minus-onehot form,
d logits = g * (exp(logp) - onehot(labels)), from the primal log-probs,
as the JAX ``custom_vjp``; differentiated again, it flows through the
log-softmax of the impl.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

LOSS_IMPLS = ("exact", "cordic", "cordic_pallas")


def _exact_log_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    u = x - x.amax(dim=axis, keepdim=True)
    return u - torch.log(torch.exp(u).sum(dim=axis, keepdim=True))


def log_softmax_fn(impl: str) -> Callable:
    """The log-softmax forward for a loss impl."""
    if impl == "exact":
        return _exact_log_softmax
    if impl == "cordic":
        from repro_torch.cordic_engine import functions as F

        return F.log_softmax
    if impl == "cordic_pallas":
        from repro_torch.kernels import ops as kops

        return kops.log_softmax
    raise ValueError(f"loss impl {impl!r} not in {LOSS_IMPLS}")


def _take_label(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return logp.gather(-1, labels.long()[..., None])[..., 0]


class _TokenNLL(torch.autograd.Function):
    """-log softmax(logits)[labels]; backward g * (exp(logp) - onehot).

    A backward run under grad mode (``create_graph=True``) recomputes
    ``logp`` from the saved logits through the impl's differentiable
    log-softmax, so that ``exp(logp)`` carries a graph and the loss has a
    second derivative, as the JAX ``custom_vjp`` has (its residual ``logp``
    is differentiated through). Otherwise it reads the saved ``logp``; both
    hold the same values."""

    @staticmethod
    def forward(ctx, logits, labels, impl):
        logp = log_softmax_fn(impl)(logits)
        ctx.impl = impl
        ctx.save_for_backward(logits, logp, labels)
        return -_take_label(logp, labels)

    @staticmethod
    def backward(ctx, g):
        logits, logp, labels = ctx.saved_tensors
        if torch.is_grad_enabled():
            logp = log_softmax_fn(ctx.impl)(logits)
        p = torch.exp(logp)
        onehot = torch.zeros_like(p).scatter_(-1, labels.long()[..., None], 1.0)
        return g[..., None] * (p - onehot), None, None


def token_nll(logits: torch.Tensor, labels: torch.Tensor,
              impl: str = "exact") -> torch.Tensor:
    """-log softmax(logits)[labels] per position, (...) float32; logits
    (..., V) float, labels (...) int."""
    return _TokenNLL.apply(logits, labels, impl)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  impl: str = "exact", mesh=None) -> torch.Tensor:
    """Masked-mean token cross entropy (the loss_fn reduction),
    sum(nll * mask) / max(sum(mask), 1). On a ``mesh`` with several data
    ranks the numerator and the count are summed over the data axes first
    (the global batch's mean; a mean of the ranks' means would weigh their
    masks wrong), the numerator's gradient passed through to each rank."""
    nll = token_nll(logits, labels, impl)
    if mask is None:
        mask = torch.ones_like(nll)
    if mesh is None or mesh.dp == 1:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    from repro_torch.distributed import sharding as shd

    num = shd.data_sum((nll * mask).sum(), mesh)
    return num / shd.data_sum(mask.sum(), mesh).clamp_min(1.0)
