"""Mamba2 (SSD) block (port of ``repro/models/ssm.py``): a chunked
state-space scan.

Inside a chunk the SSD quadratic ("attention-like") form is used; a loop
over chunks carries the (B,H,P,N) state. A length that is not a multiple of
the chunk is padded with inert steps (x 0, dt 0, decay 1). The scan has no
initial-state input: a prefill starts from zero state, as in the
reference. Decode (S == 1 with a cache) is the one-token state update. The
in-projection gate and the gated RMSNorm take their SiLU from the
activation registry (``act_2d`` under ``act_impl="cordic_pallas"``).

The cache is {"ssm" (B,H,P,N), "conv" (B,d_conv-1,conv_dim)}, float32,
updated in place.

Tensor parallelism (distributed/sharding.py): a rank of a cut mixer holds
its H/tp heads' z, x and dt columns of ``in_proj``, the matching conv
channels, the rows of ``out_proj``, and Mamba2's B and C columns (and their
conv channels) by group when the groups divide tp, whole otherwise. It
projects, convolves and scans its heads alone: the state is (B, H/tp, P,
N) and the conv context (B, d_conv-1, its conv width). The gated RMSNorm
spans every rank's heads: each rank reduces the float32 sum of squares of
its slice over the model axis (B*S floats, where a gather of y would move
B*S*d_inner/tp values), then ``out_proj``'s partial product is summed once.
Under grad the block's input takes its gradient summed over the model axis
(``shd.to_ranks``), so does the norm's sum of squares (``shd.shared_sum``),
and the whole leaves a rank reads in part (``dt_bias``, ``A_log``, ``D``,
``norm``, the whole B / C columns) get partial gradients, which the train
step sums over the model axis once (``shd.partial_leaves``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as tF
from torch import nn

from repro_torch.core.activations import get_activation
from repro_torch.distributed import sharding as shd
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlpm


def dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, d_inner + 2 * s.n_groups * s.d_state


class Mamba2(nn.Module):
    """in_proj (d, 2 d_inner + 2 G N + H), conv_w (d_conv, conv_dim),
    conv_b, dt_bias (H,), A_log (H,), D (H,), norm (d_inner,), out_proj
    (d_inner, d): the JAX ``mamba2_spec``."""

    def __init__(self, cfg, *, dtype, device, gen=None):
        super().__init__()
        self.cfg = cfg                  # a rank's cut reads it (sharding)
        s, d = cfg.ssm, cfg.d_model
        d_inner, H, conv_dim = dims(cfg)
        fill = lambda shape, v: nn.Parameter(
            torch.full(shape, v, dtype=dtype, device=device), requires_grad=False)
        self.in_proj = mlpm.leaf((d, 2 * d_inner + 2 * s.n_groups * s.d_state + H),
                                 gen, dtype, device)
        self.conv_w = mlpm.leaf((s.d_conv, conv_dim), gen, dtype, device, 0.5)
        self.conv_b = fill((conv_dim,), 0.0)
        self.dt_bias = fill((H,), 0.0)
        self.A_log = fill((H,), 1.0)
        self.D = fill((H,), 1.0)
        self.norm = fill((d_inner,), 1.0)
        self.out_proj = mlpm.leaf((d_inner, d), gen, dtype, device)


def local_dims(cfg, mesh=None):
    """(d_inner, H, G * N) of one rank's cut (module docstring): the whole
    widths when the mixer is not cut."""
    s = cfg.ssm
    d_inner, H, _ = dims(cfg)
    GN = s.n_groups * s.d_state
    if not shd.mixer_is_cut(H, mesh):
        return d_inner, H, GN
    tp = mesh.tp
    return d_inner // tp, H // tp, GN // tp if s.n_groups % tp == 0 else GN


def mamba2_init_cache(cfg, batch: int, *, device, mesh=None) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    d_l, H_l, GN_l = local_dims(cfg, mesh)
    f32 = dict(dtype=torch.float32, device=device)
    return {"ssm": torch.zeros((batch, H_l, s.head_dim, s.d_state), **f32),
            "conv": torch.zeros((batch, s.d_conv - 1, d_l + 2 * GN_l), **f32)}


def _heads(t: torch.Tensor, hpg: int, dim: int) -> torch.Tensor:
    """``jnp.repeat(t, hpg, axis=dim)``: each group's rows for its heads."""
    return t.repeat_interleave(hpg, dim=dim) if hpg > 1 else t


def ssd_chunked(xh, dt, a_log, Bm, Cm, D, chunk: int):
    """Chunked SSD scan, all float32. xh (B,S,H,P), dt and a_log = dt * A
    (B,S,H), Bm/Cm (B,S,G,N), D (H,). Returns y (B,S,H,P) and the final
    state (B,H,P,N)."""
    B, S, H, Pd = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    L = min(chunk, S)
    S_orig = S
    if S % L:
        pad = L - S % L
        z = lambda t: tF.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        xh, dt, a_log, Bm, Cm = map(z, (xh, dt, a_log, Bm, Cm))
        S += pad
    nc = S // L
    xc = xh.reshape(B, nc, L, H, Pd)
    dtc = dt.reshape(B, nc, L, H)
    Bc = Bm.reshape(B, nc, L, G, N)
    Cc = Cm.reshape(B, nc, L, G, N)
    cums = torch.cumsum(a_log.reshape(B, nc, L, H), dim=2)   # log decay
    total = cums[:, :, -1]                                   # (B,nc,H)
    idx = torch.arange(L, device=xh.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    h = torch.zeros((B, H, Pd, N), dtype=xh.dtype, device=xh.device)
    ys = []
    for c in range(nc):
        xcb, dtb, cumsb, totalb, Bb, Cb = (xc[:, c], dtc[:, c], cums[:, c],
                                           total[:, c], Bc[:, c], Cc[:, c])
        # seg[i, j] = exp(cums_i - cums_j) for i >= j
        seg = torch.exp(torch.where(causal, cumsb[:, :, None, :]
                                    - cumsb[:, None, :, :], -torch.inf))
        CB = _heads(torch.einsum("blgn,bmgn->blmg", Cb, Bb), hpg, -1)
        scores = CB * seg * dtb[:, None, :, :]               # weight dt_j
        y_intra = torch.einsum("blmh,bmhp->blhp", scores, xcb)
        Ch = _heads(Cb, hpg, 2).reshape(B, L, H, N)
        y_inter = torch.einsum("blhn,bhpn,blh->blhp", Ch, h, torch.exp(cumsb))
        decay_out = torch.exp(totalb[:, None, :] - cumsb)    # (B,L,H)
        Bh = _heads(Bb, hpg, 2).reshape(B, L, H, N)
        s_new = torch.einsum("blh,blhn,blhp->bhpn", decay_out * dtb, Bh, xcb)
        h = torch.exp(totalb)[:, :, None, None] * h + s_new
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, S, H, Pd)
    y = y + xh * D[None, None, :, None]
    return y[:, :S_orig], h


def _rank_groups(Bm, Cm, G: int, H: int, lo: int, hi: int):
    """B and C (B,S,G,N) of every group -> the group row each of this
    rank's heads [lo, hi) reads, (B,S,hi-lo,N): one group a head."""
    idx = torch.arange(lo, hi, device=Bm.device) // (H // G)
    return Bm.index_select(2, idx), Cm.index_select(2, idx)


def mamba2_apply(p: Mamba2, x: torch.Tensor, cfg,
                 cache: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """x (B,S,d) -> (B,S,d); a cache is read and then updated in place.
    Prefill (or no cache): the chunked scan from zero state. Decode (S == 1
    with a cache): the state update. A rank of a cut mixer runs its heads
    (module docstring)."""
    s = cfg.ssm
    d_inner, H, _ = dims(cfg)
    B, S, _ = x.shape
    G, N, Pd = s.n_groups, s.d_state, s.head_dim
    cut = shd.is_cut(p, "out_proj")
    lo, hi = shd.head_range(H) if cut else (0, H)
    d_l, H_l = (hi - lo) * Pd, hi - lo
    GN_l = (p.conv_w.shape[1] - d_l) // 2
    silu = get_activation("silu", cfg.act_impl, range_mode="reduce")
    dtype = x.dtype
    if cut:
        x = shd.to_ranks(x)
    zxbcdt = x @ p.in_proj.to(dtype)
    z = zxbcdt[..., :d_l]
    xBC = zxbcdt[..., d_l:2 * d_l + 2 * GN_l]
    dt = zxbcdt[..., 2 * d_l + 2 * GN_l:]
    xBC, new_conv = cm.causal_conv(xBC, p.conv_w.to(dtype),
                                   cache["conv"] if cache is not None else None)
    xBC = silu(xBC + p.conv_b.to(dtype))
    xh = xBC[..., :d_l].reshape(B, S, H_l, Pd)
    Bm = xBC[..., d_l:d_l + GN_l].reshape(B, S, GN_l // N, N)
    Cm = xBC[..., d_l + GN_l:].reshape(B, S, GN_l // N, N)
    if cut and G > 1 and GN_l == G * N:
        # the groups stay whole on a rank of a cut mixer
        Bm, Cm = _rank_groups(Bm, Cm, G, H, lo, hi)
    G_l = Bm.shape[2]
    dt = cm.softplus(dt + p.dt_bias[lo:hi].to(dtype))             # (B,S,H)
    A = -torch.exp(p.A_log[lo:hi].to(torch.float32))              # (H,) < 0
    a_log = dt * A[None, None, :]                                 # float32
    D = p.D[lo:hi]
    f32 = torch.float32
    if cache is not None and S == 1:
        decay = torch.exp(a_log[:, 0])                            # (B,H)
        Bh = _heads(Bm[:, 0], H_l // G_l, 1).reshape(B, H_l, N)
        Ch = _heads(Cm[:, 0], H_l // G_l, 1).reshape(B, H_l, N)
        upd = torch.einsum("bh,bhn,bhp->bhpn", dt[:, 0], Bh, xh[:, 0])
        h_new = decay[:, :, None, None] * cache["ssm"] + upd
        y = torch.einsum("bhn,bhpn->bhp", Ch.to(f32), h_new)
        y = y + xh[:, 0] * D.to(dtype)[None, :, None]
        y = y[:, None].to(dtype)                                  # (B,1,H,P)
        hN = h_new
    else:
        y, hN = ssd_chunked(xh.to(f32), dt.to(f32), a_log.to(f32), Bm.to(f32),
                            Cm.to(f32), D.to(f32), s.chunk)
        y = y.to(dtype)
    if cache is not None:
        cache["ssm"].copy_(hN)
        cache["conv"].copy_(new_conv)
    gated = y.reshape(B, S, d_l) * silu(z)
    if cut:
        yg = cm.rmsnorm_cut(p.norm[lo * Pd:hi * Pd], gated, d_inner)
        return shd.row_sum(yg @ p.out_proj.to(dtype))
    yg = cm.rmsnorm(p.norm, gated)
    return yg @ p.out_proj.to(dtype)
