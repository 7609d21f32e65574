"""xLSTM blocks (port of ``repro/models/xlstm.py``): mLSTM (matrix memory,
chunkwise-parallel) and sLSTM (scalar memory, a recurrence over time),
Beck et al. 2024 (arXiv:2405.04517).

Every sLSTM output gate and every tanh (2 sigma(2z) - 1, range "reduce")
goes through the activation registry, and so does every SiLU of the mLSTM
conv and gate paths and of the sLSTM FFN: under ``act_impl="cordic_pallas"``
they launch ``act_2d`` (``sigmoid_wide``). The mLSTM forget gate is
``log_sigmoid`` in float, as the reference computes it
(``jax.nn.log_sigmoid``); its registry ``sigmoid`` is built but unused there
and is not built here.

mLSTM uses exp input gates with log-domain max stabilisation; the chunkwise
form is quadratic inside a chunk and a loop over chunks carrying (C, n, m)
per head, as models/ssm.py. A length that is not a multiple of the chunk is
padded with inert steps (input gate -1e30, log forget gate 0).

Caches are dicts of float32 tensors, (batch, ...) per leaf, updated in
place: {"C", "n", "m", "conv"} (mLSTM) and {"c", "n", "m", "h"} (sLSTM).
The JAX ``conv`` leaf comes back in the compute dtype; here it is stored in
float32 and cast at use, which changes no value.

Tensor parallelism (distributed/sharding.py), when the heads divide tp:

- mLSTM: a rank holds its heads' share of ``up_proj``'s xm and z columns
  and of the conv, and the matching rows of ``wq/wk/wv/w_if`` and
  ``down_proj``. Its q, k, v and gate products are partial sums over
  d_inner: they are reduced in one all-reduce of their concatenation, and
  the rank keeps its heads of q/k/v and its heads' two gate columns, so the
  state (C, n, m) is (B, H/tp, ...) (C is 16.8 MB a slot and layer at
  xLSTM-1.3B's width in float32: whole on every rank it would be the
  cut's largest waste). The RMSNorm over d_inner reduces its sum of
  squares, then ``down_proj``'s partial product is summed once.
- sLSTM: the gate columns of ``w``/``b`` are cut by head, and the
  block-diagonal recurrent ``r`` stays whole (the rank reads its heads),
  so the time loop runs on the rank's heads with no collective inside it.
  After the loop one gather of h (B, S, d) feeds the post-norm, then the
  FFN runs column- and row-parallel with one all-reduce. Under
  ``cfg.slstm_state == "replicated"`` (the JAX setting that pins the scan's
  state off the model axis) the rank gathers ``wx`` once before the loop
  and runs every head with the whole state instead; both give tp 1's
  tokens.

A mixer whose heads do not divide tp runs whole on every rank (its leaves
are whole).

Under grad (the train step on a mesh) a cut mixer's input takes its
gradient summed over the model axis (``shd.to_ranks``), the mLSTM's
reduced products and the norms' sums of squares sum theirs too
(``shd.shared_sum``), and ``gather_heads`` passes each rank its heads'
slice of the gradient back. The whole leaves a rank reads in part (the
mLSTM's ``b_if`` and ``norm``, the sLSTM's ``r`` unless its state is
replicated) get partial gradients, which the train step sums over the
model axis once (``shd.partial_leaves``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as tF
from torch import nn

from repro_torch.core.activations import get_activation
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import cost as kcost
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlpm

NEG = -1e30


def _write(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]) -> None:
    for k, v in new.items():
        cache[k].copy_(v)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mdims(cfg):
    d_inner = int(cfg.d_model * cfg.xlstm.proj_factor)
    H = cfg.num_heads
    return d_inner, H, d_inner // H


class MLSTM(nn.Module):
    """up_proj (d, 2 d_inner), conv_w (d_conv, d_inner), conv_b, wq/wk/wv
    (d_inner, d_inner), w_if (d_inner, 2H), b_if (2H,), norm (d_inner,),
    down_proj (d_inner, d): the JAX ``mlstm_spec``."""

    def __init__(self, cfg, *, dtype, device, gen=None):
        super().__init__()
        self.cfg = cfg                  # a rank's cut reads it (sharding)
        d = cfg.d_model
        d_inner, H, _ = mdims(cfg)
        x = cfg.xlstm
        leaf = lambda shape, std=None: mlpm.leaf(shape, gen, dtype, device, std)
        fill = lambda shape, v: nn.Parameter(
            torch.full(shape, v, dtype=dtype, device=device), requires_grad=False)
        self.up_proj = leaf((d, 2 * d_inner))
        self.conv_w = leaf((x.d_conv, d_inner), 0.5)
        self.conv_b = fill((d_inner,), 0.0)
        self.wq = leaf((d_inner, d_inner))
        self.wk = leaf((d_inner, d_inner))
        self.wv = leaf((d_inner, d_inner))
        self.w_if = leaf((d_inner, 2 * H), 0.02)
        self.b_if = fill((2 * H,), 0.0)
        self.norm = fill((d_inner,), 1.0)
        self.down_proj = leaf((d_inner, d))


def _local_heads(cfg, mesh) -> int:
    H = cfg.num_heads
    return H // mesh.tp if shd.mixer_is_cut(H, mesh) else H


def mlstm_init_cache(cfg, batch: int, *, device, mesh=None) -> Dict[str, torch.Tensor]:
    _, _, dk = mdims(cfg)
    H = _local_heads(cfg, mesh)
    d_inner = H * dk
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, dk, dk), **f32),
            "n": torch.zeros((batch, H, dk), **f32),
            "m": torch.full((batch, H), NEG, **f32),
            "conv": torch.zeros((batch, cfg.xlstm.d_conv - 1, d_inner), **f32)}


def mlstm_chunked(q, k, v, li, lf, chunk: int, state=None):
    """Chunkwise stabilised mLSTM. q/k/v (B,S,H,D), li the input gate
    preactivation and lf the log forget gate (B,S,H), all float32.
    Returns y (B,S,H,D) and the final (C, n, m)."""
    B, S, H, D = q.shape
    L = min(chunk, S)
    S_orig = S
    if S % L:
        # inert pad: q/k/v 0, input gate -1e30 (no write), log forget 0
        # (state kept through the pad tail)
        pad = L - S % L
        q, k, v = (tF.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        lf = tF.pad(lf, (0, 0, 0, pad))
        li = tF.pad(li, (0, 0, 0, pad), value=NEG)
        S += pad
    nc = S // L
    scale = 1.0 / math.sqrt(D)
    cr = lambda t: t.reshape((B, nc, L) + tuple(t.shape[2:]))
    qc, kc, vc, lic = cr(q), cr(k), cr(v), cr(li)
    Fc = torch.cumsum(cr(lf), dim=2)                       # (B,nc,L,H)
    totF = Fc[:, :, -1]                                    # (B,nc,H)
    idx = torch.arange(L, device=q.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    if state is None:
        C = torch.zeros((B, H, D, D), dtype=torch.float32, device=q.device)
        n = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
        m = torch.full((B, H), NEG, dtype=torch.float32, device=q.device)
    else:
        C, n, m = state
    ys = []
    for c in range(nc):
        qb, kb, vb, lib, Fb, totb = (qc[:, c], kc[:, c], vc[:, c], lic[:, c],
                                     Fc[:, c], totF[:, c])
        # D_ij = F_i - F_j + li_j  (i >= j)
        Dm = torch.where(causal, Fb[:, :, None, :] - Fb[:, None, :, :]
                         + lib[:, None, :, :], -math.inf)  # (B,L,L,H)
        m_intra = Dm.amax(dim=2)                           # (B,L,H)
        m_inter = Fb + m[:, None, :]
        mi = torch.clamp_min(torch.maximum(m_intra, m_inter), NEG)
        Sij = torch.exp(Dm - mi[:, :, None, :])
        att = torch.einsum("blhd,bmhd->blmh", qb, kb) * scale
        num_intra = torch.einsum("blmh,bmhd->blhd", Sij * att, vb)
        den_intra = torch.einsum("blmh,bmhd,blhd->blh", Sij, kb, qb) * scale
        w_in = torch.exp(m_inter - mi)                     # (B,L,H)
        num_inter = torch.einsum("blh,blhd,bhde->blhe", w_in, qb, C) * scale
        den_inter = torch.einsum("blh,blhd,bhd->blh", w_in, qb, n) * scale
        num = num_intra + num_inter
        den = den_intra + den_inter
        ys.append(num / torch.maximum(den.abs(), torch.exp(-mi))[..., None])
        # the chunk-end state
        m_out = torch.maximum(totb + m,
                              (totb[:, None, :] - Fb + lib).amax(dim=1))
        wC = torch.exp(totb + m - m_out)                   # (B,H)
        wK = torch.exp(totb[:, None, :] - Fb + lib - m_out[:, None, :])
        C = wC[:, :, None, None] * C + torch.einsum("blh,blhd,blhe->bhde",
                                                    wK, kb, vb)
        n = wC[:, :, None] * n + torch.einsum("blh,blhd->bhd", wK, kb)
        m = m_out
    y = torch.stack(ys, dim=1).reshape(B, S, H, D)
    return y[:, :S_orig], (C, n, m)


def mlstm_decode_step(q, k, v, li, lf, state):
    """One stabilised update. q/k/v (B,H,D), li/lf (B,H), float32."""
    C, n, m = state
    scale = 1.0 / math.sqrt(q.shape[-1])
    m_new = torch.maximum(lf + m, li)
    wC = torch.exp(lf + m - m_new)
    wK = torch.exp(li - m_new)
    C_new = wC[..., None, None] * C + wK[..., None, None] * (k[..., :, None]
                                                             * v[..., None, :])
    n_new = wC[..., None] * n + wK[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C_new) * scale
    den = torch.einsum("bhd,bhd->bh", q, n_new) * scale
    y = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return y, (C_new, n_new, m_new)


def mlstm_apply(p: MLSTM, x: torch.Tensor, cfg,
                cache: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """x (B,S,d) -> (B,S,d); a cache is read and then updated in place. S == 1
    with a cache is the decode update, anything else the chunked form
    (continuing from the cache's state when one is given). A rank of a cut
    mixer runs its heads (module docstring)."""
    B, S, _ = x.shape
    d_inner, H, dk = mdims(cfg)
    cut = shd.is_cut(p, "down_proj")
    lo, hi = shd.head_range(H) if cut else (0, H)
    H_l, d_l = hi - lo, (hi - lo) * dk
    silu = get_activation("silu", cfg.act_impl, range_mode="reduce")
    dt = x.dtype
    if cut:
        x = shd.to_ranks(x)
    up = x @ p.up_proj.to(dt)
    xm, z = up[..., :d_l], up[..., d_l:]
    xc, new_conv = cm.causal_conv(xm, p.conv_w.to(dt),
                                  cache["conv"] if cache is not None else None)
    xc = silu(xc + p.conv_b.to(dt))
    if cut:
        # partial sums over the rank's d_inner rows: one all-reduce of the
        # four, then the rank's heads of each
        red = shd.shared_sum(torch.cat(
            [xc @ p.wq.to(dt), xc @ p.wk.to(dt), xm @ p.wv.to(dt),
             xm @ p.w_if.to(dt)], dim=-1))
        q, k, v = (red[..., i * d_inner + lo * dk:i * d_inner + hi * dk]
                   for i in range(3))
        gif = red[..., 3 * d_inner:] + p.b_if.to(dt)
    else:
        q, k, v = xc @ p.wq.to(dt), xc @ p.wk.to(dt), xm @ p.wv.to(dt)
        gif = xm @ p.w_if.to(dt) + p.b_if.to(dt)
    q, k, v = (t.reshape(B, S, H_l, dk) for t in (q, k, v))
    li = gif[..., lo:hi].to(torch.float32)                 # input gate preact
    lf = cm.log_sigmoid(gif[..., H + lo:H + hi].to(torch.float32))  # log forget
    f32 = lambda t: t.to(torch.float32)
    if cache is not None and S == 1:
        y, (C2, n2, m2) = mlstm_decode_step(
            f32(q[:, 0]), f32(k[:, 0]), f32(v[:, 0]), li[:, 0], lf[:, 0],
            (cache["C"], cache["n"], cache["m"]))
        y = y[:, None]
    else:
        state = ((cache["C"], cache["n"], cache["m"]) if cache is not None
                 else None)
        y, (C2, n2, m2) = mlstm_chunked(f32(q), f32(k), f32(v), li, lf,
                                        cfg.xlstm.chunk, state)
    if cache is not None:
        _write(cache, {"C": C2, "n": n2, "m": m2, "conv": new_conv})
    y = y.to(dt).reshape(B, S, d_l)
    if cut:
        y = cm.rmsnorm_cut(p.norm[lo * dk:hi * dk], y, d_inner) * silu(z)
        return shd.row_sum(y @ p.down_proj.to(dt))
    y = cm.rmsnorm(p.norm, y) * silu(z)
    return y @ p.down_proj.to(dt)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
class SLSTM(nn.Module):
    """w (d, 4d) and b (4d,): the i, f, z, o preactivations; r (4, H, dh,
    dh) the recurrent weights; norm (d,); ffn: a SwiGLU of width d *
    ffn_factor (the JAX ``slstm_spec``)."""

    def __init__(self, cfg, *, dtype, device, gen=None):
        super().__init__()
        self.cfg = cfg                  # a rank's cut reads it (sharding)
        d, H = cfg.d_model, cfg.num_heads
        dh = d // H
        self.w = mlpm.leaf((d, 4 * d), gen, dtype, device)
        self.b = nn.Parameter(torch.zeros(4 * d, dtype=dtype, device=device),
                              requires_grad=False)
        self.r = mlpm.leaf((4, H, dh, dh), gen, dtype, device, 0.02)
        self.norm = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                 requires_grad=False)
        self.ffn = mlpm.SwiGLU(d, int(d * cfg.xlstm.ffn_factor), dtype=dtype,
                               device=device, gen=gen)


def slstm_init_cache(cfg, batch: int, *, device, mesh=None) -> Dict[str, torch.Tensor]:
    """The (batch, d) state; a rank of a cut sLSTM holds its heads' d/tp,
    or the whole d under ``cfg.slstm_state == "replicated"``."""
    d = cfg.d_model
    if cfg.slstm_state != "replicated":
        d = _local_heads(cfg, mesh) * (cfg.d_model // cfg.num_heads)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32), "n": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), NEG, **f32), "h": torch.zeros((batch, d), **f32)}


def slstm_cell(r, wx_t, state, sig, tanh):
    """One sLSTM step from the precomputed input preactivations wx_t
    (B, 4d) and the recurrent weights ``r`` (4, H, dh, dh) of the heads the
    state holds: exponential input and forget gates in the log domain."""
    H, dh = r.shape[1], r.shape[2]
    c, n, m, h = state
    rh = torch.einsum("bhe,ghef->bghf", h.reshape(-1, H, dh), r.to(h.dtype))
    pre = wx_t + rh.reshape(-1, 4 * H * dh)
    pi, pf, pz, po = (t.to(torch.float32) for t in pre.chunk(4, dim=-1))
    m_new = torch.maximum(pf + m, pi)
    i = torch.exp(pi - m_new)
    f = torch.exp(pf + m - m_new)
    c_new = f * c + i * tanh(pz)
    n_new = f * n + i
    h_new = sig(po) * c_new / torch.clamp_min(n_new, 1e-6)
    return c_new, n_new, m_new, h_new


def slstm_apply(p: SLSTM, x: torch.Tensor, cfg,
                cache: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """x (B,S,d) -> (B,S,d): the input preactivations hoisted out of a time
    loop, then the post-norm and the gated FFN. ``cfg.slstm_state`` matters
    on a rank of a cut sLSTM only (module docstring): "auto" runs the
    rank's heads and gathers h after the loop, "replicated" gathers the
    preactivations before it and runs every head."""
    B, S, d = x.shape
    H = cfg.num_heads
    sig = get_activation("sigmoid", cfg.act_impl, range_mode="reduce")
    tanh = get_activation("tanh", cfg.act_impl, range_mode="reduce")
    cut = shd.is_cut(p, "w")
    wx = (shd.to_ranks(x) if cut else x) @ p.w.to(x.dtype) + p.b.to(x.dtype)
    replicated = cut and cfg.slstm_state == "replicated"
    r = p.r
    if replicated:
        wx = shd.gather_heads(wx, 4)                       # every head's gates
    elif cut:
        lo, hi = shd.head_range(H)
        r = r[:, lo:hi]
    d_s = wx.shape[-1] // 4
    if cache is not None:
        st = (cache["c"], cache["n"], cache["m"], cache["h"])
    else:
        zero = torch.zeros((B, d_s), dtype=torch.float32, device=x.device)
        st = (zero, zero, torch.full_like(zero, NEG), zero)
    hs = []
    if wx.device.type == "meta":
        # the dry run (launch/dryrun.py): a step's work, counted S times
        # (under grad its backward too)
        st = kcost.repeated_step(S, lambda r, w, *s: slstm_cell(r, w, s, sig, tanh),
                                 r, wx[:, 0], *st)
        hs = [st[3]] * S
    for t in range(len(hs), S):
        st = slstm_cell(r, wx[:, t], st, sig, tanh)
        hs.append(st[3])
    if cache is not None:
        _write(cache, dict(zip(("c", "n", "m", "h"), st)))
    h = torch.stack(hs, dim=1).to(x.dtype)
    if cut and not replicated:
        h = shd.gather_heads(h)                            # (B,S,d)
    y = cm.rmsnorm(p.norm, h)
    silu = get_activation("silu", cfg.act_impl, range_mode="reduce")
    f = p.ffn
    ffn_cut = shd.is_cut(f, "w_down")
    y = shd.to_ranks(y) if ffn_cut else y
    g = y @ f.w_gate.to(x.dtype)
    u = y @ f.w_up.to(x.dtype)
    out = (silu(g) * u) @ f.w_down.to(x.dtype)
    return shd.row_sum(out) if ffn_cut else out
