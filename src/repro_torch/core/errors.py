"""Error-analysis utilities (port of ``repro.core.errors``)."""
from __future__ import annotations

import numpy as np
import torch


def error_stats(fn, ref_fn, lo: float, hi: float, n: int = 20001) -> dict:
    """MAE / max-abs / RMS error of `fn` vs `ref_fn` on a uniform float32
    grid (the reference's ``jnp.linspace`` points)."""
    x = torch.from_numpy(np.linspace(lo, hi, n, dtype=np.float32))
    y = fn(x).detach().double().cpu().numpy()
    r = ref_fn(x).detach().double().cpu().numpy()
    e = np.abs(y - r)
    return dict(mae=float(e.mean()), max=float(e.max()),
                rms=float(np.sqrt((e * e).mean())), n=n, lo=lo, hi=hi)


def ulp(err: float, frac_bits: int = 14) -> float:
    """Express an absolute error in output ULPs of a Qx.frac format."""
    return err * (1 << frac_bits)
