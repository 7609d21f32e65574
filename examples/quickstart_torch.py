"""Quickstart on the PyTorch / CUDA port: the paper's MR-HRC CORDIC sigmoid.

    PYTHONPATH=src python examples/quickstart_torch.py              # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The torch lane of ``examples/quickstart.py``, through ``src/repro_torch``:

1. Evaluates sigmoid with the bit-accurate 16-bit Q2.14 pipeline and prints
   the paper-comparison accuracy table (Table 2 reproduction).
2. Shows the convergence arithmetic of Sec. 3.1 (ranges / residuals).
3. Runs the CUDA kernel ``act_2d`` (op ``sigmoid``) and checks that it is
   bit-identical to its plain PyTorch version ``act_2d_plain``. This step
   needs the card: on the CPU ``act_2d`` is its plain version, and the
   script says so.
4. Uses the activation through the registry inside a tiny SwiGLU MLP with
   gradients flowing through the quantized forward.
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import cordic as C
from repro_torch.core import sigmoid as S
from repro_torch.core.activations import get_activation
from repro_torch.core.errors import error_stats
from repro_torch.kernels import cordic_act as K


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, the default) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("=" * 72)
    print("1) 16-bit Q2.14 MR-HRC sigmoid vs exact, x in [-1, 1]")
    print("=" * 72)
    for name in ("proposed_mr_hrc_q2.14", "r2_cordic_q2.14 [9]", "pwl_8seg [11]",
                 "lut_256 [10]", "mr_hrc_float (algorithmic)"):
        st = error_stats(S.TABLE2_METHODS[name], S.sigmoid_exact, -1, 1)
        print(f"  {name:32s} MAE={st['mae']:.3e}  max={st['max']:.3e}")
    print("  paper reports MAE 4.23e-4 for the proposed design; ours is better "
          "(full 14-iter LVC) and matches the paper at LVC j<=9.")

    print()
    print("=" * 72)
    print("2) Convergence arithmetic (paper Sec. 3.1)")
    print("=" * 72)
    s = C.PAPER_SCHEDULE
    print(f"  radix-2 range  sum atanh(2^-j), j=2..9  = {s.r2_range:.6f} (>= 0.5)")
    z = torch.linspace(-0.5, 0.5, 50001, dtype=torch.float32)
    print(f"  radix-2 stage worst residual            = "
          f"{float(C.r2_residual_f(z).max()):.6f} (paper: 0.0061)")
    print(f"  radix-4 admissible start range (j=4..7) = {s.r4_range:.6f} "
          f"(paper: 0.0104)")
    lo, hi = s.r4_gain_bounds
    print(f"  radix-4 cumulative gain in [{lo:.8f}, {hi:.1f}]  -> scale-free at "
          f"16 bits (1-gain < 2^-14)")
    print(f"  K_h = {s.r2_gain:.6f}; x0 = 1/K_h = {s.x0:.6f} (absorbed, free)")

    print()
    print("=" * 72)
    print("3) CUDA kernel act_2d (sigmoid) — bit-exact vs its plain version")
    print("=" * 72)
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (8, 512))
                         .astype(np.float32)).to(dev)
    got = K.act_2d(x, "sigmoid")
    want = K.act_2d_plain(x, "sigmoid")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        print(f"  act_2d kernel vs act_2d_plain on (8,512) on "
              f"{torch.cuda.get_device_name(dev)}: bit-identical = "
              f"{bool(torch.equal(got, want))}")
    else:
        print("  no card: on a CPU tensor act_2d runs its plain version "
              "(act_2d_plain); the kernel runs only on the card")
    oracle = S.sigmoid_cordic_fixed(x.cpu())
    print(f"  act_2d vs the Q2.14 pipeline (core.sigmoid) on (8,512): "
          f"bit-identical = {bool(torch.equal(got.cpu(), oracle))}")

    print()
    print("=" * 72)
    print("4) Training through the quantized activation (autograd)")
    print("=" * 72)
    silu = get_activation("silu", "cordic_fixed", range_mode="reduce")
    w = torch.from_numpy(np.random.default_rng(1).normal(0, 0.5, (16, 16))
                         .astype(np.float32)).to(dev).requires_grad_(True)
    loss = torch.mean(torch.square(silu(x[:, :16] @ w) - 0.25))
    (g,) = torch.autograd.grad(loss, w)
    print(f"  loss={float(loss.detach()):.5f}  |grad|={float(g.abs().mean()):.5f} "
          f"(finite: {bool(torch.isfinite(g).all())})")
    print("\nDone. See examples/train_lm_torch.py for the end-to-end LM training driver.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
