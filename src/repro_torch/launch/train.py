"""Training launcher CLI (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \
        --steps 5 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-v2-lite-16b --smoke --steps 5 --device cpu --compress

Runs the fault-tolerant training loop (train/loop.py) for any registered
arch, on the card (``--device cuda``, the default) or on the CPU through the
plain versions of the kernels (``--device cpu``, with ``--smoke`` for a
config the CPU can run). Takes the JAX launcher's flags: ``--compress``
runs the int8 error-feedback gradient compression
(distributed/compression.py), and ``--act-impl`` the activation registry's
four datapaths (``core/activations.ACT_IMPLS``; ``cordic_pallas``, the CUDA
kernels, by default; the JAX launcher's default is ``cordic_fixed``). The
attention softmax and the loss log-softmax run on the CORDIC kernels
(``softmax_impl`` and ``loss_impl`` ``"cordic_pallas"``); the config's
``remat`` applies. The embeds archs (musicgen-large, internvl2-1b), whose
frontends are stubs, train on token ids, as the JAX launcher trains them.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch import configs
from repro_torch.core.activations import ACT_IMPLS
from repro_torch.optim import adamw
from repro_torch.train import loop as loop_lib


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--act-impl", default="cordic_pallas", choices=ACT_IMPLS,
                    help="activation datapath (default: the CORDIC kernels)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--lr", type=float, default=3e-4)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = (configs.get_smoke(args.arch, act_impl=args.act_impl) if args.smoke
           else configs.get_config(args.arch, act_impl=args.act_impl))
    cfg = dataclasses.replace(cfg, softmax_impl="cordic_pallas",
                              loss_impl="cordic_pallas", input_mode="tokens")
    print(f"[train] arch={cfg.name} params={cfg.param_counts()['total'] / 1e6:.1f}M "
          f"act={cfg.act_impl} compress={args.compress} remat={cfg.remat} "
          f"device={args.device}")

    lc = loop_lib.LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                             ckpt_dir=args.ckpt_dir, accum=args.accum,
                             compress=args.compress)
    out = loop_lib.run(cfg, lc, opt_cfg=adamw.AdamWConfig(lr=args.lr),
                       device=args.device)
    print(f"[train] final loss {out['final_loss']:.4f} after "
          f"{len(out['history'])} steps; restarts={out['restarts']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
