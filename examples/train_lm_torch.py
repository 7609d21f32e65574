"""End-to-end training driver on the PyTorch / CUDA port: an LM with CORDIC
activations.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--act cordic_pallas]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --small \
        --steps 20 --seq 64 --batch 4

The torch lane of ``examples/train_lm.py``: the same 16-layer/512-wide
llama-style model (``--small``: 2 layers, 128 wide), trained on the same
deterministic synthetic corpus with the port's stack (train/step.py: AdamW
with the cosine schedule, microbatch accumulation; the async checkpointer;
the straggler detector), printing the loss curve. The SwiGLU gates run the
paper's Q2.14 MR-HRC pipeline: the CUDA kernels on the card
(``--act cordic_pallas``, the default), their plain versions on the CPU;
``--act exact`` compares curves; ``--loss`` picks the cross-entropy's
log-softmax datapath.
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, DataIterator, SyntheticLMDataset
from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib


def build_cfg(act_impl: str, loss_impl: str = "exact", small: bool = False) -> ModelConfig:
    if small:
        return ModelConfig(name="train-demo-small", family="dense", num_layers=2,
                           d_model=128, num_heads=4, num_kv_heads=2, d_ff=512,
                           vocab_size=2048, act_impl=act_impl, loss_impl=loss_impl,
                           rope_theta=1e4, dtype="float32")
    return ModelConfig(name="train-demo-100m", family="dense", num_layers=16,
                       d_model=512, num_heads=8, num_kv_heads=4, d_ff=2048,
                       vocab_size=32768, act_impl=act_impl, loss_impl=loss_impl,
                       rope_theta=1e4, dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, the default) or cpu (their plain versions)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--data-vocab", type=int, default=2048,
                    help="the synthetic stream's vocabulary, a subset of the model's")
    ap.add_argument("--act", default="cordic_pallas",
                    choices=["exact", "cordic_float", "cordic_fixed", "cordic_pallas"])
    ap.add_argument("--loss", default="exact", choices=["exact", "cordic", "cordic_pallas"],
                    help="cross-entropy log-softmax datapath (cfg.loss_impl)")
    ap.add_argument("--small", action="store_true",
                    help="2-layer/128-wide config for quick runs")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_train_lm_torch"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = build_cfg(args.act, args.loss, small=args.small)
    print(f"[train_lm_torch] model {cfg.name}: {cfg.param_counts()['total'] / 1e6:.1f}M "
          f"params, act_impl={cfg.act_impl}, loss_impl={cfg.loss_impl}, device={dev}")
    it = DataIterator(SyntheticLMDataset(DataConfig(
        vocab_size=args.data_vocab, seq_len=args.seq, global_batch=args.batch, seed=42)))
    opt_cfg = adamw.AdamWConfig(lr=3e-4, weight_decay=0.01)
    state = step_lib.init_state(cfg, 0, opt_cfg, device=dev)
    train_step = step_lib.make_train_step(cfg, opt_cfg, accum=args.accum,
                                          warmup_steps=args.steps // 10,
                                          total_steps=args.steps)
    saver = ckpt.AsyncCheckpointer(args.ckpt_dir)
    det = StragglerDetector()
    losses = []
    t_start = time.time()
    for step in range(args.steps):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in next(it).items()}
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])      # waits for the step
        dt = time.perf_counter() - t0
        det.observe(step, dt)
        losses.append(loss)
        if step % 20 == 0 or step == args.steps - 1:
            print(f"  step {step:4d}  loss {loss:7.4f}  "
                  f"gnorm {float(metrics['grad_norm']):6.3f}  {dt * 1e3:6.0f} ms  "
                  f"{args.batch * args.seq / dt / 1e3:5.1f}k tok/s")
        if (step + 1) % 100 == 0:
            saver.save(step + 1, step_lib.checkpoint_tree(state),
                       extra={"data_step": it.state()["step"]})
    saver.wait()
    n = min(10, max(1, len(losses) // 2))
    first, last = float(np.mean(losses[:n])), float(np.mean(losses[-n:]))
    print(f"[train_lm_torch] loss: first{n}={first:.3f} last{n}={last:.3f} "
          f"(uniform={np.log(args.data_vocab):.2f}); wall={time.time() - t_start:.0f}s; "
          f"stragglers={len(det.events)}")
    assert last < first, "training did not reduce loss"
    print("[train_lm_torch] OK — loss decreased through the CORDIC activation path.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
