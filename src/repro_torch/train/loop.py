"""Fault-tolerant training loop (port of ``repro/train/loop.py``).

Wires together the deterministic data pipeline, the train step on the
device, async checkpoints with auto-resume, straggler detection and
failure injection. ``run()`` survives injected step failures: each one
restores the latest checkpoint and replays the data stream from that step,
so the run reproduces the clean one (tests/test_torch_train.py). The
parameters start from ``torch.Generator(seed)``, not from JAX's key, so a
port run and a JAX run of the same config start from different weights;
a JAX checkpoint carries JAX's weights over.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import manager as ckpt
from repro_torch.data.pipeline import DataConfig, DataIterator, SyntheticLMDataset
from repro_torch.distributed.fault_tolerance import FailureInjector, StragglerDetector
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "repro_torch_ckpt"))
    log_every: int = 10
    accum: int = 1
    compress: bool = False
    max_restarts: int = 10
    seed: int = 0


def to_device(batch_np: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch_np.items()}


def restore_latest(loop: LoopConfig, state):
    """(state restored in place from the latest checkpoint, its data step),
    or (state, None) when there is none."""
    last = ckpt.latest_step(loop.ckpt_dir)
    if last is None:
        return state, None
    tree, extra = ckpt.restore(loop.ckpt_dir, last,
                               step_lib.checkpoint_tree(state, like=True))
    return step_lib.load_checkpoint_tree(state, tree), (last, extra)


def run(cfg, loop: LoopConfig, opt_cfg: Optional[adamw.AdamWConfig] = None,
        injector: Optional[FailureInjector] = None,
        log: Callable[[str], None] = print, device=None) -> Dict[str, Any]:
    """Train ``cfg`` on the synthetic pipeline. Returns the history, final
    loss, restarts, straggler events and the final ``state``."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                          global_batch=8, seed=loop.seed)
    dataset = SyntheticLMDataset(data_cfg)

    train_step = step_lib.make_train_step(
        cfg, opt_cfg, accum=loop.accum, compress=loop.compress,
        warmup_steps=max(loop.total_steps // 10, 1),
        total_steps=loop.total_steps)

    detector = StragglerDetector()
    saver = ckpt.AsyncCheckpointer(loop.ckpt_dir)
    history: list = []
    restarts = 0

    def fresh_state():
        return step_lib.init_state(cfg, loop.seed, opt_cfg,
                                   compress=loop.compress, device=dev)

    # --- resume if a committed checkpoint exists ---------------------------
    state, found = restore_latest(loop, fresh_state())
    if found is not None:
        start, extra = found
        log(f"[loop] resumed from step {start}")
        it = DataIterator(dataset, start_step=int(extra.get("data_step", start)))
        step_i = start
    else:
        it = DataIterator(dataset)
        step_i = 0

    while step_i < loop.total_steps:
        try:
            batch = to_device(next(it), dev)
            t0 = time.perf_counter()
            if injector is not None:
                injector.maybe_fail(step_i)
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if detector.observe(step_i, dt):
                log(f"[ft] straggler flagged at step {step_i}: {dt:.3f}s "
                    f"(would trigger slice reassignment on a real mesh)")
            history.append({"step": step_i, "loss": loss, "dt": dt,
                            "grad_norm": float(metrics["grad_norm"])})
            if step_i % loop.log_every == 0:
                log(f"[loop] step {step_i} loss {loss:.4f} "
                    f"gnorm {history[-1]['grad_norm']:.3f} {dt * 1e3:.0f}ms")
            step_i += 1
            if step_i % loop.ckpt_every == 0 or step_i == loop.total_steps:
                saver.save(step_i, step_lib.checkpoint_tree(state),
                           extra={"data_step": it.state()["step"]})
        except FailureInjector.InjectedFailure as e:
            restarts += 1
            log(f"[ft] {e}; restart {restarts}")
            if restarts > loop.max_restarts:
                raise
            saver.wait()
            state = None                       # free it before the new one
            state, found = restore_latest(loop, fresh_state())
            if found is not None:
                step_i, extra = found
                it.restore({"step": int(extra["data_step"])})
                log(f"[ft] restored step {step_i}, data stream realigned")
            else:
                it.restore({"step": 0})
                step_i = 0

    saver.wait()
    return {"history": history,
            "final_loss": history[-1]["loss"] if history else None,
            "restarts": restarts, "straggler_events": detector.events,
            "state": state}
