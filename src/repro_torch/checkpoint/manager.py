"""Checkpointing: async save, atomic manifest commit, restore (port of
``repro/checkpoint/manager.py``, same on-disk format).

Layout per checkpoint:
    <dir>/step_<N>/
        manifest.json      - step, time, keys, shapes, dtypes, extra
                             (the data-iterator state); committed last.
        arrays.npz         - flattened leaves keyed by tree path.

A tree is nested dicts and NamedTuples over arrays or tensors; its paths are
the ones JAX writes: a NamedTuple field ``f`` is ``.f``, a dict key ``k`` is
``k``, joined by ``/`` (``.params/seg0/attn/wq``, ``.opt/.mu/embed/table``).
So a checkpoint the JAX trainer wrote restores here and the other way round
(train/step.py builds the JAX ``TrainState`` layout).

* A checkpoint is valid iff its manifest exists: writers stage under
  ``.tmp-<N>`` and rename, so a crash mid-save never corrupts the latest
  valid checkpoint, and ``latest_step`` ignores partial directories.
* ``AsyncCheckpointer`` copies the state's tensors to host memory (host
  arrays, such as ``train/step.py``'s ``checkpoint_tree``, are already
  copies and pass as they are), then writes it on a background thread
  while training goes on; ``wait()`` before saving again or exiting (queue
  depth 1).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def _map_tree(tree, fn: Callable[[str, Any], Any], prefix: str = ""):
    """Rebuild ``tree`` with each leaf replaced by fn(path, leaf); None
    (an empty subtree, as JAX's) stays None."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):      # NamedTuple
        return type(tree)(*(_map_tree(getattr(tree, f), fn, f"{prefix}.{f}/")
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def _flatten_with_paths(tree) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    _map_tree(tree, lambda k, leaf: out.__setitem__(k, leaf))
    return out


def tree_paths(tree):
    return list(_flatten_with_paths(tree).keys())


def _to_host(leaf) -> np.ndarray:
    """A tensor's host copy (never a view: training updates tensors in
    place); host arrays as they are."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, state, extra: Optional[dict] = None) -> str:
    """Synchronous checkpoint write with atomic commit."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = os.path.join(ckpt_dir, f".tmp-{step:08d}-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {k: _to_host(v) for k, v in _flatten_with_paths(state).items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)

    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(a.shape) for k, a in arrays.items()},
        "dtypes": {k: str(a.dtype) for k, a in arrays.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # commit
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(name[5:]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like):
    """Read checkpoint ``step`` in the structure of ``like`` (leaves need
    only ``.shape``: arrays, tensors, meta tensors). Returns (tree of host
    numpy arrays as stored, extra); the caller casts them into its
    tensors."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        missing = set(tree_paths(like)) - set(data.files)
        if missing:
            raise ValueError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")

        def read(key, leaf):
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                                 f"{tuple(leaf.shape)}")
            return arr

        return _map_tree(like, read), manifest["extra"]


class AsyncCheckpointer:
    """Background-thread checkpoint writer (queue depth 1)."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state, extra=None) -> None:
        self.wait()
        # snapshot to host memory before handing to the thread
        host_state = _map_tree(state, lambda _, a: _to_host(a))

        def run():
            try:
                save(self.ckpt_dir, step, host_state, extra)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
