"""Meshes over ``torch.distributed`` ranks (port of ``repro/launch/mesh.py``).

The JAX package builds a ("data", "model") mesh over the devices one
program sees. The port runs one process per rank: ``run_ranks`` spawns
them and joins them to one process group, and ``make_host_mesh`` lays that
group's world out as a ("data", "model") mesh whose model axis is
``model_parallel`` ranks wide (the data axis takes the rest). Ranks
``[d * tp, (d + 1) * tp)`` form data row d's model group, the one the
model-axis collectives of ``distributed/sharding.py`` run on; the ranks
``m, m + tp, m + 2 tp, ...`` of one model rank m form its data group, the
one the train step reduces its gradients over (train/step.py).

Backend (``pick_backend``): NCCL when every rank has a card of its own;
gloo when ranks share a card (NCCL refuses two ranks on one device) and on
the CPU. Under gloo, CUDA tensors go through host memory
(``Mesh.staged``).

``run_ranks(target, world, payload)`` starts ``world`` processes with the
``spawn`` method (never ``fork``: a parent may run threads, JAX's among
them), each of which joins the group through a ``FileStore`` in a fresh
temporary directory (never a fixed port: test files run side by side),
calls ``target(payload)`` and sends its result back. The parent joins the
children against a deadline and terminates them all when one fails or
the deadline passes, so a stuck rank fails its caller and never hangs it.
``target`` is a function the children can import (a module-level
function of a package module, or of the ``__main__`` script) or its
"module:function" name.

``make_production_mesh`` is the dry run's layout (launch/dryrun.py): the
JAX shapes and axis names, (16, 16) ("data", "model") or (2, 16, 16)
("pod", "data", "model"), as rank 0 sees them, with no process group. On
it (and on any ``Mesh`` without a group) the collectives of
distributed/sharding.py do not communicate: they book their kind and bytes
in ``Mesh.stats`` and return a result of the right shape (``Mesh.dry``).
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import importlib
import os
import pickle
import queue as queue_lib
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Union

import torch

#: seconds a rank waits in a collective or a rendezvous before it fails
GROUP_TIMEOUT_S = 60
#: seconds ``RankGroup.join`` waits, after a rank's failure, for the other
#: ranks to report theirs
FAILURE_GRACE_S = 5.0


@dataclasses.dataclass
class Mesh:
    """A ("data", "model") layout of the process group's ranks, or a
    ("pod", "data", "model") one, as this rank sees it. ``group`` is this
    rank's model-axis process group (None: a dry mesh, whose collectives
    are booked and not run) and ``data_group`` its data-axis one ("pod" x
    "data": the ranks of its model rank; None on a dry mesh or one data
    rank); ``stats`` counts the collectives run on it and their bytes."""
    shape: Dict[str, int]
    rank: int
    group: Any
    backend: str
    stats: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    data_group: Any = None

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def staged(self) -> bool:
        """CUDA tensors go through host memory: gloo's collectives take
        CPU tensors."""
        return self.backend == "gloo"

    @property
    def dry(self) -> bool:
        """No process group: collectives book their bytes and return."""
        return self.group is None

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    @property
    def tp(self) -> int:
        return self.shape["model"]

    @property
    def model_rank(self) -> int:
        return self.rank % self.tp

    @property
    def dp(self) -> int:
        """Ranks over the data axes ("pod" x "data")."""
        return self.size // self.tp

    @property
    def data_rank(self) -> int:
        """This rank's index over the data axes, pod-major (the order of
        the JAX ("pod", "data") batch and ZeRO-1 specs)."""
        return self.rank // self.tp


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def make_host_mesh(model_parallel: int = 1) -> Mesh:
    """("data", "model") mesh over the ranks of the initialised process
    group (one rank when there is none): the model axis is
    ``model_parallel`` ranks wide, the data axis takes the rest."""
    import torch.distributed as dist

    n = _world()
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(
            f"process-group world size {n} is not divisible by "
            f"model_parallel={model_parallel}; pick a tensor-parallel degree "
            "that divides the ranks of the process group (start more with "
            "launch.mesh.run_ranks)")
    rank = dist.get_rank() if dist.is_initialized() else 0
    group = data_group = None
    if dist.is_initialized():
        data = n // model_parallel
        # every rank creates every group, in the same order: the model
        # axis's, then the data axis's
        if data == 1:
            group = dist.group.WORLD
        else:
            for d in range(data):
                g = dist.new_group(list(range(d * model_parallel,
                                              (d + 1) * model_parallel)))
                if d == rank // model_parallel:
                    group = g
        if model_parallel == 1:
            data_group = dist.group.WORLD if data > 1 else None
        elif data > 1:
            for m in range(model_parallel):
                g = dist.new_group(list(range(m, n, model_parallel)))
                if m == rank % model_parallel:
                    data_group = g
    backend = dist.get_backend() if dist.is_initialized() else "none"
    return Mesh(shape={"data": n // model_parallel, "model": model_parallel},
                rank=rank, group=group, backend=backend, data_group=data_group)


def make_production_mesh(multi_pod: bool = False) -> Mesh:
    """The JAX ``make_production_mesh`` layout: (16, 16) ("data", "model"),
    or (2, 16, 16) ("pod", "data", "model") for the two-pod mesh; rank 0's
    view with no process group (a dry mesh)."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    return Mesh(shape=shape, rank=0, group=None, backend="dry")


def dry_mesh(model_parallel: int, rank: int = 0, data: int = 1) -> Mesh:
    """A rank's view of a (data, model_parallel) mesh without a process
    group: the cut it holds, its collectives booked and not run."""
    return Mesh(shape={"data": data, "model": model_parallel}, rank=rank,
                group=None, backend="dry")


def mesh_or_none(model_parallel: Optional[int] = 1) -> Optional[Mesh]:
    """``make_host_mesh`` for multi-rank runs, ``None`` for TP=1: a
    one-rank path never builds a trivial mesh, and stays the single-device
    datapath."""
    if model_parallel in (None, 0, 1):
        return None
    return make_host_mesh(model_parallel)


def pick_backend(world: int, device: str) -> str:
    """NCCL when each of ``world`` ranks has a card of its own, else
    gloo (ranks sharing a card, or the CPU)."""
    if device.startswith("cuda") and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _resolve(target: Union[str, Callable]) -> Callable:
    if callable(target):
        return target
    mod, _, fn = target.partition(":")
    return getattr(importlib.import_module(mod), fn)


def _rank_entry(rank: int, world: int, store_path: str, backend: str,
                target, payload, results, quiet: bool) -> None:
    """One rank: join the group, run ``target(payload)``, send back
    (rank, ok, result or traceback)."""
    import torch.distributed as dist

    if quiet and rank:
        sys.stdout = open(os.devnull, "w")
    try:
        # ranks share the host's cores: one intra-op thread each
        torch.set_num_threads(1)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            out = _resolve(target)(payload)
        finally:
            dist.destroy_process_group()
        # plain pickle: tensors travel as bytes, not as shared-memory
        # handles that die with this process
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:                                    # noqa: BLE001
        results.put((rank, False, traceback.format_exc()))


def rank_call(payload):
    """A ``run_ranks`` target: payload (target, [per-rank argument tuple])
    -> ``target(*args[rank])`` on each rank."""
    import torch.distributed as dist

    target, args = payload
    return _resolve(target)(*args[dist.get_rank()])


def rank_jobs(jobs):
    """A ``run_ranks`` target: jobs [(target, payload)] -> [target(payload)]
    on each rank, in order (one group of ranks serving several callers)."""
    return [_resolve(target)(payload) for target, payload in jobs]


class RankGroup:
    """``world`` spawned ranks of one process group running
    ``target(payload)``, started at construction; ``join`` collects their
    results. Lets a caller work while the ranks run (``run_ranks`` starts
    and joins at once)."""

    def __init__(self, target: Union[str, Callable], world: int, payload: Any = None, *,
                 backend: str = "gloo", timeout: float = 300.0, quiet: bool = True):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self._tmp = tempfile.mkdtemp(prefix="repro_ranks_")
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_entry,
                                   args=(r, world, os.path.join(self._tmp, "store"),
                                         backend, target, payload, self._results,
                                         quiet), daemon=True)
                       for r in range(world)]
        self._deadline = time.monotonic() + timeout
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self._stop()
            raise

    def join(self) -> List[Any]:
        """The ranks' results in rank order. Raises RuntimeError when a rank
        fails, dies or outlives the timeout, with every failing rank's
        traceback in rank order: after the first failure the others get
        ``FAILURE_GRACE_S`` to report, since a peer's failure that follows
        from it (a collective whose peer is gone) may arrive first. Every
        child is gone when it returns."""
        out: Dict[int, Any] = {}
        failed: Dict[int, str] = {}
        procs, results = self._procs, self._results
        cut = self._deadline
        try:
            while len(out) + len(failed) < self.world:
                left = cut - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, ok, res = results.get(timeout=min(left, 1.0))
                except queue_lib.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in out
                            and r not in failed and p.exitcode is not None]
                    if not dead:
                        continue
                    # a last look: the result may have been sent just now
                    try:
                        rank, ok, res = results.get(timeout=2.0)
                    except queue_lib.Empty:
                        for r in dead:
                            failed[r] = (f"rank {r} exited with code "
                                         f"{procs[r].exitcode} and no result")
                        cut = min(cut, time.monotonic() + FAILURE_GRACE_S)
                        continue
                if ok:
                    out[rank] = pickle.loads(res)
                else:
                    failed[rank] = f"rank {rank} failed:\n{res}"
                    cut = min(cut, time.monotonic() + FAILURE_GRACE_S)
            if not failed and len(out) == self.world:
                for p in procs:
                    p.join(max(1.0, self._deadline - time.monotonic()))
        finally:
            self._stop()
        if failed:
            raise RuntimeError("\n".join(failed[r] for r in sorted(failed)))
        if len(out) < self.world:
            raise RuntimeError(f"ranks {sorted(set(range(self.world)) - set(out))} "
                               f"did not finish within {self.timeout} s")
        return [out[r] for r in range(self.world)]

    def _stop(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            if p.pid is None:
                continue
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self._tmp, ignore_errors=True)


def run_ranks(target: Union[str, Callable], world: int, payload: Any = None, *,
              backend: str = "gloo", timeout: float = 300.0,
              quiet: bool = True) -> List[Any]:
    """Run ``target(payload)`` on ``world`` spawned ranks of one process
    group; returns the ranks' results in rank order (``RankGroup``).
    ``quiet`` silences the standard output of ranks other than 0."""
    return RankGroup(target, world, payload, backend=backend, timeout=timeout,
                     quiet=quiet).join()
