"""Paged KV cache management: a host-side *refcounted* block allocator +
the prefill bucket policy.

The serving memory plane is a single global pool of fixed-size KV blocks
per attention layer — device leaves shaped ``(num_blocks, block_len, ...)``
(see models.attention.gqa_init_paged_cache) — and a per-slot *block table*
mapping each slot's logical positions onto pool blocks. This module owns
the host side of that scheme:

``KVPager``
    The refcounted allocator. Every resident block carries a reference
    count: one reference per slot table that binds it, plus one held by
    the prefix cache (serve/prefix_cache.py) when the block's tokens are
    indexed for reuse. ``alloc`` hands out fresh blocks at refcount 1;
    ``retain``/``release`` adjust counts when blocks are shared into
    another slot's table or dropped; a block returns to the free list
    only when its refcount reaches zero — so a prefix block shared by
    five requests is freed exactly once, after the last reference
    (including the cache's) lets go. Block 0 is reserved as the *scratch
    block* and is refcount-pinned at construction: every empty table
    entry (and every table row of a vacant slot) points at it, so
    inactive slots riding along in the batched decode scatter their
    garbage writes into scratch instead of corrupting blocks that have
    been reallocated to live requests, and no release path can ever put
    it on the free list. Allocation is all-or-nothing per request over
    its *unshared footprint*: admission counts only the fresh blocks a
    request needs beyond the prefix blocks it shares — a request that
    does not fit stays in the queue (admission backpressure), it never
    partially holds blocks.

``bucket_lengths`` / ``bucket_for``
    The prefill bucket policy: prompts are padded up to a small geometric
    set of lengths (16, 32, 64, ... max_len), so the number of prefill
    compiles is bounded by the bucket count instead of growing with every
    distinct prompt length. Buckets are multiples of ``block_len`` so a
    padded prefill writes whole blocks. Padding is harmless for output:
    with causal attention the logits at the last *real* position never see
    the pad tail, and pad K/V land past the slot length mask (and are
    overwritten by decode writes).

Sharding: this module is deliberately *shard-agnostic*. Under the
tensor-parallel engine (``ServeEngine(tp=N)``) the pool's device leaves
are sharded over the mesh ``model`` axis on their kv-heads dimension, so
every shard holds ``(num_blocks, block_len, KH/N, dim)`` — the *same*
``num_blocks`` per shard, a head-slice of every block rather than a
block-slice of the pool. There is therefore exactly one logical block id
space: the allocator's free list and the per-slot block tables (which
stay replicated on device) are valid verbatim on every shard, and the
pager never needs to know the mesh exists.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.metrics import NULL_REGISTRY

#: Pool block id reserved for garbage writes from vacant slots; never
#: allocated to a request and never read through a live mask.
SCRATCH_BLOCK = 0




def bucket_lengths(max_len: int, block_len: int = 16,
                   min_bucket: int = 16) -> Tuple[int, ...]:
    """Geometric prefill-length buckets up to ``max_len``.

    Every bucket is a multiple of ``block_len`` (whole-block prefill
    writes) and the last bucket is exactly ``max_len``. Doubling keeps the
    set small: len(buckets) == O(log(max_len / min_bucket)).
    """
    if max_len <= 0:
        raise ValueError(f"max_len must be positive, got {max_len}")
    base = -(-max(min_bucket, block_len) // block_len) * block_len
    out: List[int] = []
    b = base
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(sorted({min(b, max_len) for b in out}))


def bucket_for(length: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= ``length`` (the padded prefill width)."""
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"prompt length {length} exceeds largest bucket "
                     f"{buckets[-1]}")


def blocks_needed(length: int, block_len: int) -> int:
    """Pool blocks required to hold ``length`` positions."""
    return -(-length // block_len)


@dataclasses.dataclass
class PagerStats:
    num_blocks: int            # pool size, including the scratch block
    blocks_in_use: int         # resident: bound to a slot table or cache
    blocks_free: int
    peak_in_use: int           # high-water mark since construction
    allocs: int                # successful allocations
    alloc_failures: int        # backpressure events (request stayed queued)
    blocks_shared: int = 0     # resident blocks with refcount >= 2


class KVPager:
    """Host-side refcounted allocator over the global KV block pool.

    ``num_blocks`` counts the whole pool *including* the reserved scratch
    block, matching the device pool's leading axis. Capacity available to
    requests is therefore ``num_blocks - 1``.

    Reference counting: every resident block has a positive refcount —
    one per slot table binding it plus one for a prefix-cache index
    entry. ``alloc`` mints fresh blocks at refcount 1; binding an
    already-resident block into another owner goes through ``retain``;
    ``release``/``free`` decrement, and a block rejoins the free list
    only at refcount zero. The scratch block's refcount is pinned at
    construction, so it can never be freed or handed out.
    """

    def __init__(self, num_blocks: int, block_len: int, slots: int,
                 metrics=None, block_bytes: int = 0):
        if num_blocks < 2:
            raise ValueError("pool needs >= 2 blocks (one is scratch)")
        if block_len < 1:
            raise ValueError(f"block_len must be >= 1, got {block_len}")
        self.num_blocks = num_blocks
        self.block_len = block_len
        self.slots = slots
        # device bytes per pool block across all layers (K+V codes plus,
        # under kv_quant, the per-block scale tensors) — the engine sets
        # it once the device pools exist; 0 keeps the bytes gauge silent
        self.block_bytes = block_bytes
        # LIFO free list: recently freed blocks are reused first, which
        # keeps the working set compact and exercises stale-block masking
        self._free: List[int] = list(range(num_blocks - 1, SCRATCH_BLOCK, -1))
        self._owned: Dict[int, List[int]] = {}
        # scratch is born pinned: no release path can reach zero on it
        self._refs: Dict[int, int] = {SCRATCH_BLOCK: 1}
        self._peak = 0
        self._allocs = 0
        self._failures = 0
        self.attach_metrics(metrics)

    def attach_metrics(self, metrics) -> None:
        """Bind pool gauges/counters to a repro_torch.obs MetricsRegistry
        (None detaches: updates become no-ops through the null registry)."""
        if metrics is None:
            metrics = NULL_REGISTRY
        self._m_in_use = metrics.gauge("kv.pool.blocks_in_use",
                                       unit="blocks")
        self._m_bytes = metrics.gauge("kv.pool.bytes_in_use", unit="bytes")
        self._m_allocs = metrics.counter("kv.pool.allocs", unit="allocs")
        self._m_failures = metrics.counter("kv.pool.alloc_failures",
                                           unit="events")
        self._m_freed = metrics.counter("kv.pool.blocks_freed",
                                        unit="blocks")

    # -- queries ------------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Blocks allocatable to requests (pool minus the scratch block).
        A request whose worst-case footprint exceeds this can *never* be
        admitted — the engine rejects it at submit() instead of letting it
        head-of-line-block the queue forever."""
        return self.num_blocks - 1

    @property
    def blocks_in_use(self) -> int:
        """Resident blocks: bound to at least one slot table or held by
        the prefix-cache index (scratch excluded)."""
        return self.num_blocks - 1 - len(self._free)

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_shared(self) -> int:
        """Resident blocks referenced more than once (scratch excluded)."""
        return sum(1 for b, c in self._refs.items()
                   if c >= 2 and b != SCRATCH_BLOCK)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def owned(self, slot: int) -> Tuple[int, ...]:
        return tuple(self._owned.get(slot, ()))

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def stats(self) -> PagerStats:
        return PagerStats(num_blocks=self.num_blocks,
                          blocks_in_use=self.blocks_in_use,
                          blocks_free=self.blocks_free,
                          peak_in_use=self._peak,
                          allocs=self._allocs,
                          alloc_failures=self._failures,
                          blocks_shared=self.blocks_shared)

    # -- refcounts ----------------------------------------------------------
    def retain(self, blocks) -> None:
        """Add one reference to each resident block in ``blocks``.

        Used when a block already bound somewhere (a sibling slot's table
        or the prefix-cache index) gains another owner. Retaining a free
        or scratch block is a bug, not a recovery path.
        """
        for b in blocks:
            if b == SCRATCH_BLOCK:
                raise RuntimeError("cannot retain the scratch block")
            c = self._refs.get(b, 0)
            if c < 1:
                raise RuntimeError(f"retain of non-resident block {b}")
            self._refs[b] = c + 1

    def release(self, blocks) -> int:
        """Drop one reference from each block; free those that hit zero.

        Returns how many blocks actually rejoined the free list.
        """
        freed = 0
        for b in blocks:
            if b == SCRATCH_BLOCK:
                raise RuntimeError("cannot release the scratch block")
            c = self._refs.get(b, 0)
            if c < 1:
                raise RuntimeError(f"release of non-resident block {b}")
            if c == 1:
                del self._refs[b]
                self._free.append(b)
                freed += 1
            else:
                self._refs[b] = c - 1
        if freed:
            self._m_freed.inc(freed)
        self._m_in_use.set(self.blocks_in_use)
        self._m_bytes.set(self.blocks_in_use * self.block_bytes)
        return freed

    # -- alloc / free -------------------------------------------------------
    def alloc(self, slot: int, n: int, shared=()) -> Optional[List[int]]:
        """Allocate ``n`` *fresh* blocks for ``slot``; all-or-nothing.

        ``shared`` is the slot's prefix of already-resident blocks, each
        carrying one reference the caller pinned on its behalf (e.g. via
        ``PrefixCache.match``): ownership of those pins transfers to the
        slot — no refcount change here — and ``free(slot)`` will drop
        them. Only the ``n`` fresh blocks (the request's *unshared
        footprint*) hit the free list; that is all admission has to
        budget for.

        Returns the fresh block ids (order == logical block-table order
        after the shared prefix) or None when the pool cannot satisfy the
        request — the caller leaves the request queued (backpressure)
        and must unwind the ``shared`` pins itself.
        """
        if slot in self._owned:
            raise RuntimeError(f"slot {slot} already holds blocks "
                               f"{self._owned[slot]} (free it first)")
        if n < 1 and not shared:
            raise ValueError(f"allocation must be >= 1 block, got {n}")
        if n > len(self._free):
            self._failures += 1
            self._m_failures.inc()        # backpressure stall: head waits
            return None
        for b in shared:
            if self._refs.get(b, 0) < 1:
                raise RuntimeError(f"shared block {b} is not resident")
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._refs[b] = 1
        self._owned[slot] = list(shared) + blocks
        self._allocs += 1
        self._peak = max(self._peak, self.blocks_in_use)
        self._m_allocs.inc()
        self._m_in_use.set(self.blocks_in_use)
        self._m_bytes.set(self.blocks_in_use * self.block_bytes)
        return list(blocks)

    def free(self, slot: int) -> int:
        """Drop the slot's reference on every block it holds; returns how
        many reached refcount zero and rejoined the free list. Blocks
        still pinned elsewhere (sibling slots, the prefix cache) stay
        resident."""
        blocks = self._owned.pop(slot, [])
        if not blocks:
            return 0
        return self.release(blocks)
