"""Iteration-level prefill scheduler (Orca / Sarathi / vLLM shape).

``ServeEngine.step()`` is one *iteration*: a prefill phase followed by a
single batched decode dispatch. This module owns the prefill-phase policy —
*which prompt tokens get prefilled this iteration* — while the engine keeps
ownership of slots, block allocation, dispatch grouping, and decode.

Policy, per iteration (``plan()``):

1. **Continuations first.** Every slot holding a mid-prefill (chunked)
   request gets its next ``prefill_chunk``-wide chunk, in slot order. A
   request never stalls mid-prompt behind new admissions.
2. **FIFO admissions.** Queue-head requests are admitted while the engine
   can seat them (``admit_fn`` returns a slot, or None on slot/pool
   backpressure — the head then waits, preserving FIFO order). A prompt
   whose padded bucket fits within one chunk is scheduled as a single
   *single-shot* row at its bucket width — exactly the legacy prefill
   path; a longer prompt is split into block-aligned chunks of width
   ``prefill_chunk``, one per iteration, interleaved with decode steps so
   short requests' time-to-first-token stays flat while a long prompt
   streams in.
3. **Token budget.** ``max_prefill_tokens`` caps the total scheduled row
   width per iteration. At least one row always goes through when prefill
   work exists, so progress is guaranteed.

A prefix-cache hit (serve/prefix_cache.py) is *prefill chunks skipped*:
admission binds the matched pool blocks into the slot's table and returns
``(slot, start)``, and the first row covers positions ``start..`` instead
of 0 — ``resume_start`` picks the largest block-aligned start whose row
geometry stays inside the slot's table, so a resumed prompt behaves
exactly like a mid-chunk continuation of today's chunked prefill.

Chunk geometry: a prompt of length P with chunk width C covers positions
``[0, ceil(P/C)*C)`` in exactly ``ceil(P/C)`` chunks — every chunk is full
width (compile shapes stay bounded), the last chunk's pad tail is causally
masked and its KV writes are trimmed to scratch by the engine. Mid-prompt
chunk boundaries are block-aligned (C is a multiple of ``block_len``) so
paged pool writes stay whole-block.

The scheduler is deterministic given the submission order: emitted tokens
are bit-identical to the unchunked engine (see tests/test_scheduler.py).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.serve import kv_pager as kvp


@dataclasses.dataclass
class PrefillRow:
    """One row of prefill work scheduled for the current iteration."""
    req: object                # the engine Request
    slot: int                  # seated slot
    start: int                 # first prompt position this row covers
    width: int                 # row width (tokens dispatched, incl. pad)
    final: bool                # True when this row completes the prompt
    fresh: bool                # True on the request's first row (admission)


class IterationScheduler:
    """Per-iteration admit/chunk planner for ServeEngine.

    Parameters
    ----------
    buckets : prefill bucket widths (bucketed archs) or None (recurrent
        archs prefill at exact length and never chunk).
    block_len : KV block granularity; chunk widths must be multiples.
    max_len : engine sequence capacity; with chunking enabled it must be a
        multiple of ``prefill_chunk`` so chunk coverage never overruns a
        slot's block table.
    prefill_chunk : chunk width in tokens, or None to disable chunking
        (every prompt prefills single-shot at its bucket width — the
        legacy behavior, bit-for-bit).
    max_prefill_tokens : per-iteration token budget across all scheduled
        rows, or None for unlimited.
    """

    def __init__(self, *, buckets: Optional[Tuple[int, ...]], block_len: int,
                 max_len: int, prefill_chunk: Optional[int] = None,
                 max_prefill_tokens: Optional[int] = None):
        if prefill_chunk is not None:
            if buckets is None:
                raise ValueError(
                    "prefill_chunk requires a bucketed (attention-family) "
                    "arch; recurrent archs prefill at exact length")
            if prefill_chunk < 1 or prefill_chunk % block_len != 0:
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} must be a positive "
                    f"multiple of block_len {block_len}")
            if max_len % prefill_chunk != 0:
                raise ValueError(
                    f"max_len {max_len} must be a multiple of "
                    f"prefill_chunk {prefill_chunk} (chunk coverage must "
                    "not overrun the slot's block table)")
        if max_prefill_tokens is not None and max_prefill_tokens < 1:
            raise ValueError("max_prefill_tokens must be >= 1 or None")
        self.buckets = buckets
        self.block_len = block_len
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.max_prefill_tokens = max_prefill_tokens
        self.queue: Deque = deque()
        # slot -> (req, next chunk start); presence marks a mid-prefill slot
        self._chunking: Dict[int, Tuple[object, int]] = {}

    # -- queries ------------------------------------------------------------
    @property
    def chunking(self) -> Dict[int, Tuple[object, int]]:
        """Slots holding a mid-prefill request (not yet decodable)."""
        return self._chunking

    def enqueue(self, req) -> None:
        self.queue.append(req)

    def drop_slot(self, slot: int) -> None:
        """Forget any mid-prefill state for ``slot`` (engine slot release)."""
        self._chunking.pop(slot, None)

    def single_shot(self, plen: int, start: int = 0) -> bool:
        """True when the remaining prompt (positions ``start..plen``)
        prefills in one row. ``start`` > 0 is a prefix-cache resume: the
        first ``start`` positions are already in shared pool blocks."""
        remaining = plen - start
        if self.prefill_chunk is None:
            return True
        if remaining <= self.prefill_chunk:
            return True
        return kvp.bucket_for(remaining, self.buckets) <= self.prefill_chunk

    def admission_width(self, plen: int, start: int = 0) -> int:
        """Width of the first prefill row for a prompt of length ``plen``
        resuming at position ``start`` (0 = no prefix hit)."""
        remaining = plen - start
        if not self.single_shot(plen, start):
            return self.prefill_chunk
        if self.buckets is None:
            return remaining
        w = kvp.bucket_for(remaining, self.buckets)
        # remaining <= chunk but no bucket in [remaining, chunk]: one
        # chunk-wide row covers the whole tail (still block-aligned)
        if self.prefill_chunk is not None and w > self.prefill_chunk:
            w = self.prefill_chunk
        return w

    def resume_start(self, plen: int, cached_len: int) -> int:
        """Largest safe prefill resume position <= ``cached_len``.

        ``cached_len`` is the prefix-cache hit in tokens (a multiple of
        ``block_len``). The returned start keeps every subsequent row
        inside the slot's table: with chunking it aligns down to the
        chunk grid (continuation chunks then land exactly like mid-chunk
        prefill today); single-shot it backs off block-by-block until
        ``start + bucket_for(remaining) <= max_len``, so the padded row
        can never overrun ``max_len`` and trip scatter-index clamping.
        """
        if self.buckets is None or cached_len <= 0:
            return 0                      # recurrent archs never resume
        start = (cached_len // self.block_len) * self.block_len
        if self.prefill_chunk is not None:
            # chunk-grid alignment: every row (first included, since
            # admission_width caps at prefill_chunk) ends <= max_len
            # because max_len % prefill_chunk == 0
            return (start // self.prefill_chunk) * self.prefill_chunk
        while start > 0 and start + self.admission_width(plen, start) \
                > self.max_len:
            start -= self.block_len
        return max(0, start)

    # -- the per-iteration decision -----------------------------------------
    def plan(self, admit_fn: Callable[[object], Optional[int]]
             ) -> List[PrefillRow]:
        """Schedule this iteration's prefill rows.

        ``admit_fn(req)`` is the engine's seating callback: it picks a free
        slot, allocates pool blocks (paged), marks the slot active, and
        returns the slot id — or ``(slot, start)`` when a prefix-cache hit
        binds shared blocks and prefill resumes at block-aligned position
        ``start`` (see ``resume_start``) — or None when the request cannot
        be seated right now (backpressure; the head stays queued, FIFO
        preserved).
        """
        rows: List[PrefillRow] = []
        used = 0
        budget = (self.max_prefill_tokens
                  if self.max_prefill_tokens is not None else float("inf"))

        # 1. continuations: one chunk per mid-prefill slot, slot order
        for slot in sorted(self._chunking):
            if rows and used + self.prefill_chunk > budget:
                break
            req, start = self._chunking[slot]
            final = start + self.prefill_chunk >= len(req.prompt)
            rows.append(PrefillRow(req=req, slot=slot, start=start,
                                   width=self.prefill_chunk, final=final,
                                   fresh=False))
            used += self.prefill_chunk
            if final:
                del self._chunking[slot]
            else:
                self._chunking[slot] = (req, start + self.prefill_chunk)

        # 2. FIFO admissions from the queue head
        while self.queue:
            req = self.queue[0]
            plen = len(req.prompt)
            # worst-case (no-hit) width for the budget check; the actual
            # admitted width only shrinks on a prefix hit
            if rows and used + self.admission_width(plen) > budget:
                break
            seat = admit_fn(req)
            if seat is None:            # no free slot / pool backpressure
                break
            slot, start = seat if isinstance(seat, tuple) else (seat, 0)
            width = self.admission_width(plen, start)
            final = self.single_shot(plen, start)
            self.queue.popleft()
            rows.append(PrefillRow(req=req, slot=slot, start=start,
                                   width=width, final=final, fresh=True))
            used += width
            if not final:
                self._chunking[slot] = (req, start + width)
        return rows
