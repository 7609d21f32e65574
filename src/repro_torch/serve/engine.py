"""Slot-based continuous batching over the paged KV plane (port of
``repro/serve/engine.py``, paged greedy path), for dense GQA models and
MLA/MoE ones (DeepSeek-V2-Lite: compressed-latent and rope-key pools).

Every ``step()`` runs the iteration scheduler's prefill phase, one row per
prefill dispatch (``make_paged_prefill_step``: bucket-padded prompt straight
into the slot's pool blocks, pad-tail writes trimmed to the scratch block),
then ONE batched decode over all slots (``make_paged_decode_step``).
Admission allocates the blocks a request can reach from the refcounted
``KVPager``; a request that does not fit waits at the queue head (FIFO
backpressure); ``submit`` rejects requests that can never be served.

Prefill runs at the bucket width, pad tokens included, as the JAX engine
does: a GShard MoE layer's expert capacity follows the dispatch width
(models/moe.py), so another width would route differently. The one
exception is the prefix cache on a model without MoE layers (below).

The KV memory plane has two options, as in the JAX engine:
``kv_quant="int8" | "q2_14"`` stores the GQA pools as block-scaled codes
(core/kv_quant.py; MLA pools stay unquantized and reject it), and
``prefix_cache=True`` indexes full prompt blocks in a radix tree
(serve/prefix_cache.py): an admission whose prompt shares full blocks with
an earlier one binds those blocks into its table and prefills from the
first unshared block. With the cache on, a model without MoE layers
prefills in block-wide pieces, up to the prompt's last block: cuBLAS picks
its GEMM kernel by the row count, so on the card a position's K, V and
logits would otherwise depend on where its prefill started, and a shared
block would not hold the bytes its sharer would have written itself.
Cache-off prefills stay whole.

The pools, block tables and lengths live on the device and are updated in
place (models/attention.py); the JAX engine's jitted pure functions over
donated caches have no counterpart, since PyTorch runs eagerly.

Not ported yet, each raising where it is asked for: ``kv_impl="dense"``
(ROADMAP A.6), chunked and multi-row prefill (A.6), tensor parallelism
(A.12), observability (A.8), sampling with temperature (A.7) and ``score``
(A.6).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import kv_quant as kvq
from repro_torch.models import transformer as tf
from repro_torch.serve import kv_pager as kvp
from repro_torch.serve import sampling as sp
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import IterationScheduler, PrefillRow


def make_paged_prefill_step(cfg, piece: Optional[int] = None) -> Callable:
    """One prefill row straight into pool blocks.

    tokens (1, W) bucket-padded; view_row (1, M) the block-table row the
    apply writes through (the slot's blocks up to the last one holding a
    position this row can see, scratch after: the tail-write trim);
    start (1,) the first position; then the slot's table row and length
    are set to full_row / pin_len: the bucket's pad tail advanced the
    view's length past the prompt, and the slot keeps the real one (what
    the JAX dense plane's override_cache_length does). With ``piece`` the
    row runs as W / piece applies of ``piece`` positions each, one after
    the other through the same view. Returns the logits row at
    logit_idx."""
    def prefill(params, cache: tf.PagedCache, tokens, slot: int, view_row,
                full_row, start, pin_len: int, logit_idx: int):
        view = cache.view(view_row, start)
        step = piece or tokens.shape[1]
        for i in range(0, tokens.shape[1], step):
            logits, _, _ = tf.apply(params, {"tokens": tokens[:, i:i + step]},
                                    cfg, cache=view)
        cache.tables[slot] = full_row[0]
        cache.lens[slot] = pin_len
        return logits[:, logit_idx - i]
    return prefill


def make_paged_decode_step(cfg) -> Callable:
    """One decode for ALL slots: a batch-``slots`` apply against the global
    pools, then the greedy token per slot."""
    def decode(params, cache: tf.PagedCache, tokens):
        logits, _, _ = tf.apply(params, {"tokens": tokens}, cfg, cache=cache)
        return sp.greedy_tokens(logits[:, -1])
    return decode


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (S,) int32
    max_new_tokens: int = 16
    sampling: Optional[SamplingParams] = None   # None -> engine default
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: set when submit() rejects the request; a rejected request is done
    #: with out == []
    error: Optional[str] = None
    # lifecycle timestamps (time.perf_counter() seconds); -1 = not reached
    t_enqueue: float = dataclasses.field(default=-1.0, repr=False)
    t_admit: float = dataclasses.field(default=-1.0, repr=False)
    t_first: float = dataclasses.field(default=-1.0, repr=False)
    t_finish: float = dataclasses.field(default=-1.0, repr=False)


def _unported(what: str, entry: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {entry})")


class ServeEngine:
    """Static batch of ``slots``; each holds one request. Admission pads the
    prompt to a length bucket and prefills it into freshly allocated pool
    blocks, emitting the first token; every ``step()`` advances all slots
    with one batched decode. Finished slots release their blocks and are
    refilled from the queue, head first."""

    def __init__(self, cfg, params, *, slots: int = 4, max_len: int = 256,
                 eos_token: Optional[int] = None, greedy: bool = True,
                 temperature: float = 1.0, seed: int = 0,
                 sampling: Optional[SamplingParams] = None,
                 softmax_impl: Optional[str] = None,
                 loss_impl: Optional[str] = None,
                 kv_impl: Optional[str] = None,
                 block_len: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 paged_attend_impl: Optional[str] = None,
                 kv_quant: Optional[str] = None,
                 prefill_chunk: Optional[int] = None,
                 prefill_batch: Optional[int] = None,
                 max_prefill_tokens: Optional[int] = None,
                 prefix_cache: bool = False,
                 prefix_eviction: str = "lru",
                 obs=None, tp: Optional[int] = None, mesh=None,
                 device=None):
        assert cfg.input_mode == "tokens", "engine serves token LMs"
        for name, val in (("softmax_impl", softmax_impl), ("loss_impl", loss_impl),
                          ("kv_impl", kv_impl), ("kv_block_len", block_len),
                          ("paged_attend_impl", paged_attend_impl),
                          ("kv_quant", kv_quant)):
            if val is not None:
                cfg = dataclasses.replace(cfg, **{name: val})
        self.cfg = cfg
        self.device = resolve_device(device)
        self.kv_impl = getattr(cfg, "kv_impl", "dense")
        self.block_len = getattr(cfg, "kv_block_len", 16)
        self.paged_attend_impl = getattr(cfg, "paged_attend_impl", "gather")
        if self.kv_impl not in ("dense", "paged"):
            raise ValueError(f"unknown kv_impl {self.kv_impl!r}")
        if self.kv_impl == "dense":
            raise _unported("kv_impl='dense'", "A.6; serve with kv_impl='paged'")
        if self.paged_attend_impl not in ("gather", "pallas"):
            raise ValueError(
                f"unknown paged_attend_impl {self.paged_attend_impl!r}")
        if self.paged_attend_impl == "pallas" and cfg.score_dtype != "f32":
            raise ValueError("paged_attend_impl='pallas' supports "
                             f"score_dtype='f32' only (got {cfg.score_dtype!r})")
        self.kv_quant = getattr(cfg, "kv_quant", "none")
        self._kv_quant_spec = kvq.spec_for(self.kv_quant)   # raises on a typo
        if self._kv_quant_spec is not None and (
                getattr(cfg, "mla", None) is not None
                or any(k.startswith("mla") for k in cfg.block_pattern)):
            raise ValueError(
                "kv_quant applies to GQA paged pools only; MLA layers "
                "store the compressed latent unquantized")
        if prefill_chunk is not None:
            raise _unported("chunked prefill", "A.6")
        if prefill_batch not in (None, 1):
            raise _unported("multi-row prefill", "A.6")
        if obs is not None:
            raise _unported("observability", "A.8")
        if (tp or 1) > 1 or mesh is not None:
            raise _unported("tensor parallelism", "A.12")
        self.default_sampling = (sampling if sampling is not None
                                 else SamplingParams(temperature=temperature,
                                                     greedy=greedy))
        sp.check_greedy(self.default_sampling)
        if params.cfg.d_model != cfg.d_model:
            raise ValueError("params were built for another config")
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params live on {params.embed.device}, the "
                             f"engine runs on {self.device}")
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos = eos_token
        self.buckets = kvp.bucket_lengths(max_len, self.block_len)
        self.scheduler = IterationScheduler(
            buckets=self.buckets, block_len=self.block_len, max_len=max_len,
            prefill_chunk=None, max_prefill_tokens=max_prefill_tokens)
        if max_len % self.block_len:
            raise ValueError(f"max_len {max_len} not a multiple of "
                             f"block_len {self.block_len}")
        self.max_blocks = max_len // self.block_len
        if num_blocks is None:
            num_blocks = slots * self.max_blocks + 1   # worst case + scratch
        self.pager = kvp.KVPager(num_blocks, self.block_len, slots)
        self.prefix = (PrefixCache(self.pager, self.block_len,
                                   policy=prefix_eviction)
                       if prefix_cache else None)
        #: prompt positions served from shared prefix blocks, and prefill
        #: row widths dispatched (pad included; the JAX engine's
        #: prefix.hit_tokens and engine.prefill.tokens)
        self.prefix_hit_tokens = 0
        self.prefill_tokens = 0
        # float32 pools, as the JAX engine allocates them: K/V per kv-head
        # for GQA (the attend casts them to cfg.dtype, the kv_dtype seam;
        # codes and scales under kv_quant), the compressed latent and the
        # rope key for MLA (already rounded to cfg.dtype by the write)
        self._caches = tf.init_paged_cache(cfg, slots, num_blocks,
                                           self.block_len, self.max_blocks,
                                           torch.float32, device=self.device)
        # device bytes per block across layers, whatever the pools hold
        self.pager.block_bytes = self.kv_pool_bytes() // num_blocks
        #: piece width of a prefill (module docstring), None for whole rows
        self.prefill_piece = (self.block_len if prefix_cache and
                              "mla_moe" not in cfg.block_pattern else None)
        self._prefill = make_paged_prefill_step(cfg, self.prefill_piece)
        self._decode = make_paged_decode_step(cfg)
        self._done: List[Request] = []
        self._active: List[Optional[Request]] = [None] * slots
        self._slot_rows = {}
        self._next_tok = np.zeros((slots, 1), np.int32)

    @property
    def _queue(self):
        return self.scheduler.queue

    @property
    def has_work(self) -> bool:
        """Queued or seated requests remain."""
        return bool(self._queue) or any(a is not None for a in self._active)

    def kv_pool_bytes(self) -> int:
        """Resident device bytes of the pools across layers: K/V (codes and
        scales under kv_quant), or MLA's latent and rope key."""
        return self._caches.pool_bytes()

    def decode_workspace_bytes(self) -> int:
        """Device bytes of the float32 workspace one decode-attention kernel
        call allocates at this engine's slots and max_len (the
        ``paged_attention`` plan: scores, codes and each block's P.V sums
        over the whole table), the most over the layer kinds; 0 on the
        gather attend. Transient: one layer's call holds it at a time, on
        top of ``kv_pool_bytes``."""
        from repro_torch.kernels import paged_attention as pa

        if self.paged_attend_impl != "pallas":
            return 0
        cfg, B, L, M = self.cfg, self.slots, self.block_len, self.max_blocks
        words = 0
        for kind in set(cfg.block_pattern):
            if kind.startswith("mla"):
                plan = pa.mla_plan(B, cfg.num_heads, cfg.mla.kv_lora_rank,
                                   cfg.mla.qk_rope_dim, L, M)
            else:
                plan = pa.gqa_plan(B, cfg.num_kv_heads,
                                   cfg.num_heads // cfg.num_kv_heads,
                                   cfg.head_dim, L, M)
            words = max(words, plan.workspace_floats)
        return 4 * words

    def score(self, prompt: np.ndarray) -> np.ndarray:
        raise _unported("log-prob scoring", "A.6")

    # -- admission ------------------------------------------------------------
    def _validate(self, req: Request) -> Optional[str]:
        plen = len(req.prompt)
        if plen < 1:
            return "empty prompt"
        if plen > self.max_len:
            return (f"prompt length {plen} exceeds engine max_len "
                    f"{self.max_len}")
        need = self._blocks_for(req)
        if need > self.pager.capacity:
            return (f"needs {need} KV blocks worst-case but the pool has "
                    f"{self.pager.capacity} allocatable")
        return None

    def submit(self, req: Request) -> None:
        """Validate and enqueue one request; inadmissible requests are
        rejected at once (``req.error`` set, ``done=True``)."""
        req.t_enqueue = time.perf_counter()
        sp.check_greedy(req.sampling or self.default_sampling)
        err = self._validate(req)
        if err is not None:
            req.error = f"rejected at submit: {err}"
            req.done = True
            self._done.append(req)
            return
        # decode never writes past max_len
        req.max_new_tokens = min(req.max_new_tokens,
                                 self.max_len - len(req.prompt) + 1)
        self.scheduler.enqueue(req)

    def _blocks_for(self, req: Request) -> int:
        need_len = min(max(kvp.bucket_for(len(req.prompt), self.buckets),
                           len(req.prompt) + req.max_new_tokens),
                       self.max_len)
        return kvp.blocks_needed(need_len, self.block_len)

    def _admit_slot(self, req: Request):
        """Scheduler callback: a free slot with the request's blocks
        allocated, or None (no free slot, or pool backpressure). With the
        prefix cache on, only the unshared footprint is allocated: the
        matched blocks (pinned by ``match``) go first in the slot's table
        and the slot id comes back as ``(slot, start)``, prefill resuming
        at ``start``."""
        s = next((i for i in range(self.slots) if self._active[i] is None), None)
        if s is None:
            return None
        need_total = self._blocks_for(req)
        shared, start = [], 0
        if self.prefix is not None:
            matched = self.prefix.match(req.prompt)
            start = self.scheduler.resume_start(
                len(req.prompt), len(matched) * self.block_len)
            m_used = start // self.block_len
            if m_used < len(matched):        # the row geometry used fewer
                self.pager.release(matched[m_used:])
            shared = matched[:m_used]
        need = need_total - len(shared)
        if self.prefix is not None and not self.pager.can_alloc(need):
            self.prefix.evict_until(need)
        blocks = self.pager.alloc(s, need, shared=shared)
        if blocks is None:
            if shared:                       # unwind the match pins
                self.pager.release(shared)
            return None
        row = np.zeros(self.max_blocks, np.int32)
        row[:len(shared)] = shared
        row[len(shared):need_total] = blocks
        self._slot_rows[s] = row
        self._active[s] = req
        self.prefix_hit_tokens += start
        req.t_admit = time.perf_counter()
        return (s, start) if start else s

    def _release_slot(self, s: int) -> None:
        """Free the slot's blocks and point its table at scratch block 0, so
        a vacant slot never writes into reallocated blocks."""
        self._active[s] = None
        self._slot_rows.pop(s, None)
        self.scheduler.drop_slot(s)
        self.pager.free(s)
        self._caches.tables[s] = 0
        self._caches.lens[s] = 0

    def _finish(self, req: Request) -> None:
        req.done = True
        req.t_finish = time.perf_counter()
        self._done.append(req)

    def _dispatch_prefill(self, row: PrefillRow) -> None:
        """One prefill row: the prompt from ``row.start`` (past any shared
        prefix blocks) at the row's bucket width, or in pieces up to the
        prompt's last block."""
        req, s = row.req, row.slot
        plen = len(req.prompt)
        width = row.width
        if self.prefill_piece:
            width = min(width, self.block_len * kvp.blocks_needed(
                plen - row.start, self.block_len))
        hi = min(plen, row.start + width)
        toks = np.zeros((1, width), np.int32)
        toks[0, :hi - row.start] = req.prompt[row.start:hi]
        frow = self._slot_rows[s]
        view = np.full((1, self.max_blocks), kvp.SCRATCH_BLOCK, np.int32)
        nb_live = kvp.blocks_needed(hi, self.block_len)
        view[0, :nb_live] = frow[:nb_live]
        dev = self.device
        self.prefill_tokens += width
        logits = self._prefill(
            self.params, self._caches,
            torch.from_numpy(toks).to(dev, torch.int64), s,
            torch.from_numpy(view).to(dev), torch.from_numpy(frow[None]).to(dev),
            torch.full((1,), row.start, dtype=torch.int32, device=dev), plen,
            plen - 1 - row.start)
        first = int(sp.greedy_tokens(logits)[0])
        req.t_first = time.perf_counter()
        if self.prefix is not None:
            # the prompt's full blocks are shareable once written
            nfull = plen // self.block_len
            if nfull:
                self.prefix.insert(req.prompt, [int(b) for b in frow[:nfull]])
        req.out.append(first)
        if (self.eos is not None and first == self.eos) or \
                len(req.out) >= req.max_new_tokens:
            self._finish(req)
            self._release_slot(s)
        else:
            self._next_tok[s, 0] = first

    # -- the loop ---------------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> int:
        """Prefill phase, then one batched decode over the occupied slots.
        Returns the number of slots that advanced (or prefill rows run on a
        prefill-only iteration); 0 means no work was done."""
        rows = self.scheduler.plan(self._admit_slot)
        for row in rows:
            self._dispatch_prefill(row)
        decodable = [s for s in range(self.slots) if self._active[s] is not None]
        if not decodable:
            if not rows and self._queue:
                raise RuntimeError(
                    f"request {self._queue[0].rid} can never be admitted")
            return len(rows)
        nxt = self._decode(self.params, self._caches,
                           torch.from_numpy(self._next_tok).to(self.device,
                                                               torch.int64))
        nxt = nxt.cpu().numpy()
        for s in decodable:
            req = self._active[s]
            tok = int(nxt[s])
            req.out.append(tok)
            self._next_tok[s, 0] = tok
            if (self.eos is not None and tok == self.eos) or \
                    len(req.out) >= req.max_new_tokens:
                self._finish(req)
                self._release_slot(s)
        return len(decodable)

    def run(self) -> List[Request]:
        """Serve until queue and slots drain; returns every submitted
        request in completion order (rejected ones included)."""
        while self.has_work:
            self.step()
        done, self._done = self._done, []
        return done
