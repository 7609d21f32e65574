"""Slot-based continuous batching over the paged KV plane (port of
``repro/serve/engine.py``, paged greedy path), for dense GQA models and
MLA/MoE ones (DeepSeek-V2-Lite: compressed-latent and rope-key pools).

Every ``step()`` runs the iteration scheduler's prefill phase
(serve/scheduler.py: chunk continuations first, then FIFO admissions, under
a ``max_prefill_tokens`` budget), then ONE batched decode over all slots
(``make_paged_decode_step``). Admission allocates the blocks a request can
reach from the refcounted ``KVPager``; a request that does not fit waits at
the queue head (FIFO backpressure); ``submit`` rejects requests that can
never be served.

Two knobs shape the prefill phase, as in the JAX engine:

``prefill_chunk=C``   prompts longer than C stream in as block-aligned
    C-wide chunks, one per iteration, interleaved with decode steps, so a
    long prompt no longer stalls the short requests' first tokens.
    Mid-prefill slots are left out of the decode (their chunks pin the
    slot's length each dispatch); the final chunk pins the true length and
    emits the first token. An iteration whose only work is prefill skips
    the decode.
``prefill_batch=R``   up to R scheduled rows run as ONE multi-row prefill
    (``make_paged_prefill_step``), padded to a power of two with
    all-scratch rows. Defaults to ``slots`` when chunking, else 1; under
    the prefix cache on a model without MoE layers it is 1 (below).

Prefill runs at the bucket (or chunk) width, pad tokens included, as the
JAX engine does: a GShard MoE layer's expert capacity follows the dispatch
width (models/moe.py), so another width, chunking or row count would route
differently; with the same knobs the port routes as the JAX engine does.
The one exception is the prefix cache on a model without MoE layers
(below).

The KV memory plane has two options, as in the JAX engine:
``kv_quant="int8" | "q2_14"`` stores the GQA pools as block-scaled codes
(core/kv_quant.py; MLA pools stay unquantized and reject it), and
``prefix_cache=True`` indexes full prompt blocks in a radix tree
(serve/prefix_cache.py): an admission whose prompt shares full blocks with
an earlier one binds those blocks into its table and prefills from the
first unshared block, pinned like a mid-chunk continuation. With the cache
on, a model without MoE layers prefills one row a dispatch in block-wide
pieces, up to the last block the row reaches, chunked or not: cuBLAS picks
its GEMM kernel by the row count, so on the card a position's K, V and
logits would otherwise depend on where its prefill started and on how
many rows shared its dispatch, and a shared block would not hold the bytes
its sharer would have written itself. A ``prefill_batch`` above 1 is
refused there. Cache-off prefills stay whole.

``score(prompt)`` returns the teacher-forced log-probs of a prompt through
the log-softmax datapath of ``cfg.loss_impl`` (train/losses.py), as the
JAX engine's ``score``.

The pools, block tables and lengths live on the device and are updated in
place (models/attention.py); the JAX engine's jitted pure functions over
donated caches have no counterpart, since PyTorch runs eagerly.

Not ported yet, each raising where it is asked for: ``kv_impl="dense"``
(ROADMAP A.6, with the recurrent archs of A.10), tensor parallelism
(A.12), observability (A.8) and sampling with temperature (A.7).
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
    """R prefill rows straight into pool blocks, as ONE batch-R apply
    against the shared pools (the JAX ``make_paged_prefill_step``).

    Per row r: tokens[r] (W,) the bucket/chunk-padded segment; view_rows[r]
    (M,) the block-table row the apply writes through (the slot's blocks up
    to the last one holding a position this row can see, scratch after: the
    tail-write trim; pad rows are all scratch); starts[r] the first
    position; then each valid row's slot gets full_rows[r] and its length
    pinned to pins[r] (the true length on a final row, the chunk frontier
    mid-prompt): the pad tail advanced the view's length past it. Pad rows
    (``valid`` false) register nothing, so a pad row aliasing a live slot
    id never clobbers it. With ``piece`` the rows run as W / piece applies
    of ``piece`` positions each, one after the other through the same view.
    ``slot_ids``, ``pins``, ``logit_idx`` and ``valid`` are host arrays.
    Returns the (R, V) logits rows at logit_idx."""
    def prefill(params, cache: tf.PagedCache, tokens, slot_ids, view_rows,
                full_rows, starts, pins, logit_idx, valid):
        view = cache.view(view_rows, starts)
        R, W = tokens.shape
        step = piece or W
        last = None
        for i in range(0, W, step):
            logits, _, _ = tf.apply(params, {"tokens": tokens[:, i:i + step]},
                                    cfg, cache=view)
            if last is None:
                last = logits.new_empty(R, logits.shape[-1])
            rows = np.flatnonzero((logit_idx >= i) & (logit_idx < i + step))
            if rows.size:
                r = torch.as_tensor(rows, device=logits.device)
                last[r] = logits[r, torch.as_tensor(logit_idx[rows] - i,
                                                    device=logits.device)]
        dev = cache.tables.device
        live = torch.as_tensor(np.flatnonzero(valid), device=dev)
        slots = torch.as_tensor(slot_ids[valid].astype(np.int64), device=dev)
        cache.tables[slots] = full_rows[live]
        cache.lens[slots] = torch.as_tensor(pins[valid], dtype=cache.lens.dtype,
                                            device=dev)
        return last
    return prefill


def make_paged_decode_step(cfg) -> Callable:
    """One decode for ALL slots: a batch-``slots`` apply against the global
    pools, then the greedy token per slot."""
    def decode(params, cache: tf.PagedCache, tokens):
        logits, _, _ = tf.apply(params, {"tokens": tokens}, cfg, cache=cache)
        return sp.greedy_tokens(logits[:, -1])
    return decode


def make_score_step(cfg) -> Callable:
    """Teacher-forced per-token log-probs of prompts (the JAX
    ``make_score_step``): tokens (B, S) -> (B, S - 1) log p(token_t | <t),
    through the log-softmax of ``cfg.loss_impl`` (train/losses.py), so
    served scoring runs the training loss's datapath (``log_softmax_2d``
    under ``cordic_pallas``)."""
    from repro_torch.train import losses

    logp_fn = losses.log_softmax_fn(getattr(cfg, "loss_impl", "exact"))

    def score(params, tokens):
        logits, _, _ = tf.apply(params, {"tokens": tokens}, cfg)
        logp = logp_fn(logits[:, :-1])
        return logp.gather(-1, tokens[:, 1:, None])[..., 0]
    return score


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
    prompt to a length bucket (or, past ``prefill_chunk``, a first chunk)
    and prefills it into freshly allocated pool blocks; the final prefill
    row emits the first token; every ``step()`` advances all slots not
    mid-prefill with one batched decode. Finished slots release their
    blocks and are refilled from the queue, head first."""

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
            prefill_chunk=prefill_chunk, max_prefill_tokens=max_prefill_tokens)
        #: piece width of a prefill (module docstring), None for whole rows
        self.prefill_piece = (self.block_len if prefix_cache and
                              "mla_moe" not in cfg.block_pattern else None)
        if prefill_batch is None:
            prefill_batch = (slots if prefill_chunk is not None
                             and not self.prefill_piece else 1)
        if prefill_batch < 1:
            raise ValueError(f"prefill_batch must be >= 1, got {prefill_batch}")
        if prefill_batch > 1 and self.prefill_piece:
            raise ValueError(
                f"prefill_batch {prefill_batch} with the prefix cache on a model "
                "without MoE layers: its block-wide pieces run one row a "
                "dispatch (module docstring); use prefill_batch=1")
        self.prefill_batch = int(prefill_batch)
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
        self._prefill = make_paged_prefill_step(cfg, self.prefill_piece)
        self._decode = make_paged_decode_step(cfg)
        self._score = make_score_step(cfg)
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

    @torch.inference_mode()
    def score(self, prompt: np.ndarray) -> np.ndarray:
        """(S,) int32 prompt -> (S-1,) per-token log-probs (teacher-forced),
        through the cfg.loss_impl-selected log-softmax datapath."""
        toks = torch.as_tensor(np.asarray(prompt, np.int64)[None], device=self.device)
        return self._score(self.params, toks)[0].cpu().numpy()

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

    def _complete_prefill(self, req: Request, s: int, first: int) -> None:
        """A final prefill row landed: its first token; with the prefix cache
        on, the prompt's full blocks become shareable."""
        req.t_first = time.perf_counter()
        if self.prefix is not None:
            nfull = len(req.prompt) // self.block_len
            if nfull:
                self.prefix.insert(req.prompt,
                                   [int(b) for b in self._slot_rows[s][:nfull]])
        req.out.append(first)
        if (self.eos is not None and first == self.eos) or \
                len(req.out) >= req.max_new_tokens:
            self._finish(req)
            self._release_slot(s)
        else:
            self._next_tok[s, 0] = first

    def _dispatch_prefill(self, group: List[PrefillRow]) -> None:
        """One multi-row prefill over up to ``prefill_batch`` scheduled rows,
        padded to a power of two with all-scratch rows, at the group's
        widest row (or, a single row, in pieces up to the last block it
        reaches)."""
        rp = 1
        while rp < len(group):
            rp *= 2
        width = max(r.width for r in group)
        if self.prefill_piece:                      # one row a dispatch
            (r,) = group
            width = min(r.width, self.block_len * kvp.blocks_needed(
                len(r.req.prompt) - r.start, self.block_len))
        toks = np.zeros((rp, width), np.int32)
        slot_ids = np.zeros(rp, np.int32)
        view_rows = np.full((rp, self.max_blocks), kvp.SCRATCH_BLOCK, np.int32)
        full_rows = np.zeros((rp, self.max_blocks), np.int32)
        starts = np.zeros(rp, np.int32)
        pins = np.zeros(rp, np.int32)
        lidx = np.zeros(rp, np.int64)
        valid = np.zeros(rp, bool)
        for i, row in enumerate(group):
            plen = len(row.req.prompt)
            hi = min(plen, row.start + width)
            toks[i, :hi - row.start] = row.req.prompt[row.start:hi]
            frow = self._slot_rows[row.slot]
            nb_live = kvp.blocks_needed(hi, self.block_len)
            view_rows[i, :nb_live] = frow[:nb_live]
            full_rows[i] = frow
            slot_ids[i] = row.slot
            starts[i] = row.start
            pins[i] = plen if row.final else row.start + row.width
            lidx[i] = (plen - 1 - row.start) if row.final else 0
            valid[i] = True
        dev = self.device
        self.prefill_tokens += width * len(group)
        logits = self._prefill(
            self.params, self._caches,
            torch.from_numpy(toks).to(dev, torch.int64), slot_ids,
            torch.from_numpy(view_rows).to(dev), torch.from_numpy(full_rows).to(dev),
            torch.from_numpy(starts).to(dev), pins, lidx, valid)
        finals = [(i, row) for i, row in enumerate(group) if row.final]
        if finals:
            first = sp.greedy_tokens(logits).cpu().numpy()
            for i, row in finals:
                self._complete_prefill(row.req, row.slot, int(first[i]))

    def _prefill_phase(self) -> int:
        """This iteration's scheduled prefill rows, packed into dispatches of
        up to ``prefill_batch``; a group flushes before a wider groupmate
        would push any row past max_len. Returns the rows run."""
        rows = self.scheduler.plan(self._admit_slot)
        group: List[PrefillRow] = []
        gw = 0
        for row in rows:
            w = max(gw, row.width)
            if group and (len(group) >= self.prefill_batch or any(
                    r.start + w > self.max_len for r in group + [row])):
                self._dispatch_prefill(group)
                group, w = [], row.width
            group.append(row)
            gw = w
        if group:
            self._dispatch_prefill(group)
        return len(rows)

    # -- the loop ---------------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> int:
        """Prefill phase, then one batched decode over the occupied slots
        not mid-prefill (the others ride along, their outputs ignored).
        Returns the number of slots that advanced (or prefill rows run on a
        prefill-only iteration, which skips the decode); 0 means no work
        was done."""
        n_rows = self._prefill_phase()
        chunking = self.scheduler.chunking
        decodable = [s for s in range(self.slots)
                     if self._active[s] is not None and s not in chunking]
        if not decodable:
            if not n_rows and self._queue:
                raise RuntimeError(
                    f"request {self._queue[0].rid} can never be admitted")
            return n_rows
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
