"""Slot-based continuous batching over a dense or paged KV plane (port of
``repro/serve/engine.py``), for dense GQA models (with or without a QKV
bias), GQA/MoE and MLA/MoE ones (DeepSeek-V2-Lite: compressed-latent and
rope-key caches), and the recurrent families (xLSTM, Zamba2's Mamba2 with
its shared attention block), which serve on the dense plane only.

Every ``step()`` runs the iteration scheduler's prefill phase
(serve/scheduler.py: chunk continuations first, then FIFO admissions, under
a ``max_prefill_tokens`` budget), then ONE batched decode over all slots
(``make_decode_logits``) and the sampling tail. ``cfg.kv_impl``
picks the KV layout, as in the JAX engine:

``dense``  one max_len buffer per slot (``tf.init_cache``, float32 as the
    JAX engine allocates it). A prefill row runs alone, batch 1, in place
    in its slot's rows (``tf.take_slot`` is a view), where the JAX engine
    prefills a fresh batch-1 cache and inserts it at the final chunk; a
    mid-prefill slot's rows are its partial cache. The decode is one
    batch-``slots`` apply with per-row positions, where the JAX engine
    ``vmap``s a batch-1 decode; each row computes what its batch-1 decode
    does. A slot riding along in the decode (vacant or mid-prefill) writes
    its garbage at its own position, which the next prefill rewrites.
``paged``  a global pool of ``block_len``-position blocks per layer with
    per-slot block tables, the refcounted ``KVPager`` on the host (below).

Admission allocates the blocks a request can reach from the refcounted
``KVPager`` (paged); a request that does not fit waits at the queue head
(FIFO backpressure); ``submit`` rejects requests that can never be served.

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
    all-scratch rows. Defaults to ``slots`` when chunking on the paged
    plane, else 1, with or without the prefix cache. The dense plane
    prefills one row a dispatch, whatever R.

A recurrent scan has no mask to hide a pad tail, so an arch with a
recurrent block prefills each prompt at its exact length (``_bucketed``
false: the scheduler without buckets), starting from fresh state in its
slot's rows, as the JAX engine does; ``kv_impl="paged"``,
``prefill_chunk`` and the prefix cache are refused there with the JAX
engine's errors.

Prefill runs at the bucket (or chunk) width, pad tokens included, as the
JAX engine does: a GShard MoE layer's expert capacity follows the dispatch
width (models/moe.py), so another width, chunking or row count would route
differently; with the same knobs the port routes as the JAX engine does.

The paged plane has two options, as in the JAX engine, and the dense
plane refuses both, with the JAX engine's messages:
``kv_quant="int8" | "q2_14"`` stores the GQA pools as block-scaled codes
(core/kv_quant.py; MLA pools stay unquantized and reject it), and
``prefix_cache=True`` indexes full prompt blocks in a radix tree
(serve/prefix_cache.py): an admission whose prompt shares full blocks with
an earlier one binds those blocks into its table and prefills from the
first unshared block, pinned like a mid-chunk continuation.

A paged prefill of a model without MoE layers runs its matrix products
through the row-count-invariant kernel (kernels/gemm.py, the view's
``cm.INVARIANT``), cache on or off, chunked or not: cuBLAS picks its GEMM
kernel by the problem's shape, so on the card a position's K, V and logits
would otherwise depend on where its prefill started, how wide its row was
and how many rows shared its dispatch, and a shared block would not hold
the bytes its sharer would have written itself. With it, rows prefill
whole and several to a dispatch, and cache-on streams equal cache-off ones
on the card as on the CPU. A MoE model keeps torch's products: its routing
already follows the dispatch width, as in JAX. Decode steps and the dense
plane keep torch's products too.

Sampling (serve/sampling.py) is per request: each carries its own
``SamplingParams`` and draws token t from the key
fold_in(fold_in(PRNGKey(seed), rid), t) (t = 0 is the prefill's token), so
its tokens do not depend on its slot, its batch or the KV plane, and equal
the JAX engine's bit for bit. A batch whose rows are all greedy takes the
argmax alone (the JAX ``greedy_only`` variant); greedy rows take the
argmax of the raw logits either way.

Observability (repro_torch/obs): ``obs=Observability()`` (``trace=True``
for a Chrome trace) registers the metrics of ``docs/observability.md``
(``_bind_obs_handles``, ``KVPager.attach_metrics``); everything recorded
is host-side, so the tokens are the same with it on or off. The port
compiles nothing, so ``engine.compiles.prefill`` / ``.decode`` stay 0;
``engine.mesh.tp`` and ``.devices`` read the mesh's model axis and ranks
(1 and 1 without one). The spans time the host: on the card ``dispatch`` is
the enqueue of the apply's launches and ``host_sync`` the sampling tail and
the wait for the device, the copy of the step's tokens to the host; under
tensor parallelism ``host_sync`` waits for the rank's datapath and
``collective`` covers the rest: the logits gather, the sampling and the
tokens' copy.

``score(prompt)`` returns the teacher-forced log-probs of a prompt through
the log-softmax datapath of ``cfg.loss_impl`` (train/losses.py), as the
JAX engine's ``score``.

The caches, block tables and positions live on the device and are updated
in place (models/attention.py); the JAX engine's jitted pure functions
over donated caches have no counterpart, since PyTorch runs eagerly.

Tensor parallelism (``tp=N`` / ``mesh=``): one engine per rank of a
process group (launch/mesh.py ``run_ranks``), each over the rank's shard
of the weights (``params`` whole, cut here by distributed/sharding.py, or
a shard from ``tf.init(..., mesh=)``) and its slice of the KV plane: GQA
pools and buffers of (N, L, KH/tp, hd) when KH divides tp (the whole KH
else; scale pools follow their codes), MLA's latent pools whole. Every rank
runs the same host scheduler, pager and prefix cache over the same
requests (one block-id space: a rank holds a head slice of every block),
reduces its row-parallel partial sums and gathers the vocabulary-parallel
logits, so every rank samples the same tokens with the same keys. On the
decode kernel's path the heads must divide tp: KH (padded) for GQA, H
for MLA. The recurrent archs serve on the dense plane with each rank's
cut of their mixers (models/ssm.py, models/xlstm.py) and its slice of
their state (``state_bytes``); Zamba2's shared block is head-parallel as
the attention archs' blocks, its per-application KV buffers cut by KV
heads.

``cfg.kv_shard="seq_model"`` (a config field, as in JAX) cuts the dense
plane's positions instead of its KV heads where tp divides ``max_len``:
each rank's buffers hold ``max_len / tp`` positions of every KV head (MLA's
latent, Zamba2's shared block alike), and each attention step reduces its
softmax and P.V over the ranks (models/attention.py), so the tokens are tp
1's. Where tp does not divide ``max_len``, and on the paged plane, which
never reads the knob (as the JAX paged attend), the heads cut stays and
``engine.cfg.kv_shard`` reads "auto". A CORDIC softmax whose span is not
whole 32-lane windows is refused at init (``shd.resolve_kv_shard``). The
JAX engine itself has no partitioner at serving time, so it serves the
knob with the heads cut: the same tokens.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs as obs_lib
from repro_torch import resolve_device
from repro_torch.core import kv_quant as kvq
from repro_torch.distributed import sharding as shd
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.serve import kv_pager as kvp
from repro_torch.serve import prng
from repro_torch.serve import sampling as sp
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import IterationScheduler, PrefillRow


def make_bucketed_prefill_step(cfg) -> Callable:
    """Dense prefill of one bucket- or chunk-padded row (a recurrent arch's
    rows are exact-length: no pad token may reach its state) into its
    slot's rows (``cache``, a one-row view): a fresh row (``start`` 0)
    first resets the rows' recurrent state, so a request never sees the
    previous occupant's; positions start at ``start``, then the row is
    pinned to ``pin`` (the true length on a final row, the chunk frontier
    mid-prompt: the pad tail advanced it further) and the (1, V) logits at
    ``logit_idx`` come back."""
    def prefill(params, cache: tf.DenseCache, tokens, start: int, pin: int,
                logit_idx: int):
        if start == 0:
            cache.reset_state()
        tf.override_cache_length(cache, start)
        logits, _, _ = tf.apply(params, {"tokens": tokens}, cfg, cache=cache,
                                gather_logits=False)
        tf.override_cache_length(cache, pin)
        return gathered_logits(params, cfg, logits[:, logit_idx])
    return prefill


def gathered_logits(params, cfg, last):
    """(R, V) logits rows: a rank's vocabulary slice of them (a shard with
    a cut head) gathered over the model axis, so a prefill moves only the
    rows it returns; the rows as they are otherwise."""
    mesh = getattr(params, "mesh", None)
    if mesh is not None and last.shape[-1] < cfg.vocab_size:
        return shd.gather_vocab(last, cfg.vocab_size, mesh)
    return last


def make_prefill_step(cfg) -> Callable:
    """The JAX ``make_prefill_step``: a whole prompt at its exact length
    into fresh rows (recurrent state reset, positions 0); returns the
    (1, V) logits of its last position."""
    step = make_bucketed_prefill_step(cfg)

    def prefill(params, cache: tf.DenseCache, tokens):
        S = tokens.shape[1]
        return step(params, cache, tokens, 0, S, S - 1)
    return prefill


def make_paged_prefill_step(cfg) -> Callable:
    """R prefill rows straight into pool blocks, as ONE batch-R apply
    against the shared pools (the JAX ``make_paged_prefill_step``), its
    products the row-count-invariant kernel's on a model without MoE layers
    (``cm.INVARIANT``; module docstring).

    Per row r: tokens[r] (W,) the bucket/chunk-padded segment; view_rows[r]
    (M,) the block-table row the apply writes through (the slot's blocks up
    to the last one holding a position this row can see, scratch after: the
    tail-write trim; pad rows are all scratch); starts[r] the first
    position; then each valid row's slot gets full_rows[r] and its length
    pinned to pins[r] (the true length on a final row, the chunk frontier
    mid-prompt): the pad tail advanced the view's length past it. Pad rows
    (``valid`` false) register nothing, so a pad row aliasing a live slot
    id never clobbers it. ``slot_ids``, ``pins``, ``logit_idx`` and
    ``valid`` are host arrays. Returns the (R, V) logits rows at
    logit_idx."""
    products = (cm.LIBRARY if set(tf.MOE_KINDS) & set(cfg.block_pattern)
                else cm.INVARIANT)

    def prefill(params, cache: tf.PagedCache, tokens, slot_ids, view_rows,
                full_rows, starts, pins, logit_idx, valid):
        view = cache.view(view_rows, starts, products)
        logits, _, _ = tf.apply(params, {"tokens": tokens}, cfg, cache=view,
                                gather_logits=False)
        dev = cache.tables.device
        last = logits[torch.arange(len(logit_idx), device=logits.device),
                      torch.as_tensor(logit_idx, device=logits.device)]
        live = torch.as_tensor(np.flatnonzero(valid), device=dev)
        slots = torch.as_tensor(slot_ids[valid].astype(np.int64), device=dev)
        cache.tables[slots] = full_rows[live]
        cache.lens[slots] = torch.as_tensor(pins[valid], dtype=cache.lens.dtype,
                                            device=dev)
        return gathered_logits(params, cfg, last)
    return prefill


def _sample_step(last, rids, steps, temps, top_ks, greedy, base_key,
                 greedy_only: bool):
    """The sampling tail of a decode or a prefill: (S, V) logits -> (S,)
    int32 tokens on the logits' device. ``greedy_only`` is the argmax
    alone; greedy rows take the argmax of the raw logits in both, so which
    one runs never changes a token. The knobs are host tensors; the keys
    are derived on the host and copied with them."""
    if greedy_only:
        return sp.greedy_tokens(last)
    keys = sp.request_key(base_key, rids, steps)
    return sp.sample_batched(last, keys, temps, top_ks, greedy)


def make_decode_logits(cfg) -> Callable:
    """The decode apply (the JAX ``make_batched_decode_step`` and
    ``make_paged_decode_step`` without their sampling tail, which the
    engine runs as ``_sample_step``): a batch-``slots`` apply at per-row
    positions, tokens (S, 1) the previous token per slot -> the last
    position's (S, V) logits; under a mesh the rank's (S, V/tp) slice
    (the whole V with a tied or uncut head), which the engine gathers in
    its ``collective`` span. Vacant and mid-prefill slots' rows are
    garbage the engine ignores."""
    def decode(params, cache, tokens):
        logits, _, _ = tf.apply(params, {"tokens": tokens}, cfg, cache=cache,
                                gather_logits=False)
        return logits[:, -1]
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
    # lifecycle timestamps (time.perf_counter() seconds), stamped whether
    # observability is attached or not; -1 = not reached
    t_enqueue: float = dataclasses.field(default=-1.0, repr=False)
    t_admit: float = dataclasses.field(default=-1.0, repr=False)
    t_first: float = dataclasses.field(default=-1.0, repr=False)
    t_finish: float = dataclasses.field(default=-1.0, repr=False)


class ServeEngine:
    """Static batch of ``slots``; each holds one request. Admission pads the
    prompt to a length bucket (or, past ``prefill_chunk``, a first chunk)
    and prefills it into its slot's dense rows or freshly allocated pool
    blocks; the final prefill row emits the first token; every ``step()``
    advances all slots not mid-prefill with one batched decode. Finished
    slots release their blocks (paged) and are refilled from the queue,
    head first."""

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
                 obs: Optional[obs_lib.Observability] = None,
                 tp: Optional[int] = None, mesh=None,
                 device=None):
        assert cfg.input_mode == "tokens", "engine serves token LMs"
        self.obs = obs if obs is not None else obs_lib.NULL
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
        paged = self.kv_impl == "paged"
        if self.paged_attend_impl not in ("gather", "pallas"):
            raise ValueError(
                f"unknown paged_attend_impl {self.paged_attend_impl!r}")
        if self.paged_attend_impl == "pallas" and not paged:
            raise ValueError(
                "paged_attend_impl='pallas' selects the block-walking "
                "decode kernel over the paged KV plane; serve it with "
                "kv_impl='paged' (the dense plane has no block tables)")
        if self.paged_attend_impl == "pallas" and cfg.score_dtype != "f32":
            raise ValueError("paged_attend_impl='pallas' supports "
                             f"score_dtype='f32' only (got {cfg.score_dtype!r})")
        self.kv_quant = getattr(cfg, "kv_quant", "none")
        self._kv_quant_spec = kvq.spec_for(self.kv_quant)   # raises on a typo
        if self._kv_quant_spec is not None:
            if not paged:
                raise ValueError(
                    "kv_quant quantizes the paged block pools; serve it "
                    "with kv_impl='paged' (the dense plane stays full-"
                    f"width), got kv_impl={self.kv_impl!r}")
            if (getattr(cfg, "mla", None) is not None
                    or any(k.startswith("mla") for k in cfg.block_pattern)):
                raise ValueError(
                    "kv_quant applies to GQA paged pools only; MLA layers "
                    "store the compressed latent unquantized")
        # -- tensor parallelism (module docstring): tp=N resolves to a
        # ("data", "model") mesh over the process group; tp=1 builds none
        if mesh is None and tp is not None:
            from repro_torch.launch import mesh as mesh_lib

            mesh = mesh_lib.mesh_or_none(tp)
        self.mesh = mesh
        self.tp = mesh.tp if mesh is not None else 1
        if mesh is not None:
            if self.paged_attend_impl == "pallas":
                # the decode kernel attends a rank's own heads: no whole-KV
                # fallback on this path
                from repro_torch.models.attention import padded_heads

                if getattr(cfg, "mla", None) is not None:
                    n_heads, axis = cfg.num_heads, "num_heads"
                else:
                    n_heads, axis = padded_heads(cfg)[1], "kv heads (padded)"
                if n_heads % self.tp:
                    raise ValueError(
                        f"paged_attend_impl='pallas' shards attention heads "
                        f"over the model axis: {axis}={n_heads} is not "
                        f"divisible by tp={self.tp}")
        # kv_shard="seq_model": the dense plane's positions cut over the
        # model axis where tp divides max_len; the paged plane keeps the
        # heads cut (module docstring)
        cfg = self.cfg = shd.resolve_kv_shard(cfg, mesh, max_len, dense=not paged)
        self.default_sampling = (sampling if sampling is not None
                                 else SamplingParams(temperature=temperature,
                                                     greedy=greedy))
        #: PRNGKey(seed), on the host: the keys are derived there
        self._base_key = prng.threefry_seed(seed)
        if params.cfg.d_model != cfg.d_model:
            raise ValueError("params were built for another config")
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params live on {params.embed.device}, the "
                             f"engine runs on {self.device}")
        p_mesh = getattr(params, "mesh", None)
        if p_mesh is not None and (mesh is None or p_mesh.tp != self.tp):
            raise ValueError(f"params are a shard for tp={p_mesh.tp}, the "
                             f"engine serves tp={self.tp}")
        if mesh is not None and p_mesh is None:
            params = shd.shard_model(params, mesh)
        self.params = params
        #: GQA KV heads of this rank's pools and buffers
        self._kv_heads = shd.local_kv_heads(cfg, mesh)
        self.slots = slots
        self.max_len = max_len
        self.eos = eos_token
        self.buckets = kvp.bucket_lengths(max_len, self.block_len)
        # bucket padding is output-neutral for attention only: a recurrent
        # scan (mamba2 / xlstm) folds every pad token into its state, so
        # those archs prefill at exact length, dense plane only
        self._bucketed = tf.attention_only(cfg)
        self.scheduler = IterationScheduler(
            buckets=self.buckets if self._bucketed else None,
            block_len=self.block_len, max_len=max_len,
            prefill_chunk=prefill_chunk, max_prefill_tokens=max_prefill_tokens)
        if paged and not self._bucketed:
            blk_kinds = set(cfg.block_pattern) | {cfg.shared_block} - {None}
            raise ValueError(
                "paged KV requires an attention-cache-only arch "
                f"(block pattern {sorted(blk_kinds)} includes recurrent "
                "blocks); serve it with kv_impl='dense'")
        if prefix_cache and not paged:
            raise ValueError(
                "prefix_cache shares KV pool blocks through the block-"
                "table indirection; serve it with kv_impl='paged' (the "
                "dense plane has per-slot buffers, nothing to share)")
        if prefill_batch is None:
            prefill_batch = slots if prefill_chunk is not None and paged else 1
        if prefill_batch < 1:
            raise ValueError(f"prefill_batch must be >= 1, got {prefill_batch}")
        # the dense plane prefills one row a dispatch, as the JAX engine
        self.prefill_batch = int(prefill_batch) if paged else 1
        #: prompt positions served from shared prefix blocks, and prefill
        #: row widths dispatched (pad included)
        self.prefix_hit_tokens = 0
        self.prefill_tokens = 0
        if paged:
            if max_len % self.block_len:
                raise ValueError(f"max_len {max_len} not a multiple of "
                                 f"block_len {self.block_len}")
            self.max_blocks = max_len // self.block_len
            if num_blocks is None:
                num_blocks = slots * self.max_blocks + 1   # worst case + scratch
            self.pager: Optional[kvp.KVPager] = kvp.KVPager(
                num_blocks, self.block_len, slots)
            self.prefix = (PrefixCache(self.pager, self.block_len,
                                       policy=prefix_eviction)
                           if prefix_cache else None)
            # float32 pools, as the JAX engine allocates them: K/V per
            # kv-head for GQA (the attend casts them to cfg.dtype, the
            # kv_dtype seam; codes and scales under kv_quant), the
            # compressed latent and the rope key for MLA (already rounded
            # to cfg.dtype by the write)
            self._caches = tf.init_paged_cache(cfg, slots, num_blocks,
                                               self.block_len, self.max_blocks,
                                               torch.float32, device=self.device,
                                               kv_heads=self._kv_heads)
            # device bytes per block across layers, whatever the pools hold
            self.pager.block_bytes = self.kv_pool_bytes() // num_blocks
            self._prefill = make_paged_prefill_step(cfg)
        else:
            self.pager = None
            self.prefix = None
            # float32 buffers, as the JAX engine's stacked per-slot caches
            self._caches = tf.init_cache(cfg, slots, max_len, torch.float32,
                                         device=self.device,
                                         kv_heads=self._kv_heads, mesh=mesh)
            self._prefill = make_bucketed_prefill_step(cfg)
        self._decode_logits = make_decode_logits(cfg)
        self._score = make_score_step(cfg)
        self._done: List[Request] = []
        self._active: List[Optional[Request]] = [None] * slots
        self._slot_rows: Dict[int, np.ndarray] = {}
        self._next_tok = np.zeros((slots, 1), np.int32)
        # per-slot sampling state mirrored into the batched decode each step
        self._rids = np.zeros(slots, np.int64)
        self._steps = np.zeros(slots, np.int64)     # == len(req.out) per slot
        self._temps = np.ones(slots, np.float32)
        self._top_ks = np.zeros(slots, np.int64)
        self._greedy = np.ones(slots, bool)
        self._bind_obs_handles()

    # -- observability ----------------------------------------------------------
    def _bind_obs_handles(self) -> None:
        # handles into self.obs.metrics (null no-ops when obs is off); the
        # names, types and units are docs/observability.md's
        m = self.obs.metrics
        self._m_submitted = m.counter("engine.requests.submitted",
                                      unit="requests")
        self._m_rejected = m.counter("engine.requests.rejected",
                                     unit="requests")
        self._m_finished = m.counter("engine.requests.finished",
                                     unit="requests")
        self._m_pre_disp = m.counter("engine.prefill.dispatches",
                                     unit="calls")
        self._m_pre_rows = m.counter("engine.prefill.rows", unit="rows")
        self._m_pre_chunks = m.counter("engine.prefill.chunks", unit="rows")
        self._m_pre_tokens = m.counter("engine.prefill.tokens", unit="tokens")
        self._m_prefix_hits = m.counter("prefix.hit_tokens", unit="tokens")
        self._m_prefix_shared = m.gauge("prefix.blocks_shared",
                                        unit="blocks")
        self._m_blocks_saved = m.counter("kv.pool.blocks_saved",
                                         unit="blocks")
        self._m_tokens = m.counter("engine.tokens.emitted", unit="tokens")
        self._m_steps = m.counter("engine.steps", unit="steps")
        self._m_queue = m.gauge("engine.queue_depth", unit="requests")
        self._m_occ = m.gauge("engine.batch_occupancy", unit="slots")
        # constant per engine: set once so every snapshot records them
        self._m_mesh_tp = m.gauge("engine.mesh.tp", unit="shards")
        self._m_mesh_dev = m.gauge("engine.mesh.devices", unit="devices")
        self._m_mesh_tp.set(self.tp)
        self._m_mesh_dev.set(self.mesh.size if self.mesh is not None else 1)
        self._m_kvq_bits = m.gauge("kv.quant.code_bits", unit="bits")
        self._m_kvq_bpt = m.gauge("kv.quant.bytes_per_token", unit="bytes")
        spec = self._kv_quant_spec
        self._m_kvq_bits.set(spec.code_bits if spec is not None else 32)
        if self.pager is not None and self.pager.block_bytes:
            self._m_kvq_bpt.set(self.pager.block_bytes / self.block_len)
        self._m_ttft = m.histogram("engine.ttft_ms", unit="ms")
        self._m_tpot = m.histogram("engine.tpot_ms", unit="ms")
        self._m_e2e = m.histogram("engine.e2e_ms", unit="ms")
        self._m_prefill = m.histogram("engine.prefill_ms", unit="ms")
        self._m_step = m.histogram("engine.step_ms", unit="ms")
        # registered for the metric set's sake: the port compiles nothing,
        # so they stay 0
        m.counter("engine.compiles.prefill", unit="compiles")
        m.counter("engine.compiles.decode", unit="compiles")
        if self.pager is not None:
            self.pager.attach_metrics(m if self.obs.enabled else None)

    def attach_obs(self, obs: Optional[obs_lib.Observability]) -> None:
        """Attach (or replace, or with None detach) the observability
        handle mid-lifetime, e.g. after a warm-up pass. Metrics recorded so
        far stay in the previous handle's registry; requests queued before
        still reach the latency histograms (their stamps are absolute)."""
        self.obs = obs if obs is not None else obs_lib.NULL
        self._bind_obs_handles()

    def _obs_prefilled(self, req: Request, first: int) -> None:
        """Prefill-completion record: the prefill span (admit -> first
        token, chunk interleaving included), TTFT (enqueue -> first token,
        queueing included) and the first-token event. The time stamp is
        taken whether obs is attached or not."""
        now = time.perf_counter()
        req.t_first = now
        if not self.obs.enabled:
            return
        self._m_prefill.observe((now - req.t_admit) * 1e3)
        if req.t_enqueue >= 0:
            self._m_ttft.observe((now - req.t_enqueue) * 1e3)
        self._m_tokens.inc()
        self.obs.request_span("prefill", req.rid,
                              max(0.0, req.t_admit - self.obs.epoch))
        self.obs.request_event("first_token", req.rid, {"token": first})

    @property
    def _queue(self):
        return self.scheduler.queue

    @property
    def has_work(self) -> bool:
        """Queued or seated requests remain."""
        return bool(self._queue) or any(a is not None for a in self._active)

    def kv_pool_bytes(self) -> int:
        """Resident device bytes of the pools across layers: K/V (codes and
        scales under kv_quant), or MLA's latent and rope key. 0 on the
        dense plane, as the JAX engine's."""
        return self._caches.pool_bytes() if self.pager is not None else 0

    def kv_cache_bytes(self) -> int:
        """Resident device bytes of the KV plane: the pools (paged) or the
        per-slot buffers (dense)."""
        return (self._caches.pool_bytes() if self.pager is not None
                else self._caches.nbytes())

    def state_bytes(self) -> int:
        """Resident device bytes of this rank's recurrent state (Mamba2 /
        mLSTM / sLSTM layers of the dense plane; 0 for an attention-only
        arch): 1/tp of tp 1's under a cut, but for a Mamba2 layer's whole
        B / C conv columns (distributed/sharding.py)."""
        if self.pager is not None:
            return 0
        return sum(v.numel() * v.element_size() for c in self._caches.layers
                   if "idx" not in c for v in c.values())

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
                plan = pa.mla_plan(B, cfg.num_heads // self.tp, cfg.mla.kv_lora_rank,
                                   cfg.mla.qk_rope_dim, L, M)
            else:
                plan = pa.gqa_plan(B, self._kv_heads,
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
        if self.pager is not None:
            need = self._blocks_for(req)
            if need > self.pager.capacity:
                return (f"needs {need} KV blocks worst-case — admission "
                        f"budgets the unshared footprint, which with no "
                        f"prefix hit is the whole request — but the pool "
                        f"has {self.pager.capacity} allocatable")
        return None

    def submit(self, req: Request) -> None:
        """Validate and enqueue one request; inadmissible requests are
        rejected at once (``req.error`` set, ``done=True``)."""
        req.t_enqueue = time.perf_counter()
        err = self._validate(req)
        self._m_submitted.inc()
        if err is not None:
            req.error = f"rejected at submit: {err}"
            req.done = True
            self._m_rejected.inc()
            self.obs.request_event("reject", req.rid, {"reason": err})
            self._done.append(req)
            return
        # decode never writes past max_len
        req.max_new_tokens = min(req.max_new_tokens,
                                 self.max_len - len(req.prompt) + 1)
        self.obs.request_event("enqueue", req.rid,
                               {"prompt_len": len(req.prompt),
                                "max_new_tokens": req.max_new_tokens})
        self.scheduler.enqueue(req)

    def _blocks_for(self, req: Request) -> int:
        need_len = min(max(kvp.bucket_for(len(req.prompt), self.buckets),
                           len(req.prompt) + req.max_new_tokens),
                       self.max_len)
        return kvp.blocks_needed(need_len, self.block_len)

    def _admit_slot(self, req: Request):
        """Scheduler callback: a free slot (paged: with the request's blocks
        allocated), or None (no free slot, or pool backpressure). With the
        prefix cache on, only the unshared footprint is allocated: the
        matched blocks (pinned by ``match``) go first in the slot's table
        and the slot id comes back as ``(slot, start)``, prefill resuming
        at ``start``."""
        s = next((i for i in range(self.slots) if self._active[i] is None), None)
        if s is None:
            return None
        need, start = 0, 0
        if self.pager is not None:
            need_total = self._blocks_for(req)
            shared = []
            if self.prefix is not None:
                matched = self.prefix.match(req.prompt)
                start = self.scheduler.resume_start(
                    len(req.prompt), len(matched) * self.block_len)
                m_used = start // self.block_len
                if m_used < len(matched):    # the row geometry used fewer
                    self.pager.release(matched[m_used:])
                shared = matched[:m_used]
            need = need_total - len(shared)
            if self.prefix is not None and not self.pager.can_alloc(need):
                self.prefix.evict_until(need)
            blocks = self.pager.alloc(s, need, shared=shared)
            if blocks is None:
                if shared:                   # unwind the match pins
                    self.pager.release(shared)
                return None
            row = np.zeros(self.max_blocks, np.int32)
            row[:len(shared)] = shared
            row[len(shared):need_total] = blocks
            self._slot_rows[s] = row
            if start:
                self.prefix_hit_tokens += start
                self._m_prefix_hits.inc(start)
                self._m_blocks_saved.inc(len(shared))
            if self.prefix is not None:
                self._m_prefix_shared.set(self.pager.blocks_shared)
        self._active[s] = req
        req.t_admit = time.perf_counter()
        if self.obs.enabled:
            ev = {"slot": s}
            if self.pager is not None:
                ev["blocks"] = need
                if start:
                    ev["prefix_tokens"] = start
            self.obs.request_event("admit", req.rid, ev)
        return (s, start) if start else s

    def _release_slot(self, s: int) -> None:
        """Free the slot; paged, its blocks too, and point its table at
        scratch block 0, so a vacant slot never writes into reallocated
        blocks. Its sampling knobs go back to greedy, so a vacated sampled
        slot does not keep the decode off the argmax-only path."""
        self._active[s] = None
        self._slot_rows.pop(s, None)
        self.scheduler.drop_slot(s)
        if self.pager is not None:
            self.pager.free(s)
            if self.prefix is not None:
                self._m_prefix_shared.set(self.pager.blocks_shared)
            self._caches.tables[s] = 0
            self._caches.lens[s] = 0
        self._temps[s] = 1.0
        self._top_ks[s] = 0
        self._greedy[s] = True

    def _finish(self, req: Request) -> None:
        req.done = True
        req.t_finish = time.perf_counter()
        if self.obs.enabled:
            self._m_finished.inc()
            if req.t_enqueue >= 0:
                self._m_e2e.observe((req.t_finish - req.t_enqueue) * 1e3)
            if req.t_first >= 0 and len(req.out) > 1:
                # the mean decode interval after the first token
                self._m_tpot.observe((req.t_finish - req.t_first)
                                     / (len(req.out) - 1) * 1e3)
            self.obs.request_event("finish", req.rid, {"tokens": len(req.out)})
        self._done.append(req)

    def _sample_first(self, logits: torch.Tensor, reqs: List[Request]) -> np.ndarray:
        """The prefill-emitted tokens (step 0 of each request's key stream)
        of the (R, V) logits rows of ``reqs``, each with its own
        SamplingParams."""
        knobs = [(r.sampling or self.default_sampling).resolved() for r in reqs]
        greedy = torch.tensor([g for _, _, g in knobs])
        toks = _sample_step(
            logits, torch.tensor([r.rid for r in reqs], dtype=torch.int64),
            torch.zeros(len(reqs), dtype=torch.int64),
            torch.tensor([t for t, _, _ in knobs], dtype=torch.float32),
            torch.tensor([k for _, k, _ in knobs], dtype=torch.int64), greedy,
            self._base_key, bool(greedy.all()))
        return toks.cpu().numpy()

    def _complete_prefill(self, req: Request, s: int, first: int) -> None:
        """A final prefill row landed with its first token: the slot joins
        the decode next iteration (or frees at once on eos / a budget of
        one); with the prefix cache on, the prompt's full blocks become
        shareable."""
        self._obs_prefilled(req, first)
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
            return
        self._next_tok[s, 0] = first
        temp, top_k, greedy = (req.sampling or self.default_sampling).resolved()
        self._rids[s] = req.rid
        self._steps[s] = len(req.out)
        self._temps[s] = temp
        self._top_ks[s] = top_k
        self._greedy[s] = greedy

    def _dispatch_prefill(self, group: List[PrefillRow]) -> None:
        """One prefill dispatch of the scheduled rows ``group``: one
        multi-row paged dispatch, or on the dense plane a single row."""
        self._m_pre_disp.inc()
        if self.pager is None:
            (row,) = group
            self._dispatch_prefill_dense(row)
        else:
            self._dispatch_prefill_paged(group)

    def _dispatch_prefill_dense(self, row: PrefillRow) -> None:
        """One dense prefill row into its slot's rows: a fresh row starts at
        position 0, a chunk continuation at its frontier; mid-prefill the
        rows hold the partial cache, which no decode reads."""
        req, s = row.req, row.slot
        plen = len(req.prompt)
        toks = np.zeros((1, row.width), np.int64)
        hi = min(plen, row.start + row.width)
        toks[0, :hi - row.start] = req.prompt[row.start:hi]
        pin = plen if row.final else row.start + row.width
        li = (plen - 1 - row.start) if row.final else row.width - 1
        self.prefill_tokens += row.width
        logits = self._prefill(self.params, tf.take_slot(self._caches, s),
                               torch.from_numpy(toks).to(self.device),
                               row.start, pin, li)
        if row.final:
            self._complete_prefill(req, s, int(self._sample_first(logits, [req])[0]))

    def _dispatch_prefill_paged(self, group: List[PrefillRow]) -> None:
        """One multi-row prefill over up to ``prefill_batch`` scheduled rows,
        padded to a power of two with all-scratch rows, at the group's
        widest row."""
        rp = 1
        while rp < len(group):
            rp *= 2
        width = max(r.width for r in group)
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
            rows = torch.as_tensor([i for i, _ in finals], device=dev)
            first = self._sample_first(logits[rows], [row.req for _, row in finals])
            for (_, row), tok in zip(finals, first):
                self._complete_prefill(row.req, row.slot, int(tok))

    def _prefill_phase(self) -> int:
        """This iteration's scheduled prefill rows, packed into dispatches of
        up to ``prefill_batch``; a group flushes before a wider groupmate
        would push any row past max_len. Returns the rows run."""
        rows = self.scheduler.plan(self._admit_slot)
        if not rows:
            return 0
        self._m_pre_rows.inc(len(rows))
        self._m_pre_tokens.inc(sum(r.width for r in rows))
        n_chunked = sum(1 for r in rows if not (r.fresh and r.final))
        if n_chunked:
            self._m_pre_chunks.inc(n_chunked)
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
        was done. The phase spans (``admit``, ``dispatch``, ``host_sync``,
        ``sample_copy``) are the JAX engine's."""
        ob = self.obs
        t_step = time.perf_counter()
        self._m_steps.inc()
        self._m_queue.set(len(self._queue))     # backlog before admission
        with ob.phase("admit"):
            n_rows = self._prefill_phase()
        chunking = self.scheduler.chunking
        decodable = [s for s in range(self.slots)
                     if self._active[s] is not None and s not in chunking]
        self._m_occ.set(len(decodable))
        if ob.trace is not None:
            ob.trace.counter("engine.load", ob.now_us(),
                             {"queue_depth": len(self._queue),
                              "batch_occupancy": len(decodable)})
        if not decodable:
            if not n_rows and self._queue:
                raise RuntimeError(
                    f"request {self._queue[0].rid} can never be admitted")
            if n_rows and ob.enabled:
                self._m_step.observe((time.perf_counter() - t_step) * 1e3)
            return n_rows
        # dispatch: the apply's launches queued; host_sync: the sampling
        # tail and the copy of its tokens, where the host waits for the device
        greedy_only = bool(self._greedy.all())
        knobs = (torch.from_numpy(self._rids), torch.from_numpy(self._steps),
                 torch.from_numpy(self._temps), torch.from_numpy(self._top_ks),
                 torch.from_numpy(self._greedy), self._base_key)
        tokens = torch.from_numpy(self._next_tok).to(self.device, torch.int64)
        with ob.phase("dispatch"):
            last = self._decode_logits(self.params, self._caches, tokens)
        if self.mesh is not None:
            # host_sync waits for the rank's datapath (its row-parallel
            # reductions included); collective covers the logits gather,
            # the sampling and the tokens' copy
            with ob.phase("host_sync"):
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        with ob.phase("host_sync" if self.mesh is None else "collective"):
            if last.shape[-1] < self.cfg.vocab_size:
                last = shd.gather_vocab(last, self.cfg.vocab_size, self.mesh)
            nxt = _sample_step(last, *knobs, greedy_only).cpu().numpy()
        with ob.phase("sample_copy"):
            for s in decodable:
                req = self._active[s]
                tok = int(nxt[s])
                req.out.append(tok)
                self._next_tok[s, 0] = tok
                self._steps[s] = len(req.out)
                ob.request_event("token", req.rid,
                                 {"step": len(req.out), "token": tok})
                if (self.eos is not None and tok == self.eos) or \
                        len(req.out) >= req.max_new_tokens:
                    self._finish(req)
                    self._release_slot(s)
        if ob.enabled:
            self._m_tokens.inc(len(decodable))
            self._m_step.observe((time.perf_counter() - t_step) * 1e3)
        return len(decodable)

    def run(self) -> List[Request]:
        """Serve until queue and slots drain; returns every submitted
        request in completion order (rejected ones included)."""
        while self.has_work:
            self.step()
        done, self._done = self._done, []
        return done
