"""Radix-tree prefix cache over the paged KV pool (a copy of
``repro/serve/prefix_cache.py``; pure Python).

Production traffic is dominated by shared prefixes — system prompts,
few-shot templates, multi-turn history — so most prefill FLOPs and KV
pool blocks are redundant recomputations of byte-identical K/V. The
block-table indirection (serve/kv_pager.py) already lets two slots point
at the same pool block; this module supplies the *index* that finds the
reusable blocks and the refcount discipline that keeps them alive:

``PrefixCache``
    A radix tree keyed on token ids at **block granularity**: every edge
    carries one or more whole blocks, each a ``(block_len,)`` token tuple
    paired with the pool block id holding that span's K/V. Only blocks
    completely filled by *prompt* tokens are indexed — a partially-filled
    tail block also receives decode writes, so it is never shareable
    (sharing stops at the last full prompt block; the divergent /
    partially-filled block is where copy-on-write happens: the new
    request recomputes it into a fresh block instead of writing into the
    shared one).

Lifecycle contract with ``KVPager``:

* ``insert`` retains each block it newly indexes — the cache holds its
  own reference, so an indexed block survives the owning slot's
  ``free``.
* ``match`` retains each matched block *before* returning it, so the hit
  cannot be evicted (or freed by the lender finishing) between match and
  admission. The engine hands the matched prefix to
  ``KVPager.alloc(slot, n, shared=...)`` — the match pin transfers to
  the slot — and releases any matched blocks it decides not to bind.
* ``match`` never returns the whole prompt: hits are capped at
  ``(plen - 1) // block_len`` blocks so at least one prompt token is
  always prefilled and the logits that emit the first token exist.
* Eviction (``evict_until``) walks refcount-one radix leaves — blocks
  only the cache still references — in LRU (default) or FIFO order,
  releasing from each edge's tail inward. Blocks still bound by a live
  slot (refcount >= 2) are never touched.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.serve import kv_pager as kvp

EVICTION_POLICIES = ("lru", "fifo")


class _Node:
    """One radix edge: parallel lists of per-block token keys and the
    pool block ids holding their K/V."""
    __slots__ = ("keys", "blocks", "children", "parent", "last_used",
                 "created")

    def __init__(self, keys, blocks, parent, clock):
        self.keys: List[Tuple[int, ...]] = list(keys)
        self.blocks: List[int] = list(blocks)
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent: Optional["_Node"] = parent
        self.last_used = clock
        self.created = clock


class PrefixCache:
    """Block-granular radix index of prompt-token prefixes -> pool blocks.

    ``pager`` is the refcounted allocator the indexed blocks live in;
    ``block_len`` must match the pager's. ``policy`` picks the eviction
    order over refcount-one leaves: ``"lru"`` (least-recently matched
    first, the default) or ``"fifo"`` (oldest-inserted first).
    """

    def __init__(self, pager: kvp.KVPager, block_len: int,
                 policy: str = "lru"):
        if policy not in EVICTION_POLICIES:
            raise ValueError(f"unknown eviction policy {policy!r}; "
                             f"choose from {EVICTION_POLICIES}")
        if block_len != pager.block_len:
            raise ValueError(f"block_len {block_len} != pager block_len "
                             f"{pager.block_len}")
        self.pager = pager
        self.block_len = block_len
        self.policy = policy
        self._root = _Node((), (), None, 0)
        self._clock = 0
        self.hits = 0            # match() calls returning >= 1 block
        self.hit_blocks = 0      # total blocks returned by match()
        self.evicted_blocks = 0  # blocks released by evict_until()

    # -- helpers ------------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _block_keys(self, tokens, nblocks: int) -> List[Tuple[int, ...]]:
        B = self.block_len
        return [tuple(int(t) for t in tokens[i * B:(i + 1) * B])
                for i in range(nblocks)]

    @property
    def num_blocks(self) -> int:
        """Blocks currently indexed (each holds one cache reference)."""
        total = 0
        stack = [self._root]
        while stack:
            n = stack.pop()
            total += len(n.blocks)
            stack.extend(n.children.values())
        return total

    # -- match --------------------------------------------------------------
    def match(self, tokens) -> List[int]:
        """Longest indexed block-prefix of ``tokens``, pinned.

        Returns the pool block ids (table order), each retained once on
        the caller's behalf; capped at ``(len(tokens) - 1) // block_len``
        blocks so at least one token is left to prefill. The caller must
        either transfer every pin into a slot (``alloc(..., shared=)``)
        or release it.
        """
        cap = max(0, (len(tokens) - 1) // self.block_len)
        keys = self._block_keys(tokens, cap)
        out: List[int] = []
        node = self._root
        now = self._tick()
        i = 0
        while i < len(keys):
            child = node.children.get(keys[i])
            if child is None:
                break
            child.last_used = now
            k = 0
            while (k < len(child.keys) and i + k < len(keys)
                   and child.keys[k] == keys[i + k]):
                out.append(child.blocks[k])
                k += 1
            i += k
            if k < len(child.keys):
                break                     # stopped mid-edge
            node = child
        if out:
            self.pager.retain(out)
            self.hits += 1
            self.hit_blocks += len(out)
        return out

    # -- insert -------------------------------------------------------------
    def insert(self, tokens, blocks) -> int:
        """Index the full prompt blocks of ``tokens`` backed by ``blocks``.

        ``blocks`` is the owning slot's block-table prefix; only the
        first ``len(tokens) // block_len`` entries (blocks completely
        filled by prompt tokens) are considered. Where the tree already
        indexes a key, the existing pool block wins — the duplicate stays
        owned solely by its slot. Newly indexed blocks are retained once
        (the cache's own reference). Returns how many blocks were newly
        indexed.
        """
        nfull = len(tokens) // self.block_len
        nfull = min(nfull, len(blocks))
        if nfull == 0:
            return 0
        keys = self._block_keys(tokens, nfull)
        node = self._root
        now = self._tick()
        i = 0
        while i < len(keys):
            child = node.children.get(keys[i])
            if child is None:
                fresh = list(blocks[i:nfull])
                new = _Node(keys[i:], fresh, node, now)
                node.children[keys[i]] = new
                self.pager.retain(fresh)
                return len(fresh)
            child.last_used = now
            k = 0
            while (k < len(child.keys) and i + k < len(keys)
                   and child.keys[k] == keys[i + k]):
                k += 1
            i += k
            if k < len(child.keys):
                if i >= len(keys):
                    return 0              # new prefix ends inside the edge
                self._split(child, k)     # diverged mid-edge
                node = child
            else:
                node = child
        return 0

    def _split(self, node: _Node, k: int) -> None:
        """Split ``node``'s edge after its first ``k`` blocks: ``node``
        keeps the shared prefix, the tail moves to a new child."""
        tail = _Node(node.keys[k:], node.blocks[k:], node, node.created)
        tail.last_used = node.last_used
        tail.children = node.children
        for c in tail.children.values():
            c.parent = tail
        node.keys = node.keys[:k]
        node.blocks = node.blocks[:k]
        node.children = {tail.keys[0]: tail}

    # -- eviction -----------------------------------------------------------
    def _leaves(self) -> List[_Node]:
        out = []
        stack = [self._root]
        while stack:
            n = stack.pop()
            if n is not self._root and not n.children:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def _evictable_tail(self, leaf: _Node) -> int:
        """How many blocks at the edge's tail only the cache references."""
        n = 0
        for b in reversed(leaf.blocks):
            if self.pager.refcount(b) != 1:
                break
            n += 1
        return n

    def evict_until(self, n: int) -> bool:
        """Evict refcount-one leaves until the pool can allocate ``n``
        fresh blocks. Returns True on success, False when nothing more is
        evictable (the request falls back to ordinary backpressure)."""
        while not self.pager.can_alloc(n):
            order = (lambda lf: lf.created) if self.policy == "fifo" \
                else (lambda lf: lf.last_used)
            victim = None
            for leaf in sorted(self._leaves(), key=order):
                if self._evictable_tail(leaf) > 0:
                    victim = leaf
                    break
            if victim is None:
                return False
            drop = self._evictable_tail(victim)
            dead = victim.blocks[len(victim.blocks) - drop:]
            del victim.keys[len(victim.keys) - drop:]
            del victim.blocks[len(victim.blocks) - drop:]
            self.pager.release(dead)
            self.evicted_blocks += len(dead)
            if not victim.keys:
                parent = victim.parent
                for key, c in list(parent.children.items()):
                    if c is victim:
                        del parent.children[key]
                        break
        return True

    def clear(self) -> int:
        """Drop the whole index, releasing every cache reference.
        Returns how many blocks were released."""
        released = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node.blocks:
                self.pager.release(node.blocks)
                released += len(node.blocks)
        self._root = _Node((), (), None, self._clock)
        return released
