"""Block-paged KV cache with hash-based prefix reuse.

Counterpart of ``horovod_tpu/serve/kv_cache.py``, copied (host code).

The serving fast path's memory manager, owned by the batcher. The same
idea as the engine's fusion buffer — amortize a fixed cost across many
small units — applied to prefill compute and cache memory:

- **fixed-size blocks**: the per-request cache is a *block table* (a list
  of block ids), each block covering ``HOROVOD_SERVE_KV_BLOCK_TOKENS``
  token positions. A block's payload is the model state checkpoint at the
  block's end boundary (for the attention models the blocks would hold
  K/V pages; the executor's cached-step contract only ever needs the
  boundary checkpoint, which is what makes eviction and sharing exact);
- **bounded pool, charged at admission**: :meth:`PagedKVCache.admit`
  charges the worst-case block count (prompt + token budget, minus any
  shared prefix blocks already resident) against
  ``HOROVOD_SERVE_KV_POOL_BLOCKS``. A request that cannot get blocks is
  rejected *now* (429-shaped :class:`CacheExhausted` — backpressure, not
  an OOM twenty steps later). Charged-but-queued requests own capacity
  only; physical block ids are bound lazily by the decode loop, so a
  request that expires in the queue provably never allocated;
- **hash-based prefix reuse (CoW)**: full prompt blocks are content-
  hashed; the first request to prefill a prefix publishes its boundary
  checkpoints as *shared* blocks, and later admissions with the same
  prefix incref them instead of charging new blocks — a thousand requests
  with the same system prompt pay prefill once. Shared blocks are
  refcounted and never written after publication (copy-on-write: a
  request's own generated tokens always land in private blocks);
- **LRU eviction over finished/expired**: a shared block whose refcount
  drops to zero stays resident as reuse capital and joins an LRU list;
  admission evicts LRU zero-ref blocks when the free pool alone cannot
  cover a charge. Live requests (refcount > 0) are never evicted — the
  no-use-after-free rule the reference's ``verify.specs.PagedCacheSpec``
  model-checks.

Accounting invariant (the spec's conservation law, also asserted by the
churn regression test)::

    pool_blocks == free + charged(private) + resident(shared)

at every step boundary — across queued expiry, running expiry (freed at
the boundary where the partial output is returned), drain, and a chaos
kill of the serving worker.

All gauges/counters land in ``hvd_serve_cache_*``, which ``GET /stats``
reads.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from horovod_tpu_torch.common.env import env_bool, env_int
from horovod_tpu_torch.metrics.registry import MetricsRegistry, get_registry
from horovod_tpu_torch.obs.tracing import CACHE_LOOKUP, get_tracer


class CacheExhausted(RuntimeError):
    """The bounded block pool cannot cover an admission charge even after
    evicting every zero-ref shared block — 429-shaped backpressure; the
    caller sheds or retries elsewhere, nobody OOMs mid-decode."""


def blocks_for(tokens: int, block_tokens: int) -> int:
    """Blocks needed to cover ``tokens`` positions (ceil division)."""
    return max(0, (int(tokens) + block_tokens - 1) // block_tokens)


def prefix_hash(tokens: Sequence[int], parent: str = "") -> str:
    """Content hash of one full prefix block, chained through its parent
    block's hash — so a block is only ever shared between requests whose
    *entire* prefix up to that boundary is identical, not merely the
    block's own span."""
    h = hashlib.sha256(parent.encode())
    h.update(np.asarray(list(tokens), np.int64).tobytes())
    return h.hexdigest()[:24]


class _Block:
    """One pool block. ``hash`` is None for private (single-owner) blocks
    and the chained content hash for shared prefix blocks; ``state`` is
    the model-state checkpoint at the block's end boundary."""

    __slots__ = ("id", "hash", "refs", "state")

    def __init__(self, block_id: int):
        self.id = block_id
        self.hash: Optional[str] = None
        self.refs = 0
        self.state: Optional[np.ndarray] = None


class CacheLease:
    """A request's slice of the pool, created at admission.

    ``charged`` blocks of capacity are owned from :meth:`PagedKVCache.admit`
    until exactly one of :meth:`PagedKVCache.release` (never ran) or
    :meth:`PagedKVCache.free` (ran). ``shared`` lists the increfed resident
    prefix blocks; ``table`` is the private block table, bound lazily by
    the decode loop as the sequence crosses block boundaries (a queued
    request's table is always empty — the expiry-split invariant).
    """

    __slots__ = ("charged", "shared", "table", "prefix_state",
                 "prefix_covered", "state", "state_len", "draft_state",
                 "draft_len", "closed")

    def __init__(self, charged: int, shared: List[_Block],
                 prefix_state: Optional[np.ndarray], prefix_covered: int):
        self.charged = int(charged)
        self.shared = shared                  # increfed shared blocks
        self.table: List[int] = []            # bound private block ids
        self.prefix_state = prefix_state      # checkpoint to resume from
        self.prefix_covered = int(prefix_covered)  # tokens it covers
        # decode-loop scratch (single consumer thread): current model
        # state + how many tokens it covers, plus the draft model's twin
        self.state: Optional[np.ndarray] = None
        self.state_len = 0
        self.draft_state: Optional[np.ndarray] = None
        self.draft_len = 0
        self.closed = False

    @property
    def bound(self) -> int:
        return len(self.table)


class PagedKVCache:
    """Bounded block pool + shared-prefix hash table.

    Thread contract mirrors the batcher's: any producer thread calls
    :meth:`admit` / :meth:`release` (both take the internal lock); the
    single decode-loop consumer calls :meth:`bind`, :meth:`publish` and
    :meth:`free`.
    """

    def __init__(self, block_tokens: Optional[int] = None,
                 pool_blocks: Optional[int] = None,
                 prefix_reuse: Optional[bool] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.block_tokens = block_tokens if block_tokens is not None \
            else env_int("HOROVOD_SERVE_KV_BLOCK_TOKENS")
        self.pool_blocks = pool_blocks if pool_blocks is not None \
            else env_int("HOROVOD_SERVE_KV_POOL_BLOCKS")
        self.prefix_reuse = prefix_reuse if prefix_reuse is not None \
            else env_bool("HOROVOD_SERVE_PREFIX_REUSE")
        if self.block_tokens < 1 or self.pool_blocks < 1:
            raise ValueError("block_tokens and pool_blocks must be >= 1")
        self._lock = threading.Lock()
        self._free = int(self.pool_blocks)
        self._charged = 0                      # private capacity held
        self._next_id = 0
        # shared prefix blocks: chained hash -> block; LRU order over
        # zero-ref residents (front = oldest = first evicted)
        self._shared: Dict[str, _Block] = {}
        self._lru: List[str] = []
        reg = registry if registry is not None else get_registry()
        self._g_pool = reg.gauge("hvd_serve_cache_pool_blocks")
        self._g_pool.set(self.pool_blocks)
        self._g_used = reg.gauge("hvd_serve_cache_blocks_used")
        self._g_shared = reg.gauge("hvd_serve_cache_shared_blocks")
        self._c_lookups = reg.counter("hvd_serve_cache_lookups_total")
        self._c_hits = reg.counter("hvd_serve_cache_hits_total")
        self._c_reuse = reg.counter("hvd_serve_cache_reuse_total")
        self._c_evict = reg.counter("hvd_serve_cache_evictions_total")
        self._c_exhausted = reg.counter("hvd_serve_cache_exhausted_total")
        self._c_saved = reg.counter(
            "hvd_serve_cache_prefill_tokens_saved_total")

    # -- introspection --------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {"pool_blocks": self.pool_blocks, "free": self._free,
                    "charged": self._charged,
                    "shared_resident": len(self._shared),
                    "evictable": len(self._lru)}

    def balanced(self) -> bool:
        """The conservation law — True at every quiescent point."""
        with self._lock:
            return self._free + self._charged + len(self._shared) \
                == self.pool_blocks

    def _set_gauges_locked(self):
        self._g_used.set(self._charged + len(self._shared))
        self._g_shared.set(len(self._shared))

    # -- admission (producer side) --------------------------------------------

    def _prefix_blocks(self, tokens: Sequence[int]) -> List[Tuple[str,
                                                                  tuple]]:
        """(chained hash, block tokens) for each FULL block of the prompt
        — partial tail blocks are never shared (their boundary checkpoint
        does not exist)."""
        out = []
        parent = ""
        bt = self.block_tokens
        for i in range(len(tokens) // bt):
            chunk = tuple(int(t) for t in tokens[i * bt:(i + 1) * bt])
            parent = prefix_hash(chunk, parent)
            out.append((parent, chunk))
        return out

    def admit(self, tokens: Sequence[int], budget: int,
              trace: Optional[str] = None) -> CacheLease:
        """Charge the pool for a request (prompt + ``budget`` generated
        tokens) or raise :class:`CacheExhausted`.

        Resident shared prefix blocks are increfed instead of charged —
        the prefix-reuse capacity win. Eviction of zero-ref LRU blocks
        happens here, only when the free pool alone cannot cover.
        ``trace`` (a sampled trace id) emits the ``cache_lookup`` span
        covering the prefix-hash walk + pool charge."""
        with get_tracer().span(trace, CACHE_LOOKUP, "kv_cache") as sp:
            lease = self._admit(tokens, budget)
            if trace is not None:
                sp.args = dict(sp.args, charged=lease.charged,
                               shared_hits=len(lease.shared),
                               prefix_covered=lease.prefix_covered)
            return lease

    def _admit(self, tokens: Sequence[int], budget: int) -> CacheLease:
        total = blocks_for(len(tokens) + int(budget), self.block_tokens)
        with self._lock:
            shared: List[_Block] = []
            prefix_state: Optional[np.ndarray] = None
            covered = 0
            if self.prefix_reuse:
                for h, _chunk in self._prefix_blocks(tokens):
                    self._c_lookups.inc()
                    blk = self._shared.get(h)
                    if blk is None or blk.state is None:
                        break  # chained: a miss ends the shared run
                    self._c_hits.inc()
                    shared.append(blk)
                # the decode loop always recomputes at least the final
                # prompt position (it needs the prediction *after* the
                # prompt) — an exactly block-aligned prompt drops its
                # last shared block rather than resume past the end
                while shared and \
                        len(shared) * self.block_tokens >= len(tokens):
                    shared.pop()
                for blk in shared:
                    if blk.refs == 0 and blk.hash in self._lru:
                        self._lru.remove(blk.hash)
                    blk.refs += 1
                    self._c_reuse.inc()
                if shared:
                    prefix_state = shared[-1].state
                    covered = len(shared) * self.block_tokens
            need = total - len(shared)
            while self._free < need and self._lru:
                self._evict_locked()
            if self._free < need:
                for blk in shared:  # undo the increfs — nothing leaks
                    blk.refs -= 1
                    if blk.refs == 0:
                        self._lru.append(blk.hash)
                self._c_exhausted.inc()
                raise CacheExhausted(
                    f"kv cache pool exhausted: need {need} blocks, "
                    f"{self._free} free of {self.pool_blocks} "
                    f"(backpressure)")
            self._free -= need
            self._charged += need
            if covered:
                self._c_saved.inc(covered)
            self._set_gauges_locked()
            return CacheLease(need, shared, prefix_state, covered)

    def _evict_locked(self):
        h = self._lru.pop(0)
        blk = self._shared.pop(h)
        assert blk.refs == 0
        blk.state = None  # the use-after-free tripwire: a stale table
        blk.hash = None   # entry now holds a dead block
        self._free += 1
        self._c_evict.inc()

    def release(self, lease: CacheLease):
        """Undo an admission that never ran (queued expiry / shed): return
        the charge, decref shared. The lease provably never bound a block
        (``lease.table`` is empty) — the expiry-split invariant."""
        self._close(lease, ran=False)

    # -- decode loop (consumer side) ------------------------------------------

    def bind(self, lease: CacheLease, covered_tokens: int,
             state: Optional[np.ndarray] = None):
        """Bind private block ids for every newly crossed block boundary,
        checkpointing ``state`` into the newest block. Capacity was
        already charged at admission, so this never blocks and never
        fails — it just turns owned capacity into table entries."""
        want = blocks_for(covered_tokens, self.block_tokens) - \
            len(lease.shared)
        with self._lock:
            while lease.bound < want:
                if lease.bound >= lease.charged:
                    # deadline-capped requests can out-generate their
                    # charge estimate only if budget accounting broke;
                    # fail loudly rather than corrupt the pool
                    raise RuntimeError(
                        "block table outgrew the admission charge "
                        f"({lease.charged} blocks)")
                self._next_id += 1
                lease.table.append(self._next_id)
        if state is not None:
            lease.state = state

    def publish(self, lease: CacheLease, tokens: Sequence[int],
                boundary_states: Dict[int, np.ndarray]):
        """Publish the prompt's full-block boundary checkpoints as shared
        CoW blocks (``boundary_states``: tokens-covered -> state).

        The publisher's private blocks covering those boundaries convert
        to shared: its charge shrinks, the shared population grows, pool
        conservation holds exactly. Later admissions with the same prefix
        incref instead of charging. First writer wins — a concurrent
        publisher of the same hash just keeps its private blocks."""
        if not self.prefix_reuse:
            return
        with self._lock:
            converted = 0
            for i, (h, _chunk) in enumerate(self._prefix_blocks(tokens)):
                end = (i + 1) * self.block_tokens
                if end <= lease.prefix_covered:
                    continue  # resumed from this shared block already
                st = boundary_states.get(end)
                if st is None or h in self._shared:
                    continue
                # the shared block takes over the publisher's private
                # block id for this boundary when one is bound (the
                # page itself converts — CoW, not a copy), else a fresh
                # id (the publisher resumed partway and never bound it)
                if converted < len(lease.table):
                    blk = _Block(lease.table[converted])
                else:
                    self._next_id += 1
                    blk = _Block(self._next_id)
                blk.hash = h
                blk.refs = 1
                blk.state = np.array(st, copy=True)
                self._shared[h] = blk
                lease.shared.append(blk)
                converted += 1
            if converted:
                # the converted capacity moves from this lease's private
                # charge to the shared population
                take = min(converted, lease.charged)
                lease.charged -= take
                self._charged -= take
                extra = converted - take
                if extra > 0:
                    # cannot happen under charge accounting; guard the
                    # conservation law anyway
                    self._free -= extra
                del lease.table[:min(converted, len(lease.table))]
                self._set_gauges_locked()

    def free(self, lease: CacheLease):
        """Free a request that ran: private blocks return to the pool at
        the step boundary where its output (full or partial) is returned;
        shared blocks decref, and zero-ref shared blocks stay resident on
        the LRU as reuse capital."""
        self._close(lease, ran=True)

    def _close(self, lease: CacheLease, ran: bool):
        with self._lock:
            if lease.closed:
                # double-free is the PagedCacheSpec mutant class; the
                # runtime guards it idempotently AND loudly in debug
                return
            if not ran and lease.table:
                # raised BEFORE marking closed: the caller's bug must
                # stay loud, but a later free() can still settle the
                # charge instead of leaking it
                raise RuntimeError(
                    "queued request bound blocks without running "
                    "(expiry-split violation)")
            lease.closed = True
            self._free += lease.charged
            self._charged -= lease.charged
            lease.charged = 0
            lease.table.clear()
            for blk in lease.shared:
                blk.refs -= 1
                if blk.refs == 0 and blk.hash is not None:
                    self._lru.append(blk.hash)
            lease.shared = []
            lease.state = None
            lease.draft_state = None
            self._set_gauges_locked()
