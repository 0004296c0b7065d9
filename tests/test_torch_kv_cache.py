"""The port's block-paged KV cache (horovod_tpu_torch/serve/kv_cache.py),
case for case the reference's tests/test_kv_cache.py: the charge/bind
two-phase accounting, content-hashed CoW prefix sharing, LRU eviction,
exhaustion backpressure, and the conservation invariant ``pool == free +
charged + resident_shared``; then the port and the reference driven in
lockstep through one admission/publish/free script, their stats equal
after every operation."""

import numpy as np
import pytest

from horovod_tpu_torch.metrics.registry import MetricsRegistry
from horovod_tpu_torch.serve.kv_cache import (CacheExhausted, PagedKVCache,
                                              blocks_for, prefix_hash)


def _cache(**kw):
    kw.setdefault("block_tokens", 4)
    kw.setdefault("pool_blocks", 16)
    return PagedKVCache(registry=MetricsRegistry(), **kw)


def test_blocks_for_is_ceil_div():
    assert blocks_for(0, 4) == 0
    assert blocks_for(1, 4) == 1
    assert blocks_for(4, 4) == 1
    assert blocks_for(5, 4) == 2


def test_prefix_hash_chains_the_whole_prefix():
    a = prefix_hash([1, 2, 3, 4])
    b = prefix_hash([1, 2, 3, 4])
    assert a == b
    # same chunk under a different parent is a DIFFERENT block: sharing
    # requires the entire prefix to match, not just the local tokens
    assert prefix_hash([5, 6, 7, 8], parent=a) != prefix_hash([5, 6, 7, 8])
    assert prefix_hash([1, 2, 3, 4]) != prefix_hash([1, 2, 3, 5])


def test_admit_charges_worst_case_and_free_returns_it():
    c = _cache()
    lease = c.admit(list(range(6)), budget=5)  # 11 tokens -> 3 blocks
    assert lease.charged == 3
    st = c.stats()
    assert st["free"] == 13
    c.free(lease)
    assert c.stats()["free"] == 16
    assert c.balanced()


def test_release_asserts_empty_table_and_free_tolerates_bound():
    c = _cache()
    q = c.admit([1, 2, 3], budget=2)
    c.release(q)  # queued-expired: never bound anything — fine
    assert c.balanced()
    r = c.admit([1, 2, 3], budget=2)
    c.bind(r, covered_tokens=3, state=np.zeros(2, np.float32))
    with pytest.raises(RuntimeError, match="expiry-split"):
        c.release(r)
    c.free(r)  # running path returns the charge and the bound blocks
    assert c.stats()["free"] == 16 and c.balanced()


def test_double_close_is_idempotent():
    c = _cache()
    lease = c.admit([1, 2, 3], budget=1)
    c.free(lease)
    c.free(lease)  # a second free must not double-credit the pool
    assert c.stats()["free"] == 16 and c.balanced()


def test_exhaustion_is_a_clean_reject_not_a_partial_charge():
    c = _cache(pool_blocks=2)
    a = c.admit([1, 2, 3, 4], budget=4)  # 8 tokens -> 2 blocks
    with pytest.raises(CacheExhausted):
        c.admit([9, 9, 9, 9], budget=4)
    # the failed admit left no residue
    assert c.stats()["free"] == 0 and c.balanced()
    c.free(a)
    assert c.stats()["free"] == 2


def test_publish_converts_private_charge_to_shared_and_reuse_increfs():
    c = _cache()
    prompt = list(range(9))  # 9 tokens: 2 full prompt blocks + 1 partial
    first = c.admit(prompt, budget=3)
    assert first.charged == 3 and not first.shared
    c.bind(first, covered_tokens=9, state=np.zeros(2, np.float32))
    boundary = {4: np.full(2, 1.0, np.float32),
                8: np.full(2, 2.0, np.float32)}
    c.publish(first, prompt, boundary)
    st = c.stats()
    assert st["shared_resident"] == 2  # two full prompt blocks published
    assert first.charged == 1  # the partial block stays private
    c.free(first)
    assert c.balanced()
    # shared blocks survive their publisher (zero-ref, LRU-resident)
    assert c.stats()["shared_resident"] == 2

    second = c.admit(prompt, budget=3)
    assert len(second.shared) == 2 and second.prefix_covered == 8
    assert np.array_equal(second.prefix_state, boundary[8])
    assert second.charged == 1  # only the uncovered tail is charged
    c.free(second)
    assert c.balanced()


def test_shared_coverage_never_swallows_the_whole_prompt():
    c = _cache()
    prompt = list(range(8))  # exactly 2 blocks, block-aligned
    first = c.admit(prompt, budget=4)
    c.bind(first, covered_tokens=8, state=np.zeros(2, np.float32))
    c.publish(first, prompt, {4: np.zeros(2, np.float32),
                              8: np.zeros(2, np.float32)})
    c.free(first)
    second = c.admit(prompt, budget=4)
    # a fully-covered prompt would leave the decode loop nothing to
    # consume on its first step — coverage is capped at len(prompt)-1
    assert second.prefix_covered < len(prompt)
    c.free(second)
    assert c.balanced()


def test_lru_eviction_frees_zero_ref_shared_blocks_under_pressure():
    from horovod_tpu_torch.metrics import snapshot_value
    reg = MetricsRegistry()
    c = PagedKVCache(block_tokens=4, pool_blocks=4, registry=reg)
    prompt = [7, 7, 7, 7, 1]  # 1 full prompt block + 1 partial
    first = c.admit(prompt, budget=3)
    c.bind(first, covered_tokens=5, state=np.zeros(2, np.float32))
    c.publish(first, prompt, {4: np.zeros(2, np.float32)})
    c.free(first)
    assert c.stats()["shared_resident"] == 1
    # 4-block pool, 1 resident shared: a 4-block admit must evict it
    big = c.admit(list(range(10)), budget=6)
    assert big.charged == 4
    assert c.stats()["shared_resident"] == 0
    assert snapshot_value(reg.snapshot(),
                          "hvd_serve_cache_evictions_total") == 1
    c.free(big)
    assert c.balanced()


def test_referenced_shared_blocks_are_never_evicted():
    c = _cache(pool_blocks=4)
    prompt = [7, 7, 7, 7, 1]
    first = c.admit(prompt, budget=3)
    c.bind(first, covered_tokens=5, state=np.zeros(2, np.float32))
    c.publish(first, prompt, {4: np.zeros(2, np.float32)})
    c.free(first)
    holder = c.admit(prompt, budget=3)  # increfs the shared block
    assert len(holder.shared) == 1
    # free pool is 4 - 1 shared - 1 holder charge = 2; a 3-block admit
    # cannot evict the referenced block and must reject instead
    with pytest.raises(CacheExhausted):
        c.admit(list(range(8)), budget=4)
    c.free(holder)
    assert c.balanced()


def test_prefix_reuse_can_be_disabled():
    c = _cache(prefix_reuse=False)
    prompt = list(range(9))
    first = c.admit(prompt, budget=3)
    c.bind(first, covered_tokens=9, state=np.zeros(2, np.float32))
    c.publish(first, prompt, {4: np.zeros(2, np.float32),
                              8: np.zeros(2, np.float32)})
    c.free(first)
    assert c.stats()["shared_resident"] == 0
    second = c.admit(prompt, budget=3)
    assert not second.shared and second.charged == 3
    c.free(second)
    assert c.balanced()


def test_metrics_exported_on_the_registry():
    from horovod_tpu_torch.metrics import snapshot_value
    reg = MetricsRegistry()
    c = PagedKVCache(block_tokens=4, pool_blocks=8, registry=reg)
    lease = c.admit(list(range(6)), budget=2)
    snap = reg.snapshot()
    assert snapshot_value(snap, "hvd_serve_cache_pool_blocks") == 8
    assert snapshot_value(snap, "hvd_serve_cache_blocks_used") == 2
    assert snapshot_value(snap, "hvd_serve_cache_lookups_total") == 1
    c.free(lease)
    snap = reg.snapshot()
    assert snapshot_value(snap, "hvd_serve_cache_blocks_used") == 0


def test_env_defaults_come_from_the_registry(monkeypatch):
    monkeypatch.setenv("HOROVOD_SERVE_KV_BLOCK_TOKENS", "8")
    monkeypatch.setenv("HOROVOD_SERVE_KV_POOL_BLOCKS", "32")
    monkeypatch.setenv("HOROVOD_SERVE_PREFIX_REUSE", "0")
    c = PagedKVCache(registry=MetricsRegistry())
    assert c.block_tokens == 8 and c.pool_blocks == 32
    assert c.prefix_reuse is False


def test_port_and_reference_caches_agree_in_lockstep():
    """One script of admissions (shared and private prompts), publishes,
    binds, frees, releases and an exhaustion, applied to both caches:
    the same prefix hashes, the same leases' charges and coverage, the
    same stats and balance after every step."""
    from horovod_tpu.metrics.registry import MetricsRegistry as RefReg
    from horovod_tpu.serve import kv_cache as ref
    caches = [PagedKVCache(block_tokens=4, pool_blocks=12,
                           registry=MetricsRegistry()),
              ref.PagedKVCache(block_tokens=4, pool_blocks=12,
                               registry=RefReg())]
    assert prefix_hash([1, 2, 3, 4]) == ref.prefix_hash([1, 2, 3, 4])
    rng = np.random.RandomState(5)
    shared = [[7] * 9, [3, 1] * 5]
    live = [[], []]
    for op in range(60):
        kind = rng.randint(4)
        if kind < 2 or not live[0]:
            prompt = shared[rng.randint(2)] + [int(rng.randint(100))] \
                if kind == 0 else rng.randint(0, 100, 6).tolist()
            budget = int(rng.randint(1, 5))
            got = []
            for c, mine in zip(caches, live):
                try:
                    le = c.admit(prompt, budget)
                except (CacheExhausted, ref.CacheExhausted):
                    got.append("exhausted")
                    continue
                mine.append((le, prompt))
                got.append((le.charged, le.prefix_covered))
            assert got[0] == got[1], (op, got)
        else:
            j = int(rng.randint(len(live[0])))
            for c, mine in zip(caches, live):
                le, prompt = mine.pop(j)
                if kind == 2:
                    bt = c.block_tokens
                    states = {end: np.full(2, end, np.float32)
                              for end in range(bt, len(prompt) + 1, bt)}
                    if states:
                        c.publish(le, prompt, states)
                    c.bind(le, len(prompt), np.zeros(2, np.float32))
                    c.free(le)
                else:
                    c.release(le) if le.bound == 0 else c.free(le)
        assert caches[0].stats() == caches[1].stats(), op
        assert caches[0].balanced() and caches[1].balanced()
