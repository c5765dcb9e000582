"""Port parity: the paged KV pool (`pb_llm_tpu_torch.runtime.paged_kv`) and
the paged engine against the JAX package.

  * `PagePool` bookkeeping (tests/test_paged.py's case) and its tables
    against a JAX `PagePool` driven through the same calls;
  * greedy streams and prefill logits (1e-4) of the port's paged engine
    against the JAX paged engine, f32 and int8 pages, GQA, and a pool small
    enough that the batcher preempts;
  * paged equals strip inside the port; inactive slots never corrupt live
    pages; a sliding window refuses the pool.
"""

import numpy as np
import pytest
import torch

from _torch_serving import TinyLlama, greedy, random_prompts, serve
from pb_llm_tpu.runtime.paged_kv import PagePool as JPagePool
from pb_llm_tpu_torch.runtime.engine import PoolExhausted
from pb_llm_tpu_torch.runtime.paged_kv import PagePool

BASE = dict(n_slots=2, max_seq=64, prefill_buckets=(16, 32), page_size=8)
PROMPT = [5, 17, 99, 3, 42, 7, 11, 23, 60, 2]


@pytest.fixture(scope="module")
def models():
    return {kv: TinyLlama(kv_heads=kv) for kv in (4, 2)}


def test_page_pool_alloc_free():
    pool = PagePool(n_pages=8, page_size=16, n_slots=2, max_seq=64)
    assert pool.can_admit(40) and pool.pages_needed(40) == 3
    pool.ensure(0, 40)
    assert len(pool.owned[0]) == 3 and pool.free_pages == 5
    pool.ensure(0, 41)  # same page count
    assert pool.free_pages == 5
    pool.ensure(0, 49)  # one more page
    assert pool.free_pages == 4
    pool.ensure(1, 64)
    assert pool.free_pages == 0
    with pytest.raises(ValueError):
        pool.ensure(1, 65)  # > max_seq
    small = PagePool(n_pages=2, page_size=16, n_slots=2, max_seq=64)
    with pytest.raises(RuntimeError):
        small.ensure(0, 48)  # needs 3 pages, pool has 2
    pool.release(0)
    assert pool.free_pages == 4
    assert (pool.table[0] == pool.trash_page).all()


def test_page_pool_tables_match_jax_pool():
    """Both pools through one random sequence of admissions, prefix
    matches, growth and releases: equal tables, owners, refcounts, LRU
    order and hit counts at every step."""
    r = np.random.default_rng(0)
    kw = dict(n_pages=12, page_size=4, n_slots=3, max_seq=32, prefix_cache=True)
    pools = (PagePool(**kw), JPagePool(**kw))
    prefixes = [r.integers(0, 9, size=8).tolist() for _ in range(2)]
    for step in range(60):
        slot = int(r.integers(0, 3))
        busy = bool(pools[0].owned[slot])
        if busy and r.random() < 0.4:
            for p in pools:
                p.release(slot)
        elif busy:
            n = min(32, 4 * len(pools[0].owned[slot]) + int(r.integers(1, 6)))
            if pools[0].pages_needed(n) - len(pools[0].owned[slot]) <= pools[0].free_pages:
                for p in pools:
                    p.ensure(slot, n)
        else:
            toks = prefixes[step % 2] + r.integers(0, 9, size=int(r.integers(1, 9))).tolist()
            matches = [p.match_prefix(toks, (len(toks) - 1) // 4) for p in pools]
            assert matches[0] == matches[1]
            if pools[0].pages_needed(len(toks)) > pools[0].free_pages:
                continue
            for p in pools:
                p.attach(slot, matches[0][1])
                p.ensure(slot, len(toks))
                p.register_chain(slot, toks)
        t, j = pools
        np.testing.assert_array_equal(t.table, j.table)
        assert t.owned == j.owned and t.free_list == j.free_list
        np.testing.assert_array_equal(t.ref, j.ref)
        assert list(t.evictable) == list(j.evictable) and t.hash_page == j.hash_page
        assert (t.prefix_queries, t.prefix_hit_pages) == (j.prefix_queries, j.prefix_hit_pages)
    assert pools[0].prefix_hit_pages > 0


@pytest.mark.parametrize("kv", [4, 2])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_paged_engine_matches_jax_engine(models, kv, dtype):
    m = models[kv]
    want, want_logits = greedy(m.jax_engine(cache_dtype=dtype, **BASE), PROMPT, 12)
    eng = m.port_engine(cache_dtype=dtype, **BASE)
    got, logits = greedy(eng, PROMPT, 12)
    np.testing.assert_allclose(logits, want_logits, rtol=1e-4, atol=1e-4)
    assert got == want
    assert eng.pool.free_pages == eng.pool.n_pages


def test_paged_forced_nll_matches_jax_engine(models):
    m = models[2]
    cont = [7, 21, 42, 11, 63, 5, 30, 2, 50, 19]  # crosses a page at 16
    nll = []
    for eng in (m.jax_engine(**BASE), m.port_engine(**BASE)):
        eng.prefill(1, PROMPT)
        nll.append(eng.forced_decode_nll(1, cont))
    assert abs(nll[1] - nll[0]) <= 1e-4 * abs(nll[0])


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_paged_batcher_preemption_matches_jax(models, dtype):
    """A pool too small for every request's growth: PoolExhausted → recompute
    preemption in both packages, the same streams, the pool empty after."""
    m = models[4]
    prompts = random_prompts(1, [5, 12, 9, 14])
    kw = dict(BASE, n_pages=5, cache_dtype=dtype)
    want, jb = serve(m.jax_engine(**kw), prompts, 12)
    got, tb = serve(m.port_engine(**kw), prompts, 12)
    assert got == want
    assert tb.stats.preemptions >= 1 and tb.stats.preemptions == jb.stats.preemptions
    assert tb.engine.pool.free_pages == 5


def test_decode_step_raises_before_any_slot_grows(models):
    eng = models[4].port_engine(**dict(BASE, n_pages=4))
    eng.prefill(0, PROMPT)   # 2 pages (bucket 16)
    eng.prefill(1, PROMPT)   # 2 pages: the pool is full
    eng.lengths[:] = 16      # both need a third page for the next token
    owned = [list(o) for o in eng.pool.owned]
    with pytest.raises(PoolExhausted):
        eng.decode_step()
    assert eng.pool.owned == owned


def test_paged_equals_strip_in_the_port(models):
    m = models[2]
    prompts = random_prompts(2, [4, 16, 7, 25, 12])
    strip, _ = serve(m.port_engine(n_slots=2, max_seq=64, prefill_buckets=(16, 32)), prompts, 10)
    paged, _ = serve(m.port_engine(**BASE), prompts, 10)
    assert paged == strip


def test_inactive_slots_do_not_corrupt_live_pages(models):
    """Slot 1 is never prefilled: its decode writes land on the trash page,
    never in slot 0's pages (page 0 in particular), and slot 0's stream
    equals the strip engine's."""
    m = models[4]
    want, _ = greedy(m.port_engine(n_slots=2, max_seq=64, prefill_buckets=(16,)), PROMPT, 10)
    eng = m.port_engine(**BASE)
    got = [eng.prefill(0, PROMPT)]
    snap = [c["k_pages"][eng.pool.owned[0]].clone() for c in eng.caches]
    for _ in range(5):
        got.append(eng.decode_step()[0])
    # rows [0, 10) of slot 0 are the prompt: unchanged by five decode steps
    for c, before in zip(eng.caches, snap):
        now = c["k_pages"][eng.pool.owned[0]]
        assert torch.equal(now[0], before[0]) and torch.equal(now[1, :, :2], before[1, :, :2])
    for _ in range(4):
        got.append(eng.decode_step()[0])
    assert got == want
    assert eng.pool.owned[1] == [] and (eng.pool.table[1] == eng.pool.trash_page).all()


def test_sliding_window_refuses_the_paged_pool():
    m = TinyLlama(kv_heads=8, family="mistral", sliding_window=5)
    eng = m.port_engine(**BASE)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        eng.prefill(0, PROMPT)


def test_bad_paged_configs_raise(models):
    m = models[4]
    with pytest.raises(ValueError, match="not divisible by page_size"):
        m.port_engine(n_slots=1, max_seq=64, prefill_buckets=(12,), page_size=8)
    with pytest.raises(ValueError, match="max_seq"):
        m.port_engine(n_slots=1, max_seq=60, prefill_buckets=(16,), page_size=8)
    with pytest.raises(ValueError, match="prefix_cache"):
        m.port_engine(n_slots=1, max_seq=64, prefill_buckets=(16,), prefix_cache=True)


def test_pool_lives_on_the_engine_device(models):
    eng = models[2].port_engine(cache_dtype="int8", **BASE)
    c = eng.caches[0]
    assert c["k_pages"].shape == (2 * 64 // 8 + 1, 2, 8, 8) and c["k_pages"].dtype == torch.int8
    assert c["k_scale_pages"].shape == (17, 2, 8)
    assert all(ci["table"] is c["table"] for ci in eng.caches)
