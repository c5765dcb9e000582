"""Port parity: prefix caching over the paged pool against the JAX package.

The same requests through both packages' batchers with the cache on give
the same streams and the same hit pages as each other and as the cache
off; shared pages keep their bytes while other slots decode; released
pages stay matchable until allocation pressure evicts them; hits compose
with chunked prefill (the job starts at the chunk-aligned prefix) and with
recompute preemption.
"""

import numpy as np
import pytest
import torch

from _torch_serving import TinyLlama, random_prompts, serve

KW = dict(n_slots=2, max_seq=64, prefill_buckets=(16, 32), page_size=8)
SHARED = [5, 17, 99, 3, 42, 7, 11, 23, 60, 2]  # 10 tokens: 1 full page


@pytest.fixture(scope="module")
def model():
    return TinyLlama(kv_heads=2)


def _pair(model, prompts, steps, **kw):
    """(port streams, port batcher, JAX streams, JAX batcher) with the
    prefix cache on."""
    ekw = dict(KW, prefix_cache=True, **kw)
    want, jb = serve(model.jax_engine(**ekw), prompts, steps)
    got, tb = serve(model.port_engine(**ekw), prompts, steps)
    return got, tb, want, jb


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_prefix_hits_match_jax_and_the_cache_off(model, dtype):
    # 3 requests over 2 slots: the third admits after a retirement and hits
    prompts = [SHARED + [19, 4], SHARED + [19, 4], SHARED + [77]]
    got, tb, want, jb = _pair(model, prompts, 6, cache_dtype=dtype)
    cold, _ = serve(model.port_engine(cache_dtype=dtype, **KW), prompts, 6)
    assert got == want
    assert tb.engine.pool.prefix_hit_pages == jb.engine.pool.prefix_hit_pages > 0
    if dtype == "f32":  # int8 hits read quantized prefix K/V where a cold prefill has f32
        assert got == cold


def test_shared_pages_keep_their_bytes(model):
    """The reused page is read-only: the hitting request's suffix prefill
    and both slots' decode steps leave its bytes as they were."""
    eng = model.port_engine(**KW, prefix_cache=True)
    eng.prefill(0, SHARED)
    for _ in range(3):
        eng.decode_step()
    shared = eng.pool.owned[0][0]
    before = [(c["k_pages"][shared].clone(), c["v_pages"][shared].clone()) for c in eng.caches]
    assert isinstance(eng.prefill(1, SHARED + [33]), int)
    assert eng.pool.owned[1][0] == shared and eng.pool.ref[shared] == 2
    for _ in range(6):
        eng.decode_step()
    for c, (k, v) in zip(eng.caches, before):
        assert torch.equal(c["k_pages"][shared], k) and torch.equal(c["v_pages"][shared], v)


def test_eviction_after_release_matches_jax(model):
    """A pool barely larger than one request's footprint: later admissions
    evict the earlier requests' cached pages; streams still equal the
    cache-off run and JAX's."""
    shared = SHARED[:8]  # exactly one page
    prompts = [shared + [19], shared + [4], shared + [2], shared + [60]]
    got, tb, want, jb = _pair(model, prompts, 4, n_pages=5)
    cold, _ = serve(model.port_engine(**KW, n_pages=5), prompts, 4)
    assert got == want == cold
    pool = tb.engine.pool
    assert pool.prefix_hit_pages == jb.engine.pool.prefix_hit_pages > 0
    assert pool.free_pages == pool.n_pages


def test_prefix_hit_with_chunked_prefill_matches_jax(model):
    """Long prompts take the chunked path; a hit starts the job at the
    chunk-aligned prefix offset, skipping whole chunks."""
    shared = random_prompts(3, [24])[0]
    prompts = [shared + [9, 1], shared + [9, 1], shared + [8]]
    got, tb, want, jb = _pair(model, prompts, 6, prefill_chunk=8)
    cold, _ = serve(model.port_engine(**KW, prefill_chunk=8), prompts, 6)
    assert got == want == cold
    assert tb.engine.pool.prefix_hit_pages == jb.engine.pool.prefix_hit_pages > 0

    eng = model.port_engine(**KW, prefill_chunk=8, prefix_cache=True)
    prompt = random_prompts(4, [20])[0]  # 2 full pages
    eng.start_chunked_prefill(0, prompt)
    while eng.prefill_chunk_step(0) is None:
        pass
    eng.release(0)
    eng.start_chunked_prefill(1, prompt)
    assert eng._chunk_jobs[1][1] == 16  # 2 pages = 2 chunks skipped
    assert eng.prefill_chunk_step(1) is not None


def test_prefix_hit_under_preemption_matches_jax(model):
    """A pool too small for both requests' growth: the preempted request
    re-admits through the prefix-hit suffix path over its own registered
    pages."""
    shared = SHARED[:8]
    prompts = [shared + [19, 4], shared + [2, 6]]
    got, tb, want, jb = _pair(model, prompts, 14, n_pages=5)
    cold, _ = serve(model.port_engine(**KW, n_pages=5), prompts, 14)
    assert got == want == cold
    assert tb.stats.preemptions == jb.stats.preemptions > 0
    assert tb.engine.pool.prefix_hit_pages == jb.engine.pool.prefix_hit_pages > 0
    assert tb.engine.pool.free_pages == tb.engine.pool.n_pages


def test_suffix_in_the_prompts_bucket_stays_in_its_reservation(model):
    """A suffix padded into the same bucket as the whole prompt is clamped
    to the footprint admission reserved: an exactly-sized pool completes."""
    shared = random_prompts(5, [16])[0]  # 2 pages
    prompts = [shared + [9], shared + [9, 1, 2, 3, 4, 5, 6, 7, 50]]  # 17 and 25 tokens
    kw = dict(n_slots=1, max_seq=64, prefill_buckets=(8, 32), page_size=8, n_pages=5)
    got, b = serve(model.port_engine(**kw, prefix_cache=True), prompts, 4)
    cold, _ = serve(model.port_engine(**kw), prompts, 4)
    assert got == cold
    assert b.engine.pool.prefix_hit_pages == 2
    assert b.engine.pool.free_pages == b.engine.pool.n_pages


def test_prefix_cache_with_spec_decode(model):
    prompts = [SHARED + [19, 4]] * 3
    got, tb, want, jb = _pair(model, prompts, 8, spec_gamma=2)
    cold, _ = serve(model.port_engine(**KW), prompts, 8)
    assert got == want == cold
    assert tb.engine.pool.prefix_hit_pages > 0
    assert np.all(tb.engine.pool.ref == 0)
