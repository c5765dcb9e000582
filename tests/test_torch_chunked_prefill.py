"""Port parity: chunked prefill against one-shot prefill and the JAX package.

A prompt prefilled chunk by chunk gives the same tokens as a one-shot
prefill, over strips and pages, f32 and int8; in the batcher, chunks
interleave with other requests' decode (and speculative) steps without
corrupting the parked slot's rows, and the streams equal the JAX
batcher's; the JAX engine's configuration errors are raised.
"""

import pytest

from _torch_serving import TinyLlama, random_prompts, serve

PROMPT = [5, 17, 99, 3, 42, 7, 11, 23, 60, 2, 19, 88, 41, 6, 77, 31, 12, 9]  # 18 tokens
BASE = dict(n_slots=2, max_seq=48, prefill_buckets=(8, 16, 32))


@pytest.fixture(scope="module")
def model():
    return TinyLlama(kv_heads=2)


@pytest.mark.parametrize("kw", [
    {},                                          # strips f32
    {"cache_dtype": "int8"},                     # strips int8
    {"page_size": 8},                            # paged f32
    {"page_size": 8, "cache_dtype": "int8"},     # paged int8
])
def test_chunked_prefill_matches_one_shot(model, kw):
    one = model.port_engine(**BASE, **kw)
    want = [one.prefill(0, PROMPT)] + [one.decode_step()[0] for _ in range(4)]
    eng = model.port_engine(**BASE, prefill_chunk=8, **kw)
    eng.start_chunked_prefill(0, PROMPT)  # 18 tokens: chunks 8 + 8 + 2
    tok, steps = None, 0
    while tok is None:
        tok = eng.prefill_chunk_step(0)
        steps += 1
    assert steps == 3
    got = [tok] + [eng.decode_step()[0] for _ in range(4)]
    assert got == want


def _reqs():
    return [[7, 8, 9, 7], list(PROMPT), random_prompts(6, [30])[0]]


@pytest.mark.parametrize("kw", [{}, {"spec_gamma": 2}, {"page_size": 8},
                                {"page_size": 8, "spec_gamma": 2}])
def test_chunks_interleave_with_decode_and_match_jax(model, kw):
    """A short request decodes while long prompts prefill one chunk per
    tick: streams equal the unchunked run and the JAX batcher's; decode
    steps ran while a slot sat parked."""
    plain, _ = serve(model.port_engine(**BASE, **kw), _reqs(), 8)
    got, b = serve(model.port_engine(**BASE, prefill_chunk=8, **kw), _reqs(), 8)
    want, _ = serve(model.jax_engine(**BASE, prefill_chunk=8, **kw), _reqs(), 8)
    assert got == plain == want
    assert b.stats.prefills == 3 and b.stats.decode_steps > 0


def test_parked_slot_rows_survive_decode_traffic(model):
    """While slot 1's chunks land, slot 0's decode steps write a garbage
    row for the parked slot at max_seq-1: it lands on the trash page, never
    on slot 1's chunk rows."""
    eng = model.port_engine(**BASE, page_size=8, prefill_chunk=8)
    eng.prefill(0, [7, 8, 9, 7])
    eng.start_chunked_prefill(1, PROMPT)
    assert eng.prefill_chunk_step(1) is None
    first = [c["k_pages"][eng.pool.owned[1][0]].clone() for c in eng.caches]
    for _ in range(3):
        eng.decode_step()
    assert eng.prefill_chunk_step(1) is None
    for c, before in zip(eng.caches, first):
        assert (c["k_pages"][eng.pool.owned[1][0]] == before).all()
    assert eng.lengths[1] == BASE["max_seq"] - 1 and not eng.active[1]


def test_chunked_config_validation(model):
    with pytest.raises(ValueError, match="multiple of prefill_chunk"):
        model.port_engine(max_seq=50, prefill_buckets=(8, 50), prefill_chunk=8)
    with pytest.raises(ValueError, match="largest prefill bucket"):
        model.port_engine(max_seq=64, prefill_buckets=(8,), prefill_chunk=16)
    with pytest.raises(ValueError, match="multiple of page_size"):
        model.port_engine(max_seq=64, prefill_buckets=(8, 16), page_size=8, prefill_chunk=12)
    eng = model.port_engine(**BASE)
    with pytest.raises(ValueError, match="prefill_chunk is 0"):
        eng.start_chunked_prefill(0, PROMPT)
