"""Port parity: speculative decoding against plain decode and the JAX package.

Greedy verify emits exactly the plain greedy stream whatever the drafts,
over strips and pages, f32 and int8, up to the max_seq boundary; the
batcher's prompt-lookup spec streams equal the JAX batcher's; a draft
model that is the target itself accepts every draft, across slot reuse,
and catches up after ticks it missed; the rejection-sampling verify emits
each token with its target probability (a distribution test: the port
draws from a torch.Generator, so its bits differ from JAX's).
"""

import numpy as np
import pytest
import torch

from _torch_serving import TinyLlama, random_prompts, serve
from pb_llm_tpu_torch.runtime.draft import ModelDraftSource
from pb_llm_tpu_torch.runtime.sampler import SamplingParams, filter_logits_vec, spec_verify_sample

BASE = dict(n_slots=2, max_seq=64, prefill_buckets=(8, 16, 32))
PROMPT = [5, 17, 99, 3]


@pytest.fixture(scope="module")
def model():
    return TinyLlama(kv_heads=2)


def _plain(model, prompt, steps, **kw):
    eng = model.port_engine(**BASE, **kw)
    return [eng.prefill(0, prompt)] + [eng.decode_step()[0] for _ in range(steps)]


@pytest.mark.parametrize("kw", [{}, {"cache_dtype": "int8"}, {"page_size": 8},
                                {"page_size": 8, "cache_dtype": "int8"}])
def test_spec_step_exact_for_any_drafts(model, kw):
    """Oracle, wrong and mixed drafts: concatenated spec streams equal plain
    greedy decode; verify windows cross page boundaries."""
    want = _plain(model, PROMPT, 14, **kw)
    for mode in ("oracle", "wrong", "mixed"):
        eng = model.port_engine(**BASE, spec_gamma=3, **kw)
        got, verifies = [eng.prefill(0, PROMPT)], 0
        while len(got) < len(want):
            nxt = want[len(got): len(got) + 3]
            nxt = nxt + [0] * (3 - len(nxt))
            d = {"oracle": nxt, "wrong": [(got[-1] + 7) % 128] * 3, "mixed": nxt[:1] + [99, 98]}
            drafts = np.zeros((2, 3), np.int32)
            drafts[0] = d[mode]
            out = eng.spec_decode_step(drafts)
            assert len(eng.token_logprobs[0]) == len(out[0])
            got.extend(out[0])
            verifies += 1
        assert got[: len(want)] == want, mode
        if mode == "oracle":
            assert verifies <= (len(want) + 2) // 4 + 1
        if mode == "wrong":
            assert verifies == len(want) - 1


@pytest.mark.parametrize("kw", [{}, {"page_size": 8}])
def test_batcher_spec_matches_plain_and_jax(model, kw):
    """Prompt-lookup drafts on repetitive prompts: the spec streams equal
    plain decode and the JAX batcher's, with the same acceptance."""
    prompts = [[7, 8, 9, 7, 8, 9, 7, 8]] * 2 + random_prompts(7, [6])
    plain, _ = serve(model.port_engine(**BASE, **kw), prompts, 16)
    got, tb = serve(model.port_engine(**BASE, spec_gamma=3, **kw), prompts, 16)
    want, jb = serve(model.jax_engine(**BASE, spec_gamma=3, **kw), prompts, 16)
    assert got == plain == want
    assert tb.stats.spec_drafted > 0
    assert (tb.stats.spec_drafted, tb.stats.spec_accepted) == (jb.stats.spec_drafted,
                                                               jb.stats.spec_accepted)


@pytest.mark.parametrize("kw", [{}, {"page_size": 8}])
def test_spec_at_the_max_seq_boundary(model, kw):
    """Requests that run into max_seq: drafts stop near the end (plain
    ticks take over) and every request retires at the cache's edge with
    the plain stream."""
    prompts = random_prompts(8, [28, 30, 31])
    kw = dict(n_slots=2, max_seq=40, prefill_buckets=(8, 32), **kw)
    plain, _ = serve(model.port_engine(**kw), prompts, 64)
    got, b = serve(model.port_engine(spec_gamma=4, **kw), prompts, 64)
    assert got == plain
    assert [len(s) for s in got] == [40 - len(p) for p in prompts]
    assert b.stats.spec_drafted > 0


def _self_draft(model, **kw):
    return ModelDraftSource(model.port_engine(**BASE, **kw))


@pytest.mark.parametrize("kw", [{}, {"page_size": 8}])
def test_self_draft_accepts_every_draft_across_slot_reuse(model, kw):
    """Draft == target: every draft is the target's own argmax.  Five
    requests over two slots with different budgets reuse slots between
    propose() calls; a stale draft KV would break the 100%."""
    prompts = [[(7 * i + 5) % 128, (13 * i + 17) % 128, (29 * i + 99) % 128, (41 * i + 3) % 128]
               for i in range(5)]
    eng = model.port_engine(**BASE, spec_gamma=3, **kw)
    b_reqs = [4 + 3 * i for i in range(5)]
    from pb_llm_tpu_torch.runtime import batching as tb

    b = tb.ContinuousBatcher(eng, draft_source=_self_draft(model))
    reqs = [tb.Request(request_id=i, prompt_ids=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, b_reqs))]
    b.run(reqs)
    assert b.stats.spec_drafted > 0
    assert b.stats.spec_accepted == b.stats.spec_drafted
    plain = tb.ContinuousBatcher(model.port_engine(**BASE, **kw))
    want = [tb.Request(request_id=i, prompt_ids=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, b_reqs))]
    plain.run(want)
    assert [r.output_ids for r in reqs] == [r.output_ids for r in want]


def test_draft_catches_up_after_plain_ticks(model):
    """Ticks run without the source leave the draft behind; the next
    propose() rolls it back, feeds the missed tokens and drafts what a
    freshly prefilled draft engine would."""
    from types import SimpleNamespace

    from pb_llm_tpu_torch.runtime.batching import Request

    draft_model = TinyLlama(kv_heads=4, seed=1, layers=1, hidden=32)
    eng = model.port_engine(**BASE)
    req = Request(request_id=0, prompt_ids=PROMPT, max_new_tokens=16)
    req.output_ids.append(eng.prefill(0, PROMPT))
    fake = SimpleNamespace(engine=eng, slot_to_request={0: req})
    src = ModelDraftSource(draft_model.port_engine(**BASE))
    assert src.propose(fake, 3) is not None
    for _ in range(2):
        req.output_ids.append(eng.decode_step()[0])
    d2 = src.propose(fake, 3)
    hist = PROMPT + req.output_ids
    fresh = draft_model.port_engine(**BASE)
    fresh.prefill(0, hist[:-1])
    fresh.last_token[0] = hist[-1]
    assert list(d2[0]) == [fresh.decode_step()[0] for _ in range(3)]


def test_model_draft_streams_match_jax(model):
    """A 1-layer draft model proposes for the 2-layer target in both
    packages: the same streams, equal to plain decode."""
    from pb_llm_tpu.runtime.draft import ModelDraftSource as JModelDraftSource

    draft_model = TinyLlama(kv_heads=4, seed=1, layers=1, hidden=32)
    prompts = [[3 + 11 * i, 29, 64 + i, 90 - i] for i in range(3)]
    kw = dict(BASE, spec_gamma=3, page_size=8)
    got, tb = serve(model.port_engine(**kw), prompts, 12,
                    draft_source=ModelDraftSource(draft_model.port_engine(**BASE)))
    want, jb = serve(model.jax_engine(**kw), prompts, 12,
                     draft_source=JModelDraftSource(draft_model.jax_engine(**BASE)))
    plain, _ = serve(model.port_engine(**BASE), prompts, 12)
    assert got == want == plain
    assert tb.stats.spec_accepted == jb.stats.spec_accepted


@pytest.mark.parametrize("top_k", [0, 3])
def test_spec_verify_sample_emits_the_target_distribution(top_k):
    """The first emitted token of the rejection-sampling verify (the
    accepted draft, else the correction) over 24000 draws at V = 8 against
    the filtered softmax: within 0.02 (the JAX test's bound; 4.5 standard
    errors at p = 0.5), and tokens outside the support never appear."""
    V, t, n = 8, 3, 24000
    r = np.random.default_rng(0)
    logits = torch.as_tensor(r.standard_normal((1, t, V)).astype(np.float32) * 2.0)
    drafts = torch.tensor([[3, 5]])
    temp, tk, tp = torch.tensor([0.8]), torch.tensor([top_k]), torch.tensor([1.0])
    gen = torch.Generator().manual_seed(1)
    acc, corr, _, _ = spec_verify_sample(logits.expand(n, t, V), drafts.expand(n, 2), gen,
                                         temp.expand(n), tk.expand(n), tp.expand(n))
    emitted = torch.where(acc[:, 0], drafts[0, 0], corr[:, 0]).numpy()
    p = torch.softmax(filter_logits_vec(logits[0, :1], temp, tk, tp), dim=-1)[0].numpy()
    freq = np.bincount(emitted, minlength=V) / n
    assert np.abs(freq - p).max() < 0.02, (freq, p)
    assert freq[p == 0.0].sum() == 0.0


def test_greedy_rows_stay_exact_in_a_sampled_pool(model):
    """Slot 1 samples (temperature 0.9) beside greedy slot 0: the sampled
    verify runs, and slot 0's stream still equals plain greedy decode."""
    want = _plain(model, PROMPT, 10)
    eng = model.port_engine(**BASE, spec_gamma=3)
    got = [eng.prefill(0, PROMPT)]
    eng.set_slot_sampling(1, SamplingParams(temperature=0.9))
    eng.prefill(1, [42, 7, 11])
    assert not eng.greedy_ok()
    while len(got) < len(want):
        drafts = np.zeros((2, 3), np.int32)
        nxt = want[len(got): len(got) + 3]
        drafts[0, : len(nxt)] = nxt
        drafts[1] = [1, 2, 3]
        out = eng.spec_decode_step(drafts)
        assert 1 <= len(out[1]) <= 4 and len(eng.token_logprobs[1]) == len(out[1])
        got.extend(out[0])
    assert got[: len(want)] == want
