"""Port parity of continuous batching across ranks
(`pb_llm_tpu_torch.runtime.multihost_batching.MultiHostBatcher`) against
the JAX package's.

In one process the admission broadcast is the identity: the port's
batcher must give JAX's single-process MultiHostBatcher's streams token for
token on tiny llama and OPT models, over int8-free f32 strips, a paged pool
with the prefix cache, chunked prefill, speculative decoding by prompt
lookup (tests/test_spec_decode.py:232) and by a draft model (:440); a
sampled request rides the record in 1e-6 fixed point and every side
installs the decoded values; more than 4 stop ids raise (on rank 0, as in
JAX: one process holds that case).  Then one world
of 2 gloo ranks (`run_ranks`; `tests/_torch_multihost_worker.py`, no JAX in
the ranks) plays every plan: streams, stats and engine lengths must be
byte-identical across ranks and equal to the single process
(tests/test_multihost.py:58), the sampled stream included.
"""

import concurrent.futures
import json

import jax.numpy as jnp
import pytest
import torch

from _torch_multihost_worker import play, port_engine_maker, port_mods, run_plans
from _torch_serving import TinyLlama
from _torch_tp import opt_model
from pb_llm_tpu.models.registry import family_for as jfamily_for
from pb_llm_tpu.runtime import batching as jbatching, draft as jdraft, sampler as jsampler
from pb_llm_tpu.runtime import multihost_batching as jmhb
from pb_llm_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
from pb_llm_tpu_torch.parallel.mesh import run_ranks

torch.set_num_threads(2)

REP = [7, 8, 9, 7, 8, 9, 7, 8]
SHARED = [5, 17, 99, 3, 42, 7, 11, 23]  # one full page


def _req(prompt, max_new, **kw):
    return {"prompt": prompt, "max_new": max_new, **kw}


E = dict(n_slots=2, max_seq=64, prefill_buckets=(8, 16))
PLANS = {
    # batched prefill (two same-bucket rows), eos in the record, budgets
    "strips": {"model": "llama", "ecfg": dict(E, max_prefill_batch=2), "max_prompt": 16,
               "requests": [_req([5, 17, 99, 3], 6), _req([42, 7, 11], 6, eos=9),
                            _req([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 5), _req([3, 14], 7),
                            _req([88, 1, 6], 4, stops=[11, 12])]},
    "paged_prefix": {"model": "llama", "ecfg": dict(E, page_size=8, prefix_cache=True,
                                                     max_prefill_batch=2),
                     "max_prompt": 16,
                     "requests": [_req(SHARED + [19, 4], 5), _req(SHARED + [19, 4], 5),
                                  _req(SHARED + [9], 5)]},
    # chunked prefill, eos; the sampled row's installed (decoded) params are
    # compared with JAX, its tokens only across the port's runs
    "chunked": {"model": "opt", "ecfg": dict(E, prefill_chunk=8, max_prefill_batch=2),
                "max_prompt": 16,
                "requests": [_req(REP, 10, eos=9), _req([7, 8, 9] * 4, 10, eos=9),
                             _req([3, 14, 15], 6, sampling={"temperature": 0.93712345,
                                                            "top_k": 12, "top_p": 0.91234567}),
                             _req([42, 7, 11], 6)]},
    "spec": {"model": "opt", "ecfg": dict(E, prefill_buckets=(8,), spec_gamma=3),
             "max_prompt": 16, "requests": [_req(REP, 12) for _ in range(3)]},
    "draft": {"model": "opt", "draft": "opt_draft",
              "ecfg": dict(E, prefill_buckets=(8,), spec_gamma=3), "max_prompt": 8,
              "requests": [_req([3 + 11 * i, 29, 64 + i, 90 - i], 12) for i in range(3)]},
    "too_many_stops": {"model": "opt", "ecfg": E, "max_prompt": 16,
                       "requests": [_req([5, 17], 4, stops=[1, 2, 3, 4, 5])]},
}


@pytest.fixture(scope="module")
def models():
    """name → (JAX params, JAX cfg, port params, port cfg, family)."""
    llama = TinyLlama(kv_heads=4)
    jo, jocfg, to, tocfg = opt_model()
    jd, jdcfg, td, tdcfg = opt_model(hidden=16, heads=2, seed=1)
    return {"llama": (llama.jparams, llama.jcfg, llama.tparams, llama.tcfg, "llama"),
            "opt": (jo, jocfg, to, tocfg, "opt"), "opt_draft": (jd, jdcfg, td, tdcfg, "opt")}


def _jax_engine_maker(models):
    def make(model, ecfg):
        jp, jcfg, _, _, fam = models[model]
        return JEngine(jp, jcfg, jfamily_for(fam), JEngineConfig(**ecfg, cache_dtype=jnp.float32))

    return make


@pytest.fixture(scope="module")
def runs(models):
    """(JAX's results, the port's single-process results, every rank's)."""
    trees = {k: (v[2], v[3], v[4]) for k, v in models.items()}
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        # a raise on rank 0 alone leaves the others in the next broadcast (as
        # in JAX): the stop-id limit is held in one process only
        world = {n: p for n, p in PLANS.items() if n != "too_many_stops"}
        ranks = ex.submit(run_ranks, run_plans, 2, (trees, world), "cpu", 600)
        jmods = (jbatching, jmhb, jsampler, jdraft)
        jax_out = {n: play(jmods, _jax_engine_maker(models), p) for n, p in PLANS.items()}
        single = {n: play(port_mods(), port_engine_maker(trees), p) for n, p in PLANS.items()}
        return jax_out, single, ranks.result()


SAMPLED = ("chunked", "2")  # the plan and request id of the sampled request


@pytest.mark.parametrize("name", [n for n in PLANS if n != "too_many_stops"])
def test_single_process_matches_jax(runs, name):
    """Greedy streams token for token, a sampled request's only its length
    (the engines' samplers differ; it has no eos, so its tokens move no
    stat); the stats and the engine lengths."""
    jax_out, single, _ = runs
    got, want = single[name], jax_out[name]
    sampled = SAMPLED[1] if name == SAMPLED[0] else None
    assert {k: v for k, v in got["streams"].items() if k != sampled} == \
        {k: v for k, v in want["streams"].items() if k != sampled}
    if sampled is not None:
        assert len(got["streams"][sampled]) == len(want["streams"][sampled])
    assert got["stats"] == want["stats"] and got["lengths"] == want["lengths"]
    if name in ("spec", "draft"):
        assert got["stats"][4] > 0  # drafts were accepted


def test_sampled_request_installs_the_decoded_fixed_point(runs):
    jax_out, single, _ = runs
    got = single[SAMPLED[0]]["installed"]
    assert got == jax_out[SAMPLED[0]]["installed"]
    assert [0.937123, 12, 0.912346] in got


def test_more_than_four_stop_ids_raise(runs):
    jax_out, single, _ = runs
    assert jax_out["too_many_stops"] == single["too_many_stops"] == {"raises": "ValueError"}


@pytest.mark.parametrize("name", [n for n in PLANS if n != "too_many_stops"])
def test_ranks_byte_identical_and_equal_to_one_process(runs, name):
    _, single, ranks = runs
    assert ranks[0][name] == ranks[1][name]  # streams, stats, lengths: the same bytes
    assert json.loads(ranks[0][name]) == json.loads(json.dumps(single[name]))
