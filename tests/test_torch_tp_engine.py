"""Port parity of tensor-parallel serving (`pb_llm_tpu_torch.runtime.tp_engine`,
`parallel.collectives`) at tp = 4 on gloo, against the JAX package.

One module fixture spawns the four rank processes once (`parallel.mesh.run_ranks`;
the ranks run `tests/_torch_tp_worker.py`, which imports no JAX) and plays
every scenario there while this process plays the same plans on the JAX
engines.  JAX's tests/test_tp_engine.py compositions (decode, prefill then
decode, continuous batching, int8 strips, paged, the 256-row prefill,
batched prefill over strips and pages, the prefix cache, scan_layers, int8
pages), chunked prefill (tests/test_chunked_prefill.py:109), speculative
decoding (tests/test_spec_decode.py:214) and per-request sampling
(tests/test_sampling.py:174) are held to JAX's single-device `Engine`, as
JAX holds its own TP engine; MULTICHIP_r05.json's two compositions,
"serving" (TP = 4 PBW v2 + paged KV + batched prefill + speculative
decoding) and "scan x TP", to JAX's `TPEngine` on the same tree.  Greedy
streams must be equal token for token, and every rank's results equal rank
0's.  A grouped PBW-v1 OPT (row-parallel group scales), and it and the
dense OPT over stacked layers (stacked row-parallel biases), are held to
the single-device engine too.  The collectives are held to JAX's
`column_parallel_pb_matmul` / `row_parallel_pb_matmul` within JAX's own
bounds (tests/test_sharding.py), PBW v2 to JAX's single-device matmul.
"""

import concurrent.futures
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tp import TP, families, llama_model, opt_model, pack_one, to_jax_layer
from _torch_tp_worker import play, run_scenarios
from pb_llm_tpu.ops.binary_matmul import pb_matmul as jpb_matmul
from pb_llm_tpu.parallel import collectives as jcoll, mesh as jmesh
from pb_llm_tpu.runtime import batching as jbatching, sampler as jsampler
from pb_llm_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
from pb_llm_tpu.runtime.tp_engine import TPEngine as JTPEngine
from pb_llm_tpu_torch.parallel.mesh import run_ranks
from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

torch.set_num_threads(2)

COLL_TOL = dict(atol=1e-3, rtol=1e-4)  # JAX's bounds for its collectives (tests/test_sharding.py)


def _prompts(seed, n, length):
    return [[int(t) for t in p] for p in np.random.default_rng(seed).integers(0, 128, (n, length))]


def _steps(prefills, steps):
    return {"kind": "steps", "prefills": prefills, "steps": steps}


def _batch(prompts, max_new, sampling=None):
    return {"kind": "batcher",
            "requests": [(p, max_new, (sampling or {}).get(i)) for i, p in enumerate(prompts)]}


E = dict(n_slots=2, max_seq=32, prefill_buckets=(8,), cache_dtype="f32")
# engines shared by several compositions (each package builds one engine a
# config): strips with batched prefill; pages with batched prefill and the
# prefix cache (two slots: a request admitted after a retirement hits the
# prefix an earlier one registered)
ES = dict(E, n_slots=4, max_prefill_batch=4)
EP = dict(E, prefill_buckets=(8, 16), page_size=8, prefix_cache=True, max_prefill_batch=4)
# the kernels' plain versions at the shard shapes (a layer no arm takes runs
# the reference matmul, as in JAX)
PLAIN_KERNELS = dict(backend="pallas_interpret", decode_dot="f32", prefill="hybrid",
                     attention="xla")
SHARED = [5, 17, 99, 3, 42, 7, 11, 23]  # one full page
CHUNK_PROMPT = [5, 17, 99, 3, 42, 7, 11, 23, 60, 2, 19, 88, 41, 6, 77, 31, 12, 9]
SCENARIOS = [
    dict(name="decode", model="v1", ecfg=ES, plan=_steps([(0, _prompts(1, 2, 6)[0]),
                                                           (1, _prompts(1, 2, 6)[1])], 3)),
    dict(name="prefill_then_decode", model="v1", ecfg=ES,
         plan=_steps([(0, _prompts(2, 1, 5)[0]), (1, _prompts(2, 1, 7)[0])], 2)),
    dict(name="continuous_batching", model="v1", ecfg=ES, plan=_batch(_prompts(7, 5, 4), 6)),
    dict(name="int8_strips", model="v1", ecfg=dict(E, n_slots=1, cache_dtype="int8"),
         plan=_steps([(0, [5, 17, 42])], 3)),
    dict(name="paged", model="v1", ecfg=EP, plan=_batch(_prompts(9, 4, 5), 6)),
    dict(name="prefill_256", model="v1", kernels=PLAIN_KERNELS,
         ecfg=dict(E, n_slots=1, max_seq=320, prefill_buckets=(256,)),
         plan=_steps([(0, _prompts(5, 1, 40)[0])], 3)),
    dict(name="batched_prefill_strips", model="v1", ecfg=ES, plan=_batch(_prompts(13, 5, 6), 5)),
    dict(name="batched_prefill_paged", model="v1", ecfg=EP, plan=_batch(_prompts(13, 5, 6), 5)),
    dict(name="prefix_cache", model="v1", ecfg=EP,
         plan=_batch([SHARED + [19, 4], SHARED + [19, 4], SHARED + [9]], 5)),
    dict(name="scan_layers", model="v2", kernels=PLAIN_KERNELS, ecfg=dict(E, scan_layers=True),
         ref_ecfg=E, plan=_batch(_prompts(21, 4, 5), 5)),
    dict(name="int8_paged", model="v1", ecfg=dict(E, page_size=8, cache_dtype="int8"),
         plan=_steps([(0, [5, 17, 42, 3])], 3)),
    dict(name="chunked_strips", model="opt",
         ecfg=dict(E, max_seq=48, prefill_buckets=(8, 16, 32), prefill_chunk=8),
         plan=_batch([CHUNK_PROMPT], 5)),
    dict(name="chunked_paged", model="opt",
         ecfg=dict(E, max_seq=48, prefill_buckets=(8, 16, 32), prefill_chunk=8, page_size=8),
         plan=_batch([CHUNK_PROMPT], 5)),
    dict(name="spec", model="opt", ecfg=dict(E, max_seq=64, spec_gamma=3),
         ref_ecfg=dict(E, max_seq=64), plan={"kind": "spec", "prompt": [5, 17, 99, 3], "n": 9,
                                             "gamma": 3},
         ref_plan=_steps([(0, [5, 17, 99, 3])], 8)),
    dict(name="per_request_sampling", model="opt", ecfg=dict(E, max_seq=64),
         plan=_batch([[5, 17, 99, 3], [42, 7, 11]], 8, {1: {"temperature": 0.9, "top_k": 8}}),
         ref_plan=_batch([[5, 17, 99, 3]], 8)),
    dict(name="grouped_v1", model="v1g", ecfg=E, plan=_batch(_prompts(7, 5, 4), 6)),
    # stacked row-parallel biases (dense and PBW v1), added once after the sum
    dict(name="scan_layers_opt", model="opt", ecfg=dict(E, max_seq=64, scan_layers=True),
         ref_ecfg=dict(E, max_seq=64), plan=_batch(_prompts(25, 3, 5), 5)),
    dict(name="scan_layers_grouped_v1", model="v1g", ecfg=dict(E, scan_layers=True), ref_ecfg=E,
         plan=_batch(_prompts(27, 3, 4), 5)),
    # MULTICHIP_r05.json's "serving" and "scan x TP": held to JAX's TPEngine
    dict(name="serving", model="v2", ref="jax_tp",
         ecfg=dict(E, n_slots=4, max_seq=64, prefill_buckets=(16,), page_size=16,
                   max_prefill_batch=4, spec_gamma=2),
         plan=_batch([[3 + i, 7, 11, 2 + i] for i in range(6)], 4)),
    dict(name="scan_x_tp", model="v2", ref="jax_tp",
         ecfg=dict(E, page_size=8, max_prefill_batch=2, scan_layers=True),
         plan=_batch(_prompts(23, 4, 5), 4)),
]
_JDT = {"f32": jnp.float32, "int8": jnp.int8}
_TDT = {"f32": torch.float32, "int8": torch.int8}


def _models():
    """name → (JAX tree, JAX cfg, port tree, port cfg, family name)."""
    return {"v1": (*llama_model("v1"), "llama"),
            "v1g": (*opt_model("v1", hidden=128, heads=8, groupsize=32), "opt"),
            "v2": (*llama_model("v2", ic_shards=TP), "llama"),
            "opt": (*opt_model("dense"), "opt")}


def _layers():
    """name → (x, port layer, kind) for the collectives, and the JAX
    results to hold them to."""
    rng = np.random.default_rng(3)
    x = lambda ic: rng.standard_normal((4, ic)).astype(np.float32)  # noqa: E731
    w = lambda ic, oc: rng.standard_normal((ic, oc)).astype(np.float32) * 0.05  # noqa: E731
    b = lambda oc: rng.standard_normal(oc).astype(np.float32) * 0.1  # noqa: E731
    layers = {
        "col_v1": (x(256), pack_one(w(256, 512), "xnor", "v1", 1, bias=b(512)), "col"),
        "row_v1": (x(1024), pack_one(w(1024, 128), "xnor", "v1", 2, bias=b(128),
                                     pack_block=256), "row"),
        "col_v2": (x(128), pack_one(w(128, 512), "xnor", "v2", 3, bias=b(512)), "col"),
        "row_v2": (x(512), pack_one(w(512, 128), "xnor", "v2", 4, bias=b(128),
                                    ic_shards=TP), "row"),
    }
    jm = jmesh.make_mesh(dp=1, tp=TP)
    want = {}
    for name, (xv, p, kind) in layers.items():
        if name.endswith("v2"):  # JAX's collectives take PBW v1 only
            fn = jpb_matmul
        elif kind == "col":
            fn = lambda x, p: jcoll.column_parallel_pb_matmul(x, p, jm, gather=True)  # noqa: E731
        else:
            fn = lambda x, p: jcoll.row_parallel_pb_matmul(x, p, jm)  # noqa: E731
        # jitted: an eager shard_map runs op by op (~10 s a call)
        want[name] = np.asarray(jax.jit(fn)(jnp.asarray(xv), to_jax_layer(p)))
    return layers, want


def _jax_refs(models) -> dict:
    out, engines = {}, {}
    for sc in SCENARIOS:
        jtree, jcfg = models[sc["model"]][:2]
        fam = families(models[sc["model"]][4])[0]
        ekw = dict(sc.get("ref_ecfg", sc["ecfg"]))
        ekw["cache_dtype"] = _JDT[ekw["cache_dtype"]]
        key = (sc["model"], sc.get("ref"), repr(ekw))
        if key not in engines:
            ecfg = JEngineConfig(**ekw)
            engines[key] = (JTPEngine(copy.deepcopy(jtree), jcfg, fam, ecfg,
                                      jmesh.make_mesh(dp=1, tp=TP))
                            if sc.get("ref") == "jax_tp" else
                            JEngine(copy.deepcopy(jtree), jcfg, fam, ecfg))
        out[sc["name"]] = play(engines[key], sc.get("ref_plan", sc["plan"]), jbatching, jsampler)
    return out


@pytest.fixture(scope="module")
def runs():
    """(JAX results, each rank's results, models, JAX collective results)."""
    models = _models()
    trees = {k: (m[2], m[3], m[4]) for k, m in models.items()}
    scenarios = [dict(sc, ecfg=dict(sc["ecfg"], cache_dtype=_TDT[sc["ecfg"]["cache_dtype"]]))
                 for sc in SCENARIOS]
    layers, want = _layers()
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_ranks, run_scenarios, TP, (trees, scenarios, layers), "cpu", 900)
        refs = _jax_refs(models)  # meanwhile, on this process
        return refs, ranks.result(), models, want


def _ranks_agree(ranks, name):
    for r in range(1, TP):
        a, b = ranks[0][name], ranks[r][name]
        assert a["streams"] == b["streams"], (name, r)
        assert {k: v for k, v in a.items() if k != "cache_specs"} == \
            {k: v for k, v in b.items() if k != "cache_specs"}, (name, r)


@pytest.mark.parametrize("name", [sc["name"] for sc in SCENARIOS])
def test_tp_engine_streams_equal_jax(runs, name):
    refs, ranks, _, _ = runs
    _ranks_agree(ranks, name)
    got, want = ranks[0][name], refs[name]
    if name == "per_request_sampling":  # the greedy request's stream; the sampled one in vocab
        assert got["streams"][0] == want["streams"][0]
        assert len(got["streams"][1]) == 8 and all(0 <= t < 128 for t in got["streams"][1])
        return
    assert got["streams"] == want["streams"], (name, got["streams"], want["streams"])
    if got.get("done") is not None:
        assert got["done"] and got["prefills"] == want["prefills"]
        assert got["spec_drafted"] == want["spec_drafted"]
        assert got["prefix_hit_pages"] == want["prefix_hit_pages"]
        assert got["pages_free"] in (None, True)


def test_tp_engine_compositions_take_their_paths(runs):
    """The scenarios reach what they are named for: batched prefill
    prefills every request, the prefix cache hits, the serving mix
    drafts, pages return to the pool."""
    _, ranks, _, _ = runs
    r = ranks[0]
    assert r["batched_prefill_paged"]["prefills"] == 5
    assert r["prefix_cache"]["prefix_hit_pages"] > 0
    assert r["serving"]["spec_drafted"] > 0 and r["serving"]["pages_free"]
    assert r["scan_x_tp"]["pages_free"]


@pytest.mark.parametrize("name", ["int8_strips", "int8_paged", "scan_layers", "paged"])
def test_tp_caches_hold_the_ranks_kv_heads(runs, name):
    """Each rank's caches are the single-device engine's with the tp axis
    of `tp_engine._cache_spec_for_key` divided by tp: strips (int8 scales
    too), pages (int8 scale pages, the shared table) and stacked caches."""
    _, ranks, models, _ = runs
    sc = next(s for s in SCENARIOS if s["name"] == name)
    _, _, ttree, tcfg, fam = models[sc["model"]]
    ekw = dict(sc["ecfg"], cache_dtype=_TDT[sc["ecfg"]["cache_dtype"]])
    full = Engine(ttree, tcfg, families(fam)[1], EngineConfig(**ekw), device="cpu").caches
    got, specs = ranks[0][name]["cache_shapes"], ranks[0][name]["cache_specs"]
    pairs = [(full, got, specs)] if isinstance(full, dict) else zip(full, got, specs)
    for f, g, s in pairs:
        assert set(f) == set(g)
        for k in f:
            want = tuple(n // TP if ax == "tp" else n for n, ax in
                         zip(f[k].shape, tuple(s[k]) + (None,) * f[k].dim()))
            assert g[k] == want, (name, k, g[k], want)


@pytest.mark.parametrize("name", ["col_v1", "row_v1", "col_v2", "row_v2"])
def test_collectives_equal_jax(runs, name):
    """Column-parallel (each rank's oc block, and gathered) and row-parallel
    (all-reduced, the bias once) equal JAX's within its bounds."""
    _, ranks, _, want = runs
    for r in range(TP):
        got = ranks[r][name]
        if name.startswith("col"):
            np.testing.assert_allclose(got["gathered"], want[name], **COLL_TOL)
            blk = want[name].shape[1] // TP
            np.testing.assert_allclose(got["local"], want[name][:, r * blk:(r + 1) * blk],
                                       **COLL_TOL)
            np.testing.assert_array_equal(got["gathered"], ranks[0][name]["gathered"])
        else:
            np.testing.assert_allclose(got["y"], want[name], **COLL_TOL)
            np.testing.assert_array_equal(got["y"], ranks[0][name]["y"])
