"""The decode step's static buffers, its graph's counter bookkeeping and
`eager()` (`pb_llm_tpu_torch/runtime/step_graph.py`), and the int8 path's x
preparation (`packed_matmul.prepare_int8_plain`) against the JAX package.

On the CPU nothing is captured: the engine's decode step runs the forward
from the step's static buffers, so every engine test here drives that code;
the capture itself is driven with a stand-in for `torch.cuda.CUDAGraph`.
The card's side (graph = eager bit for bit, the x-preparation kernel) is in
`tests/test_torch_cuda_kernels.py`.

Tolerances: the int8 codes and scales are bit for bit JAX's (the same IEEE
division and rounding half to even); the row sums are f32 sums on both
sides, in other orders: 1e-6 of the largest sum of |x| (some 9 roundings
of 2^-24 at these widths, for each side's pairwise sums).  The
int8 matmul keeps test_torch_packed_matmul.py's bound, 1e-5 of max|y|.
Engine streams: greedy tokens equal, prefill logits within rtol = atol =
1e-4 of JAX's, the paged engine tests' bound (test_torch_paged.py; a
prefix hit reads int8-quantized K/V on both sides).
"""

import contextlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.core import pbw as jpbw
from pb_llm_tpu.ops import pallas_pb
from pb_llm_tpu.quant.high_quant import high_calibrate, high_quantize
from pb_llm_tpu.quant.low_quant import low_calibrate, low_quantize
from pb_llm_tpu_torch.interop import packed_from_fields
from pb_llm_tpu_torch.ops import counters, packed_matmul
from pb_llm_tpu_torch.runtime import step_graph, tracing
from pb_llm_tpu_torch.runtime.engine import EngineCounts

from _torch_serving import TinyLlama, greedy, random_prompts, serve

torch.set_num_threads(2)


def _layer(oc, ic, col_tile=0, high_bits=8, ic_shards=1, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((oc, ic)).astype(np.float32)
    mask = np.asarray(jpbw.column_structured_mask(jnp.abs(jnp.asarray(w)), 0.9, col_tile,
                                                  ic_shards=ic_shards))
    low = low_calibrate(jnp.asarray(w * mask), "xnor", -1)
    high = high_calibrate(jnp.asarray(w), bits=high_bits)
    w_q = np.where(mask, np.asarray(low_quantize(jnp.asarray(w), low, "xnor", -1)),
                   np.asarray(high_quantize(jnp.asarray(w), high)))
    jp, _ = jpbw.pack_linear_v2(jnp.asarray(w_q), jnp.asarray(mask), low, high, "xnor",
                                col_tile=col_tile, ic_shards=ic_shards,
                                pack_block=ic // ic_shards)
    return jp, packed_from_fields(jp)


PREP_LAYERS = {
    "side8": dict(oc=256, ic=256),
    "side4_rowgroups": dict(oc=256, ic=256, col_tile=128, high_bits=4),
    "shards2": dict(oc=128, ic=512, ic_shards=2),
}


@pytest.fixture(scope="module")
def prep_layers():
    return {name: _layer(**kw) for name, kw in PREP_LAYERS.items()}


@pytest.mark.parametrize("name", sorted(PREP_LAYERS))
@pytest.mark.parametrize("m", [4, 300])
def test_prepare_int8_plain_matches_jax_x_preparation(prep_layers, name, m):
    """`_planar_v2_int8_call`'s x preparation (pallas_pb.py:478-490)."""
    jp, tp = prep_layers[name]
    x = np.random.default_rng(m).standard_normal((m, jp.ic)).astype(np.float32)
    x[0, :5] = [0.5, 1.5, 2.5, -0.5, 3.0]
    x[1] = 0.0
    xp = jnp.asarray(x)
    sx = jnp.maximum(jnp.max(jnp.abs(xp), axis=1, keepdims=True), 1e-30) / 127.0
    x8 = jnp.clip(jnp.round(xp / sx), -127, 127).astype(jnp.int8)
    xg = jnp.transpose(jpbw.gather_x_v2(xp, jp), (2, 0, 1))
    xg8 = jnp.clip(jnp.round(xg / sx), -127, 127).astype(jnp.int8)
    ops = packed_matmul.prepare_int8_plain(torch.from_numpy(x), tp)
    np.testing.assert_array_equal(ops.x8.numpy(), np.asarray(x8))
    np.testing.assert_array_equal(ops.sx.numpy(), np.asarray(sx)[:, 0])
    np.testing.assert_array_equal(ops.xg8.numpy(), np.asarray(xg8))
    np.testing.assert_allclose(ops.rs.numpy(), np.asarray(jnp.sum(xp, axis=1)), rtol=0,
                               atol=1e-6 * np.abs(x).sum(axis=1).max())
    np.testing.assert_allclose(ops.rsg.numpy(), np.asarray(jnp.sum(xg, axis=2)), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(xg)).sum(axis=2).max())
    with jax.default_matmul_precision("float32"):
        want = np.asarray(pallas_pb.pb_matmul_pallas_v2(
            xp, jp, interpret=True, decode_dot="int8", prefill_int8=True))
    got = packed_matmul.pb_int8_matmul(torch.from_numpy(x), tp).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_prepare_int8_on_the_cpu_is_the_plain_version(prep_layers):
    _, tp = prep_layers["side8"]
    x = torch.randn((3, 256), generator=torch.Generator().manual_seed(0))
    before = packed_matmul.prep_launches
    got, want = packed_matmul.prepare_int8(x, tp), packed_matmul.prepare_int8_plain(x, tp)
    assert packed_matmul.prep_launches == before
    assert got.layout == want.layout == "dp4a"
    assert all(torch.equal(a, b) for a, b in zip(got[:-1], want[:-1]))  # the tensors


# ---------------------------------------------------------------------------
# the engine's static-buffer step against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    return TinyLlama()


@pytest.mark.parametrize("kw", [dict(), dict(page_size=8), dict(page_size=8, prefix_cache=True,
                                                                 cache_dtype="int8")],
                         ids=["strips", "pages", "int8_pages_prefix"])
def test_static_buffer_step_matches_the_jax_engine(tiny, kw):
    """Served streams and a slot's greedy run (prefill logits, tokens) equal
    JAX's engine; the port's decode steps ran from the step's buffers."""
    ekw = dict(n_slots=3, max_seq=128, prefill_buckets=(16, 64), **kw)
    prompts = random_prompts(5, (5, 40, 12, 30, 20))
    port, jeng = tiny.port_engine(**ekw), tiny.jax_engine(**ekw)
    got, _ = serve(port, prompts, 9)
    want, _ = serve(jeng, prompts, 9)
    assert got == want
    pt, pl = greedy(port, prompts[1], 6)
    jt, jl = greedy(jeng, prompts[1], 6)
    assert pt == jt
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-4)
    step = port._step
    assert step.graph is None and step.replays == 0 and not step.capturable
    assert step.buf.shape == (2, 3) and step.ids.data_ptr() == step.buf.data_ptr()


def test_a_step_refuses_replaced_params_or_caches(tiny):
    """The step reads the engine's params and caches in place (its graph
    holds their addresses): a step after they were replaced raises, and no
    engine method replaces them."""
    eng = tiny.port_engine(n_slots=2, max_seq=128, prefill_buckets=(16, 64), page_size=8,
                           prefix_cache=True, prefill_chunk=16, spec_gamma=2)
    params, caches = eng.params, eng.caches
    serve(eng, random_prompts(6, (5, 40, 12)), 6)
    eng.start_chunked_prefill(0, random_prompts(7, (40,))[0])
    while eng.prefill_chunk_step(0) is None:
        pass
    eng.decode_step()
    eng.spec_decode_step(np.zeros((2, 2), np.int64))
    eng.release(0)
    assert eng.params is params and eng.caches is caches
    eng.prefill(1, [1, 2, 3])
    eng.caches = list(eng.caches)
    with pytest.raises(RuntimeError, match="replaced"):
        eng.decode_step()


# ---------------------------------------------------------------------------
# the graph's counter bookkeeping, with a stand-in for torch.cuda.CUDAGraph
# ---------------------------------------------------------------------------

class _StandInGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _FakeEngine:
    """An engine whose forward counts launches as kernel wrappers do."""

    def __init__(self):
        self.ecfg = type("E", (), {"n_slots": 2})()
        self.device = torch.device("cpu")
        self.params, self.caches = {}, []
        self.counts = EngineCounts()
        self.forwards = 0

    def _run(self, ids, caches, pos):
        self.forwards += 1
        packed_matmul.launches += 7
        packed_matmul.prep_launches += 7
        return (ids + pos[:, None]).float()[:, :, None]


def test_graph_counters_restore_after_capture_and_add_per_replay(monkeypatch):
    monkeypatch.setattr(step_graph.StepGraph, "graph_cls", _StandInGraph)
    monkeypatch.setattr(step_graph, "capture", lambda graph, fn, pool: fn())
    eng = _FakeEngine()
    sg = step_graph.StepGraph(eng)
    sg.capturable = True
    keys = ("pb_int8_matmul", "pb_prep_int8")

    def launched():
        now = counters.read(totals=True)
        return tuple(now[k] for k in keys)

    tok, pos = np.array([3, 4], np.int32), np.array([0, 5], np.int32)
    start = launched()
    for step in range(1, 5):
        out = sg(tok, pos)
        assert launched() == (start[0] + 7 * step, start[1] + 7 * step)
    # the eager first step and the capture ran the forward; replays did not
    assert eng.forwards == 2 and sg.replays == 3 and sg.graph.replays == 3
    assert eng.counts.graph_captures == 1
    assert sg.deltas["pb_int8_matmul"] == sg.deltas["pb_prep_int8"] == 7
    assert sum(v != 0 for v in sg.deltas.values()) == 2
    assert out is sg.logits
    with step_graph.eager():
        sg(tok, pos)
    assert eng.forwards == 3 and sg.replays == 3
    assert launched() == (start[0] + 35, start[1] + 35)


def test_failed_capture_restores_the_counters_and_keeps_no_graph(monkeypatch):
    monkeypatch.setattr(step_graph.StepGraph, "graph_cls", _StandInGraph)
    monkeypatch.setattr(step_graph, "capture", lambda graph, fn, pool: fn())
    eng = _FakeEngine()
    sg = step_graph.StepGraph(eng)
    sg.capturable = True
    tok, pos = np.zeros(2, np.int32), np.zeros(2, np.int32)
    sg(tok, pos)
    before = counters.read(totals=True)

    def failing(ids, caches, p):
        packed_matmul.launches += 7
        raise RuntimeError("operation not permitted when stream is capturing")

    eng._run = failing
    with pytest.raises(RuntimeError, match="capturing"):
        sg(tok, pos)
    assert counters.read(totals=True) == before and sg.graph is None


# ---------------------------------------------------------------------------
# the strip prefill's graphs, one a (K, bucket) shape, with stand-in graphs
# ---------------------------------------------------------------------------

class _PooledStandIn(_StandInGraph):
    def pool(self):
        return ("pool of", id(self))


class _FakePrefillEngine(_FakeEngine):
    """An engine whose strip prefill counts launches as kernel wrappers do
    and returns a row a prompt that its ids, slot and last row decide."""

    def _strip_prefill(self, ids, slots, last):
        self.forwards += 1
        packed_matmul.launches += 3
        return (ids.sum(1) + 1000 * slots + last).float()[:, None]


def _prefill_call(pg, k, bucket, seed):
    r = np.random.default_rng(seed)
    ids = r.integers(0, 100, (k, bucket))
    slots, last = r.permutation(4)[:k], r.integers(0, bucket, k)
    return pg(pg.load(ids, slots, last)), ids.sum(1) + 1000 * slots + last


def test_prefill_graphs_capture_each_shape_once_then_replay(monkeypatch):
    """A shape's first call runs eagerly and captures (into the pool the
    first graph made), every later call replays and returns a copy of the
    graph's output; the launch counters are restored after each capture
    and each replay adds its capture's launches."""
    monkeypatch.setattr(step_graph.PrefillGraphs, "graph_cls", _PooledStandIn)
    pools = []
    monkeypatch.setattr(step_graph, "capture",
                        lambda graph, fn, pool: (pools.append(pool), fn())[1])
    eng = _FakePrefillEngine()
    pg = step_graph.PrefillGraphs(eng)
    pg.capturable = True
    start = counters.read(totals=True)["pb_int8_matmul"]
    shapes = [(2, 8), (1, 8), (2, 8), (2, 16), (1, 8), (2, 16), (2, 8)]
    for n, (k, bucket) in enumerate(shapes, 1):
        out, want = _prefill_call(pg, k, bucket, n)
        first = shapes.index((k, bucket)) == n - 1
        if first:  # the eager run's own logits
            np.testing.assert_array_equal(out[:, 0].numpy(), want)
        shape = pg.shapes[(k, bucket)]
        assert out is not shape.logits and torch.equal(out, shape.logits)
        assert counters.read(totals=True)["pb_int8_matmul"] == start + 3 * n
    # three shapes: an eager run and a capture each; four replays
    assert eng.forwards == 6 and eng.counts.graph_captures == 3
    assert eng.counts.prefill_replays == 4
    assert [pg.shapes[s].graph.replays for s in [(2, 8), (1, 8), (2, 16)]] == [2, 1, 1]
    assert all(s.deltas["pb_int8_matmul"] == 3 and sum(s.deltas.values()) == 3
               for s in pg.shapes.values())
    first_pool = pg.shapes[(2, 8)].graph.pool()
    assert pools == [None, first_pool, first_pool] and pg.pool == first_pool


def test_failed_prefill_capture_restores_the_counters_and_keeps_no_graph(monkeypatch):
    monkeypatch.setattr(step_graph.PrefillGraphs, "graph_cls", _PooledStandIn)

    def failing(graph, fn, pool):
        packed_matmul.launches += 7
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(step_graph, "capture", failing)
    eng = _FakePrefillEngine()
    pg = step_graph.PrefillGraphs(eng)
    pg.capturable = True
    before = counters.read(totals=True)
    with pytest.raises(RuntimeError, match="capturing"):
        _prefill_call(pg, 2, 8, 0)
    after = counters.read(totals=True)
    assert after["pb_int8_matmul"] == before["pb_int8_matmul"] + 3  # the eager run's
    assert {k: v for k, v in after.items() if k != "pb_int8_matmul"} == {
        k: v for k, v in before.items() if k != "pb_int8_matmul"}
    assert pg.shapes[(2, 8)].graph is None and pg.pool is None
    assert eng.counts.graph_captures == 0 and eng.counts.prefill_replays == 0


class _RerunGraph:
    """A stand-in graph whose replay re-runs the captured call, reading the
    static buffers, into the graph's output (see `_rerun_capture`)."""

    def pool(self):
        return "the prefill pool"

    def replay(self):
        self.out.copy_(self.body())


def _rerun_capture(graph, fn, pool):
    graph.body, graph.out = fn, fn()
    return graph.out


def _prefill_children(ns0):
    return [[k.name for k in tracing.children(p)]
            for p in tracing.spans("engine.prefill", ns0=ns0)]


def test_graphed_strip_prefill_equals_the_eager_engine(tiny, monkeypatch):
    """Two calls of one (K, bucket) shape with other prompts, lengths and
    slots, graphed (the second a replay) against an eager engine: the
    same first tokens, prefill logits and strip rows and scales; a third
    call, a replay, leaves the kept logits of the first two as they were,
    and teacher-forced decodes after it score as the eager engine's."""
    monkeypatch.setattr(step_graph.PrefillGraphs, "graph_cls", _RerunGraph)
    monkeypatch.setattr(step_graph, "capture", _rerun_capture)
    ekw = dict(n_slots=6, max_seq=128, prefill_buckets=(16, 64), cache_dtype="int8")
    graphed, eager = tiny.port_engine(**ekw), tiny.port_engine(**ekw)
    graphed._prefill.capturable = True
    p = random_prompts(11, (5, 14, 9, 16, 12, 3))
    calls = [[(0, p[0]), (2, p[1])], [(3, p[2]), (1, p[3])], [(5, p[4]), (4, p[5])]]
    ns0 = time.time_ns()
    for n, pairs in enumerate(calls):
        if n == 2:
            kept = {s: graphed._prefill_logits[s].clone() for s in range(4)}
        assert graphed.prefill_batch(pairs) == eager.prefill_batch(pairs)
        for s, _ in pairs:
            assert torch.equal(graphed._prefill_logits[s], eager._prefill_logits[s])
        for g, e in zip(graphed.caches, eager.caches):
            assert g.keys() == e.keys() == {"k", "v", "k_scale", "v_scale"}
            assert all(torch.equal(g[k], e[k]) for k in g)
    assert all(torch.equal(graphed._prefill_logits[s], kept[s]) for s in kept)
    assert graphed.counts.graph_captures == 1 and graphed.counts.prefill_replays == 2
    assert eager.counts.graph_captures == eager.counts.prefill_replays == 0
    children = _prefill_children(ns0)  # the graphed engine's call, then the eager one's
    replayed = ["prefill.gather", "prefill.replay", "prefill.finish"]
    assert children[0::2] == [["prefill.gather", "prefill.forward", "prefill.capture",
                                "prefill.finish"], replayed, replayed]
    assert children[1::2] == 3 * [["prefill.gather", "prefill.forward", "prefill.scatter",
                                   "prefill.finish"]]
    forced = random_prompts(12, (6,))[0]
    for s in (3, 0):
        assert graphed.forced_decode_nll(s, forced) == eager.forced_decode_nll(s, forced)


def test_no_prefill_graph_under_eager_or_on_pages(tiny, monkeypatch):
    """Under `eager()`, and on the paged pool, a capturable engine's
    prefill runs op by op with the eager spans and captures nothing."""
    monkeypatch.setattr(step_graph.PrefillGraphs, "graph_cls", _RerunGraph)
    monkeypatch.setattr(step_graph, "capture", _rerun_capture)
    eager_children = ["prefill.gather", "prefill.forward", "prefill.scatter", "prefill.finish"]
    p = random_prompts(13, (5, 14))
    for kw in (dict(), dict(page_size=8)):
        eng = tiny.port_engine(n_slots=2, max_seq=128, prefill_buckets=(16, 64), **kw)
        eng._prefill.capturable = True
        ns0 = time.time_ns()
        for _ in range(2):
            with step_graph.eager() if not kw else contextlib.nullcontext():
                eng.prefill_batch([(0, p[0]), (1, p[1])])
            eng.release(0), eng.release(1)
        want = eager_children if not kw else [c for c in eager_children if c != "prefill.scatter"]
        assert _prefill_children(ns0) == [want, want]
        assert not eng._prefill.shapes and eng.counts.graph_captures == 0
        assert eng.counts.prefill_replays == 0


def test_eager_nests_and_restores():
    assert not step_graph.is_eager()
    with step_graph.eager():
        assert step_graph.is_eager()
        with step_graph.eager():
            assert step_graph.is_eager()
        assert step_graph.is_eager()
    assert not step_graph.is_eager()
    with pytest.raises(ValueError):
        with step_graph.eager():
            raise ValueError
    assert not step_graph.is_eager()


def test_counter_registry_names_every_wrapper_counter():
    """Every module-level launch counter of the kernel wrappers is in the
    registry (a counter it missed would drift under replay)."""
    import importlib
    import pkgutil

    import pb_llm_tpu_torch.ops as ops

    named = {(m, a) for m, a in {**counters.KERNELS, **counters.TOTALS}.values()}
    found = set()
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"pb_llm_tpu_torch.ops.{info.name}")
        for attr, val in vars(mod).items():
            if attr.endswith("launches") and isinstance(val, int):
                found.add((info.name, attr))
    assert found == named
