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
from pb_llm_tpu_torch.runtime import step_graph

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
        self.forwards = 0

    def _run(self, ids, caches, pos):
        self.forwards += 1
        packed_matmul.launches += 7
        packed_matmul.prep_launches += 7
        return (ids + pos[:, None]).float()[:, :, None]


def test_graph_counters_restore_after_capture_and_add_per_replay(monkeypatch):
    monkeypatch.setattr(step_graph.StepGraph, "graph_cls", _StandInGraph)
    monkeypatch.setattr(step_graph, "capture", lambda graph: contextlib.nullcontext())
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
    assert sg.deltas["pb_int8_matmul"] == sg.deltas["pb_prep_int8"] == 7
    assert sum(v != 0 for v in sg.deltas.values()) == 2
    assert out is sg.logits
    with step_graph.eager():
        sg(tok, pos)
    assert eng.forwards == 3 and sg.replays == 3
    assert launched() == (start[0] + 35, start[1] + 35)


def test_failed_capture_restores_the_counters_and_keeps_no_graph(monkeypatch):
    monkeypatch.setattr(step_graph.StepGraph, "graph_cls", _StandInGraph)
    monkeypatch.setattr(step_graph, "capture", lambda graph: contextlib.nullcontext())
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
