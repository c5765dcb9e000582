"""The serving path's span recorder (`pb_llm_tpu_torch.runtime.tracing`).

CPU tests serve a handful of greedy requests through `ServingLoop` on a
2-layer llama (hidden 64, random dense weights from a seed) and read the
spans back: nesting and order, the prefill rows against each call's
prompts and bucket, a chunked prefill's rows, the decode rows against the
streams, `BatcherStats` against the span sums, the times against the
clock, a small ring that wraps, the switch, and writes from many threads.

The one `cuda` test (it imports no JAX) shows that spans share the device
trace's clock: a span around a kernel launch and a synchronisation holds
that kernel's interval in a CUDA-only `torch.profiler` trace.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import collections
import contextlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pb_llm_tpu_torch.models.llama import LlamaConfig, init_params
from pb_llm_tpu_torch.models.registry import family_for
from pb_llm_tpu_torch.runtime import step_graph, tracing
from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig
from pb_llm_tpu_torch.runtime.multihost_batching import MultiHostBatcher
from pb_llm_tpu_torch.runtime.server import ServingLoop

torch.set_num_threads(2)

CFG = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=256)
ECFG = dict(n_slots=3, max_seq=64, prefill_buckets=(8, 16, 32), max_prefill_batch=2,
            cache_dtype=torch.float32)
LENS = (5, 8, 12, 3, 20, 7, 30)
MAX_NEW = (4, 6, 3, 5, 2, 6, 3)
PROMPTS = [np.random.default_rng(7 + i).integers(0, 128, n).tolist() for i, n in enumerate(LENS)]

DECODE_CHILDREN = ["step_graph.copy_in", "step_graph.eager", "decode.sample", "decode.read",
                   "decode.slots"]
PREFILL_CHILDREN = ["prefill.gather", "prefill.forward", "prefill.scatter", "prefill.finish"]


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


Served = collections.namedtuple("Served", "reqs stats ns0 ns1 spans calls")


def serve(params, multihost=False, capturable=False, **ecfg) -> Served:
    """PROMPTS through a fresh ServingLoop, every request queued before the
    scheduler starts; the spans that began after the first clock read, and
    each prefill call's prompt lengths."""
    eng = Engine(params, CFG, family_for("llama"), EngineConfig(**{**ECFG, **ecfg}), device="cpu")
    eng._step.capturable = capturable
    calls = []

    def prefill_batch(pairs, _inner=eng.prefill_batch):
        calls.append([len(p) for _, p in pairs])
        return _inner(pairs)

    eng.prefill_batch = prefill_batch
    loop = ServingLoop(eng, batcher=MultiHostBatcher(eng) if multihost else None)
    ns0 = time.time_ns()
    reqs = [loop.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, MAX_NEW)]
    loop.start()
    try:
        for r in reqs:
            loop.wait(r, timeout=120)
    finally:
        loop.shutdown()
    assert not loop._thread.is_alive()
    ns1 = time.time_ns()
    # another test's idle loop may still record loop.* spans: keep this loop's work
    spans = [s for s in tracing.spans(ns0=ns0) if not s.name.startswith("loop.")]
    return Served(reqs, loop.batcher.stats, ns0, ns1, spans, calls)


@pytest.fixture(scope="module")
def served(params):
    return serve(params)


def named(spans, name):
    return [s for s in spans if s.name == name]


def total(spans, name, count):
    return sum(s.counts[count] for s in named(spans, name))


def test_spans_sit_inside_their_parents_and_children_come_in_order(served):
    by_index = {s.index: s for s in tracing.spans(ns0=served.ns0)}
    nested = [s for s in served.spans if s.parent >= 0]
    assert nested
    for s in nested:
        p = by_index[s.parent]
        assert p.ns0 <= s.ns0 <= s.ns1 <= p.ns1, (p, s)
    decodes, prefills = named(served.spans, "engine.decode"), named(served.spans, "engine.prefill")
    assert decodes and prefills
    for d in decodes:
        kids = tracing.children(d)
        assert [k.name for k in kids] == DECODE_CHILDREN
        assert all(a.ns1 <= b.ns0 for a, b in zip(kids, kids[1:]))
        assert by_index[d.parent].name == "batcher.step"
    for p in prefills:
        assert [k.name for k in tracing.children(p)] == PREFILL_CHILDREN
        assert by_index[p.parent].name == "batcher.admit"
    for step in named(served.spans, "batcher.step"):
        names = [k.name for k in tracing.children(step)]
        assert names[0] == "batcher.admit"
        assert names[1:] in ([], ["engine.decode", "batcher.emit"])


def test_prefill_rows_are_the_prompts_and_computed_rows_their_buckets(served):
    prefills = named(served.spans, "engine.prefill")
    assert len(prefills) == len(served.calls) and 1 < len(prefills) < len(PROMPTS)
    for p, lens in zip(prefills, served.calls):
        bucket = min(b for b in ECFG["prefill_buckets"] if b >= max(lens))
        assert p.counts == {"rows": sum(lens), "computed": len(lens) * bucket}
    assert total(served.spans, "engine.prefill", "rows") == sum(LENS)


def test_a_chunked_prefill_counts_each_chunk(params):
    """Prompts longer than the chunk prefill one chunk a tick, each chunk
    padded to the chunk's size; the rest in one call as before."""
    run = serve(params, prefill_chunk=16)
    chunks = named(run.spans, "engine.prefill_chunk")
    long = [n for n in LENS if n > 16]
    assert len(chunks) == sum(-(-n // 16) for n in long)
    assert total(run.spans, "engine.prefill_chunk", "rows") == sum(long)
    assert all(c.counts["computed"] == 16 for c in chunks)
    assert total(run.spans, "engine.prefill", "rows") == sum(n for n in LENS if n <= 16)
    e = run.stats.engine
    assert e.prefill_rows == sum(LENS)
    assert e.prefill_rows_computed == (total(run.spans, "engine.prefill", "computed")
                                       + 16 * len(chunks))


def test_active_decode_rows_are_the_tokens_decode_steps_emitted(served):
    from_decode = sum(len(r.output_ids) - 1 for r in served.reqs)  # the first is prefill's
    assert total(served.spans, "engine.decode", "rows") == from_decode
    for d in named(served.spans, "engine.decode"):
        assert d.counts["computed"] == ECFG["n_slots"] and 1 <= d.counts["rows"] <= ECFG["n_slots"]


@pytest.mark.parametrize("multihost", [False, True], ids=["continuous", "multihost"])
def test_batcher_stats_equal_the_span_sums(params, served, multihost):
    run = serve(params) if multihost else served
    s, spans = run.stats, run.spans
    e = s.engine
    assert e.prefill_rows == total(spans, "engine.prefill", "rows") == sum(LENS)
    assert e.prefill_rows_computed == total(spans, "engine.prefill", "computed")
    assert e.decode_rows == total(spans, "engine.decode", "rows")
    assert e.decode_rows_computed == total(spans, "engine.decode", "computed")
    assert e.graph_captures == 0  # the CPU runs the step op by op
    assert s.queue_depth_max == len(PROMPTS)  # all queued before the first step
    assert s.queue_depth == 0


class _StandInGraph:
    def replay(self):
        pass


def test_a_captured_step_shows_its_capture_then_replays(params, monkeypatch):
    """The step's second call captures and replays, every later one replays
    (a stand-in graph on the CPU: the spans and counters, not the tokens)."""
    monkeypatch.setattr(step_graph.StepGraph, "graph_cls", _StandInGraph)
    monkeypatch.setattr(step_graph, "capture", lambda graph, fn, pool: fn())
    run = serve(params, capturable=True)
    launches = [[k.name for k in tracing.children(d)][1:-3]
                for d in named(run.spans, "engine.decode")]
    assert launches[:3] == [["step_graph.eager"], ["step_graph.capture", "step_graph.replay"],
                            ["step_graph.replay"]]
    assert all(k == ["step_graph.replay"] for k in launches[2:])
    assert run.stats.engine.graph_captures == 1


def test_span_times_lie_between_the_clock_reads_around_the_work(served):
    assert served.spans
    for s in served.spans:
        assert served.ns0 <= s.ns0 <= s.ns1 <= served.ns1, s


def test_a_small_ring_wraps_and_counts_what_it_dropped():
    try:
        tracing.reset(capacity=16)
        assert tracing.dropped() == 0
        first = tracing.begin("test.first")
        for k in range(40):
            tracing.end(tracing.begin("test.span"), k)
        tracing.end(first, 1)  # overwritten before it closed: not written back
        assert tracing.dropped() == 41 - 16
        kept = tracing.spans()
        assert [s.index for s in kept] == list(range(26, 42))
        assert all(s.name == "test.span" for s in kept)
        with pytest.raises(ValueError):
            tracing.reset(capacity=12)
    finally:
        tracing.reset()


def test_switched_off_nothing_is_recorded_and_the_streams_are_unchanged(params, served,
                                                                        monkeypatch):
    monkeypatch.setattr(tracing, "on", False)
    off = serve(params)
    assert off.spans == []
    assert [r.output_ids for r in off.reqs] == [r.output_ids for r in served.reqs]
    assert off.stats.engine == served.stats.engine


def test_threads_write_apart_without_a_lock(monkeypatch):
    """Threads open spans while others close theirs: every span keeps its
    own name and count."""
    n_threads, n_spans = 8, 500
    for t in range(n_threads):
        monkeypatch.setitem(tracing.COUNTS, f"test.thread{t}", ("j",))
    ns0 = time.time_ns()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for j in range(n_spans):
                tracing.end(tracing.begin(f"test.thread{t}"), j)

        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    names = [f"test.thread{t}" for t in range(n_threads)]
    spans = tracing.spans(*names, ns0=ns0)
    assert len({s.index for s in spans}) == len(spans) == n_threads * n_spans
    for name in names:
        mine = named(spans, name)
        assert [s.counts["j"] for s in mine] == list(range(n_spans))
        assert all(s.parent == -1 for s in mine)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device trace comes from CUPTI")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_span_holds_its_kernel_on_the_device_trace_clock(card):
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(2048, 2048, device=card)
    (x @ x).sum().item()  # the library loaded, the clocks warm
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    sp = tracing.begin("test.kernel")
    y = x @ x
    torch.cuda.synchronize()
    tracing.end(sp)
    prof.stop()
    (span,) = [s for s in tracing.spans("test.kernel") if s.index == sp]
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    assert kernels and y.shape == x.shape
    for a, b in kernels:
        assert span.ns0 <= a < b <= span.ns1, (span, a, b)
