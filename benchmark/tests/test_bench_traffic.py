"""The traffic generator and the tail statistics."""

import json
import math
import os
import statistics
import types

import pytest

from benchmark.harness import stats, traffic
from benchmark.harness.bench import load_module

from .conftest import DATA, ROOT

KINDS = os.path.join(ROOT, "benchmark", "traffic", "kinds")


def _mix(name, folder=os.path.join(ROOT, "benchmark", "traffic")):
    with open(os.path.join(folder, name + ".json")) as fh:
        return json.load(fh)


def test_closed_chains_come_from_the_mix_alone():
    closed = load_module(os.path.join(KINDS, "closed.py"), "kind_closed")
    mix = _mix("batch_closed")
    a, b = closed.chains(mix), closed.chains(mix)
    assert a == b and len(a) == mix["clients"]
    for chain in a:
        assert all(mix["prompt"]["min"] <= p <= mix["prompt"]["max"] for p, _ in chain)
        assert all(mix["output"]["min"] <= o <= mix["output"]["max"] for _, o in chain[1:])
        assert mix["first_output"]["min"] <= chain[0][1] <= mix["first_output"]["max"]


def test_open_plan_comes_from_the_mix_alone():
    kind = load_module(os.path.join(KINDS, "open.py"), "kind_open")
    mix = _mix("tiny_open", DATA)
    a, b = kind.plan(mix, 45), kind.plan(mix, 45)
    assert a == b and all(t < mix["ramp_s"] + 45 for t, _, _ in a)
    assert all(mix["prompt"]["min"] <= p <= mix["prompt"]["max"] for _, p, _ in a)
    assert all(mix["output"]["min"] <= o <= mix["output"]["max"] for _, _, o in a)
    rate = len(a) / (mix["ramp_s"] + 45)
    assert 0.7 * mix["rate_per_s"] < rate < 1.3 * mix["rate_per_s"]
    assert kind.plan(mix, 60)[: len(a)] == a  # a longer window extends the same schedule


def test_prompts_come_from_the_seed():
    from benchmark.harness.session import Session

    fake = types.SimpleNamespace(ecfg=types.SimpleNamespace(n_slots=2))
    s1 = Session(None, fake, 2**40 + 3, 32768, 2048, {}, "cpu")
    s2 = Session(None, fake, 2**40 + 3, 32768, 2048, {}, "cpu")
    s3 = Session(None, fake, 2**40 + 4, 32768, 2048, {}, "cpu")
    assert s1.prompt(300, "closed", 1, 0) == s2.prompt(300, "closed", 1, 0)
    assert s1.prompt(300, "closed", 1, 0) != s3.prompt(300, "closed", 1, 0)
    assert all(0 <= t < 32768 for t in s1.prompt(300, "x"))


@pytest.mark.parametrize("spec", [
    {"dist": "lognormal", "median": 512, "sigma": 0.8, "min": 32, "max": 1536},
    {"dist": "uniform", "min": 256, "max": 768}])
def test_draw_respects_the_clip(spec):
    v = traffic.draw(spec, traffic.sizes_rng({"sizes_seed": 1}, "x"), 5000)
    assert v.min() >= spec["min"] and v.max() <= spec["max"]
    if spec["dist"] == "lognormal":
        assert abs(statistics.median(v.tolist()) - spec["median"]) < 0.1 * spec["median"]


def _timeline():
    """400 requests due every 0.1 s, each answered 50 ms after it was due,
    except a 3 s stall from t = 20 s: the 30 requests due in it (7.5%) wait
    until it ends."""
    recs = []
    for i in range(400):
        due = i * 0.1
        first = 23.0 + 0.05 if 20.0 <= due < 23.0 - 1e-9 else due + 0.05
        recs.append(types.SimpleNamespace(due=due, times=[first]))
    return recs


def test_tail_over_all_requests_sees_a_stall_that_chunk_medians_miss():
    recs = _timeline()
    run = types.SimpleNamespace(t_open=0.0, t_close=40.0, due_in_window=lambda: recs)
    ttft = stats.ttft_ms(run)
    p95 = stats.nearest_rank(ttft, 0.95)
    assert p95 > 1000.0          # the 10th shortest of the 30 stalled waits: 1.05 s
    chunks = [statistics.median(ttft[k : k + 100]) for k in range(0, 400, 100)]  # 10 s chunks
    assert stats.nearest_rank(chunks, 0.95) == pytest.approx(50.0)  # misses the stall


def test_nearest_rank_and_missing_answers():
    assert stats.nearest_rank([], 0.95) is None
    assert stats.nearest_rank(list(range(1, 101)), 0.95) == 95
    assert stats.nearest_rank(list(range(1, 101)), 0.99) == 99
    run = types.SimpleNamespace(due_in_window=lambda: [types.SimpleNamespace(due=0.0, times=[])])
    assert stats.ttft_ms(run) == [math.inf]


def test_itl_counts_every_gap_that_ends_in_the_window():
    r = types.SimpleNamespace(times=[0.5, 1.0, 1.01, 1.02, 3.0, 3.01])
    run = types.SimpleNamespace(records=[r], t_open=1.0, t_close=3.005)
    assert stats.itl_ms(run) == pytest.approx([500.0, 10.0, 10.0, 1980.0])


def test_a_traced_run_traces_after_the_window(monkeypatch):
    """The profiler starts only once the window has closed, and the traffic
    runs on (not `closed`) until the trace ends; the allocator is told when
    the window opens and closes."""
    from benchmark.harness import session as S

    monkeypatch.setattr(S, "TRACE_SECONDS", 0.05)
    fake = types.SimpleNamespace(ecfg=types.SimpleNamespace(n_slots=2))
    s = S.Session(None, fake, 2**40 + 3, 512, 128, {}, "cpu")
    events = []
    s.memory = lambda stage: events.append((stage, S.clock(), s.closed))

    class Tracer:
        def start(self):
            events.append(("start", S.clock(), s.closed))

        def mark_end(self):
            events.append(("end", S.clock(), s.closed))

    s.window(0.05, Tracer())
    assert [e[0] for e in events] == ["open", "close", "start", "end"]
    assert events[0][1] >= s.t_open and events[1][1] >= s.t_close and events[2][1] >= s.t_close
    assert events[3][1] - events[2][1] >= 0.05
    assert not any(closed for _, _, closed in events) and s.closed
