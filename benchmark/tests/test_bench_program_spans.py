"""The readers of the port's own spans and counters
(`pb_llm_tpu_torch.runtime.tracing`): `prefill_padding.batch`,
`decode_host_gap_ms.batch` and `prefill_idle_share.batch`, on the tiny CPU
cell, against counts made by hand from the session's own records; and
each reader answers None, without raising, for a port that has no
recorder (the benchmark runs over an older port too)."""

import os
import sys
import time
import types

import pytest

from benchmark.harness.bench import Bench
from benchmark.harness.runner import run_cell

from .conftest import DATA

METRICS = ("prefill_padding.batch", "decode_host_gap_ms.batch", "prefill_idle_share.batch")


@pytest.fixture(scope="module")
def ran():
    """One traced run of the batch cell at the tiny size on the CPU (no
    device trace there); (cell, session, result line)."""
    cell = Bench().cell("mistral-7b.batch", os.path.join(DATA, "tiny-llama.json"),
                        os.path.join(DATA, "tiny_closed.json"))
    systems = []
    result, _ = run_cell(cell, 2**40 + 11, 1.5, True, "cpu", time.perf_counter(),
                         system_hook=systems.append)
    return cell, systems[0].session, result


def _window_prefills(run):
    from pb_llm_tpu_torch.runtime import tracing

    return tracing.spans("engine.prefill", ns0=run.ns(run.t_open), ns1=run.ns(run.t_close))


def test_prefill_padding_is_a_count_of_the_sessions_calls(ran):
    """Each program span inside the window lies inside the session's own
    span of the same call, whose prompt lengths and the mix's buckets give
    the rows by hand."""
    cell, run, result = ran
    buckets = cell.mix["engine"]["prefill_buckets"]
    calls = _window_prefills(run)
    assert calls
    real = computed = 0
    for c in calls:
        (s,) = [s for s in run.spans if s.kind == "prefill" and s.ns0 <= c.ns0 and c.ns1 <= s.ns1]
        real += sum(s.lens)
        computed += len(s.lens) * min(b for b in buckets if b >= max(s.lens))
    assert 0 < real < computed
    want = 100.0 * (1.0 - real / computed)
    assert result["metrics"]["prefill_padding.batch"]["value"] == pytest.approx(want, abs=1e-9)


def test_decode_host_gap_is_positive_and_shorter_than_the_step(ran):
    m = ran[2]["metrics"]
    assert 0 < m["decode_host_gap_ms.batch"]["value"] < m["decode_step_ms.batch"]["value"]


def test_prefill_idle_share_reads_the_trace_over_the_program_spans(ran):
    cell, run, result = ran
    read = cell.reader("prefill_idle_share.batch")
    assert run.trace is None and read(run) is None
    assert "prefill_idle_share.batch" not in result["metrics"]
    # a device trace busy over the first half of every prefill call
    calls = _window_prefills(run)
    ops = [("kernel", c.ns0, (c.ns0 + c.ns1) // 2) for c in calls]
    trace = {"ns0": run.ns(run.t_open), "ns1": run.ns(run.t_close), "ops": ops}
    idle = sum(c.ns1 - (c.ns0 + c.ns1) // 2 for c in calls)
    want = 100.0 * idle / sum(c.ns1 - c.ns0 for c in calls)
    assert read(types.SimpleNamespace(trace=trace)) == pytest.approx(want)
    assert 49.0 < want < 51.0


def test_a_port_without_the_recorder_reads_none(ran, monkeypatch):
    import pb_llm_tpu_torch.runtime

    cell, run, _ = ran
    monkeypatch.delattr(pb_llm_tpu_torch.runtime, "tracing")
    monkeypatch.setitem(sys.modules, "pb_llm_tpu_torch.runtime.tracing", None)  # import fails
    traced = types.SimpleNamespace(trace={"ns0": 0, "ns1": 1, "ops": []}, ns=run.ns,
                                   t_open=run.t_open, t_close=run.t_close)
    for name in METRICS:
        assert cell.reader(name)(traced) is None
