"""Reductions the metric readers share (`benchmark/metrics/`).

Every rate is all the work of the window over all its time; every tail is
the nearest-rank percentile over all requests or gaps of the window (no
medians of chunks); a request with no answer counts as infinite."""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

from . import trace as tracemod
from . import yardstick as ys

# device kernels by name (demangled, as the profiler reports them)
INT8_MATMUL = r"pb_int8_matmul_kernel|::tc::(split_)?kernel<|pb_prep_int8_kernel"
PLANAR_V1 = r"pb_planar_v1_kernel|::v1tc::|pb_select_v1_kernel|::seltc::|::v1terms::"
DECODE_ATTENTION = (r"decode_attention_kernel|\(anonymous namespace\)::split_kernel<"
                    r"|\(anonymous namespace\)::merge_kernel\(")


def nearest_rank(values: Sequence[float], q: float) -> Optional[float]:
    """The smallest value with at least a share q of the values at or
    below it; None for no values."""
    if not values:
        return None
    v = sorted(values)
    return v[max(1, math.ceil(q * len(v))) - 1]


def window_tokens(run) -> int:
    return sum(1 for r in run.records for t in r.times if run.t_open <= t < run.t_close)


def ttft_ms(run) -> List[float]:
    return [(r.times[0] - r.due) * 1e3 if r.times else math.inf for r in run.due_in_window()]


def itl_ms(run) -> List[float]:
    return [(b - a) * 1e3 for r in run.records for a, b in zip(r.times, r.times[1:])
            if run.t_open <= b < run.t_close]


def queue_wait_ms(run) -> List[float]:
    return [(r.admitted - r.due) * 1e3 if r.admitted == r.admitted else math.inf
            for r in run.due_in_window()]


def span_seconds(spans) -> float:
    return sum(s.t1 - s.t0 for s in spans)


def mean_ms(spans) -> Optional[float]:
    return span_seconds(spans) / len(spans) * 1e3 if spans else None


def step_share(run, kind: str) -> Optional[float]:
    """% of the published peak over an engine call kind in the window: the
    least time the peaks allow for its calls (`yardstick.step_bound` on the
    useful rows) over the time inside them."""
    spans = run.spans_in_window(kind)
    if not spans:
        return None
    least = 0.0
    for s in spans:
        if kind == "decode":
            least += ys.step_bound(run.sheet, s.rows, s.kv_active, s.attn_pairs, s.rows)[0]
        else:
            least += ys.step_bound(run.sheet, s.rows, 0, s.attn_pairs, s.rows)[0]
    return 100.0 * least / span_seconds(spans)


def int8_bound_s(run, span) -> float:
    m = span.computed
    return sum(ys.bound(*ys.int8_matmul_launch(e, m), ys.INT8_OPS_PER_S)[0]
               + ys.bound(ys.int8_prep_launch(e, m), 0, ys.INT8_OPS_PER_S)[0]
               for e in run.sheet["linears"] if e["format"] == "v2") / 1e3


def v1_bound_s(run, span) -> float:
    m = span.computed
    return sum(ys.bound(*ys.v1_launch(e, m), ys.BF16_FLOPS_PER_S)[0]
               for e in run.sheet["linears"] if e["format"] == "v1") / 1e3


def decode_attention_bound_s(run, span) -> float:
    if span.kind != "decode":
        return 0.0
    nbytes, ops = ys.decode_attention_launches(run.sheet, run.n_slots, span.kv_rows)
    return run.sheet["layers"] * ys.bound(nbytes, ops, ys.F32_FLOPS_PER_S)[0] / 1e3


def roofline(run, pattern: str, bound_s: Callable, kinds=("prefill", "decode")) -> Optional[float]:
    """% of the roofline of the kernels matching ``pattern`` in the traced
    window: the least time of every launch (from the calls' shapes) over
    their device time.  None where the trace holds none of them."""
    if run.trace is None:
        return None
    spans = [s for s in tracemod.spans_in_trace(run.trace, run.spans) if s.kind in kinds]
    device_s, held, _ = tracemod.in_spans(run.trace, spans, pattern)
    if not held or device_s <= 0:
        return None
    return 100.0 * sum(bound_s(run, s) for s in held) / device_s


def idle_share(run) -> Optional[float]:
    """% of the traced window in which no device activity ran."""
    if run.trace is None or run.trace["ns1"] <= run.trace["ns0"]:
        return None
    return 100.0 * (1.0 - tracemod.busy_ns(run.trace) / (run.trace["ns1"] - run.trace["ns0"]))
