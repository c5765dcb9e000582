"""The traced run's device timeline: `torch.profiler` (CUPTI) over
`session.TRACE_SECONDS` of the cell's traffic right after the measured
window (`Session.window`), device activities only, reduced to plain
tuples.

`Tracer.read` returns {"ns0", "ns1", "ops": [(name, start_ns, end_ns)]}
on the wall clock in ns that `Session`'s spans also carry.  `busy_ns` is
the union of the device intervals; `in_spans` assigns each kernel to the
engine call during which it ran (each call ends in a synchronisation, so
its kernels lie inside it); `breakdown` names the costliest device
operations and the idle gaps by what the host was doing.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch


def _device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every device-side activity."""
    cuda = torch.autograd.DeviceType.CUDA
    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if res is not None:
        return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in res.events()
                if e.device_type() == cuda]
    out = []
    for e in prof.events():  # older profilers: FunctionEvents, times in us
        if e.device_type == cuda:
            out.append((e.name, int(e.time_range.start * 1e3), int(e.time_range.end * 1e3)))
    return out


class Tracer:
    def __init__(self):
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.ns0 = time.time_ns()

    def mark_end(self) -> None:
        """The traced window ends here (activities after it are clipped)."""
        self.ns1 = time.time_ns()

    def pause(self) -> None:
        """Stop the profiler (its own processing is timed)."""
        t = time.perf_counter()
        self.prof.stop()
        self.stop_s = time.perf_counter() - t

    def read(self) -> dict:
        t = time.perf_counter()
        ops = sorted(_device_events(self.prof), key=lambda e: e[1])
        self.prof = None
        return {"ns0": self.ns0, "ns1": self.ns1, "ops": ops, "stop_s": self.stop_s,
                "read_s": time.perf_counter() - t}


def clipped(trace: dict) -> List[Tuple[str, int, int]]:
    """Device activities clipped to the traced window."""
    a, b = trace["ns0"], trace["ns1"]
    return [(n, max(s, a), min(e, b)) for n, s, e in trace["ops"] if e > a and s < b]


def union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_ns(trace: dict) -> int:
    return sum(e - s for s, e in union([(s, e) for _, s, e in clipped(trace)]))


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)", "anon"))
    return name.split("(", 1)[0].strip() or name


def spans_in_trace(trace: dict, spans) -> list:
    return [s for s in spans if s.ns0 >= trace["ns0"] and s.ns1 <= trace["ns1"]]


def in_spans(trace: dict, spans, pattern: str) -> Tuple[float, list, float]:
    """(device seconds of the activities whose name matches ``pattern`` and
    that started inside one of ``spans``, the spans that held at least one,
    the device seconds of the matching activities outside every span)."""
    rx = re.compile(pattern)
    ops = [(s, e) for n, s, e in trace["ops"] if rx.search(n)]
    starts = [s for s, _ in ops]
    inside, held, total = 0, [], sum(e - s for s, e in ops if trace["ns0"] <= s < trace["ns1"])
    for sp in spans:
        i, j = bisect.bisect_left(starts, sp.ns0), bisect.bisect_right(starts, sp.ns1)
        if j > i:
            inside += sum(e - s for s, e in ops[i:j])
            held.append(sp)
    return inside / 1e9, held, (total - inside) / 1e9


def _label(span) -> str:
    if span is None:
        return "host between engine calls"
    if span.kind == "prefill":
        return f"host in prefill_batch ({len(span.lens)}x{span.computed // len(span.lens)})"
    return "host in decode_step"


def breakdown(trace: dict, spans, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle time between
    device activities summed by what the host was doing (which engine call
    was open at the gap's middle)."""
    ops = clipped(trace)
    by_name: Dict[str, float] = defaultdict(float)
    for n, s, e in ops:
        by_name[short_name(n)] += (e - s) / 1e9
    busy = union([(s, e) for _, s, e in ops])
    edges = [trace["ns0"]] + [x for iv in busy for x in iv] + [trace["ns1"]]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    starts = [sp.ns0 for sp in spans]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        k = bisect.bisect_right(starts, mid) - 1
        span: Optional[object] = spans[k] if k >= 0 and spans[k].ns1 >= mid else None
        idle[_label(span)] += (b - a) / 1e9
    rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": rank(by_name), "idle_gaps": rank(idle)}
