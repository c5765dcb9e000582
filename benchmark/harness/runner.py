"""One run of one cell: set up, drive the traffic over the window, reduce
the records to the cell's metrics, decide `correct`, and assemble the
result line (`run.py` prints it)."""

from __future__ import annotations

import math
import sys
import time
from typing import Callable, Optional, Tuple

import torch

from . import check, stats, trace as tracemod
from .bench import Cell
from .system import System


class Aborted(RuntimeError):
    """The run must print no result (a forbidden module was loaded)."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_process: float,
             after_window: Optional[Callable[[], list]] = None,
             system_hook: Optional[Callable[[System], None]] = None,
             control: Optional[str] = None) -> Tuple[dict, list]:
    """Run ``cell`` once; returns (the result line's object, the check's
    lines).  ``t_process`` is the process's start on the perf_counter
    clock.  ``system_hook`` sees the built system before the traffic starts
    (the tests plant faults there); ``control`` puts that control in the
    program's place in the check (`check.run`)."""
    device = torch.device(device)
    t_begin = time.perf_counter()
    system = System(cell, seed, device)
    if system_hook is not None:
        system_hook(system)
    session = system.session
    t_built = time.perf_counter()
    tracer = tracemod.Tracer() if trace and device.type == "cuda" else None
    kind = cell.kind()
    kind.drive(session, cell.mix, seconds, tracer)
    if tracer is not None:
        session.stop_trace(tracer)
    if after_window is not None and after_window():
        raise Aborted("forbidden modules loaded")
    owed = getattr(kind, "owed", lambda s: [])(session)
    setup = dict(start_s=t_begin - t_process, **system.setup, ramp_s=session.t_open - t_built)
    session.extra.update(setup_s=session.t_open - t_process, setup=setup)
    log("setup " + " ".join(f"{k} {v:.3f}" for k, v in setup.items())
        + f" total {session.extra['setup_s']:.3f}")
    if session.lateness:
        late = sorted(session.lateness)
        log(f"generator lateness: {len(late)} sends, median {late[len(late) // 2] * 1e3:.3f} ms, "
            f"max {late[-1] * 1e3:.3f} ms")

    dec, pre = session.spans_in_window("decode"), session.spans_in_window("prefill")
    log(f"window {session.window_s:.3f} s: {len(dec)} decode steps, mean "
        f"{stats.mean_ms(dec) or 0:.3f} ms; {len(pre)} prefill calls, mean "
        f"{stats.mean_ms(pre) or 0:.3f} ms; {stats.window_tokens(session)} tokens")
    system.shutdown()
    if tracer is not None:
        session.trace = tracer.read()
        log(f"trace: {len(session.trace['ops'])} device activities over "
            f"{(session.trace['ns1'] - session.trace['ns0']) / 1e9:.3f} s after the window, stopped in "
            f"{session.trace['stop_s']:.3f} s, read in {session.trace['read_s']:.3f} s")
    # the process's peak before the reference check: set-up's or since
    peak = max(session.extra.get("open_peak_bytes", 0),
               torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
    if "open_peak_bytes" in session.extra:
        log(f"memory peak: set-up {session.extra['open_peak_bytes']} B, window "
            f"{session.extra['close_peak_bytes']} B, run {peak} B")

    specs = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for spec in specs:
        value = cell.reader(spec["name"])(session)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": session.device_name, "count": 1, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": metrics, "device": dev}
    if trace and session.trace is not None:
        dev["busy_s"] = tracemod.busy_ns(session.trace) / 1e9
        dev["window_s"] = (session.trace["ns1"] - session.trace["ns0"]) / 1e9
        result["breakdown"] = tracemod.breakdown(session.trace, session.spans)

    attempted = [r for r in session.records
                 if r.sent < session.t_close and not (r.done and r.finished < session.t_open)]
    result["attempted"] = len(attempted)
    result["failed"] = sum(not r.done for r in owed) + (
        sum(not r.done for r in attempted) if session.failed() is not None else 0)
    ok, numbers, info = check.run(cell, session, owed, device, control)
    result["correct"] = ok
    result["check"] = {k: {"value": _num(v["value"]), "limit": v["limit"]}
                       for k, v in numbers.items()}
    return result, check.lines(numbers, info)


def _num(v):
    return v if not (isinstance(v, float) and math.isnan(v)) else None
