"""Open loop: requests arrive at the times of a Poisson process of
``rate_per_s`` drawn from the mix's ``sizes_seed`` (the same times for
every run seed), sent by one generator thread whatever the backlog, with
sizes drawn from ``sizes_seed`` too.  The
first ``ramp_s`` seconds of arrivals fill the system (set-up); the window
is the next ``seconds`` (a traced run's arrivals go on through the trace
after it); then the generator stops and the requests due in the window
drain, for at most ``drain_s`` seconds.  Each request is timed
from when it was due; how late the generator sent is kept (`lateness`).
"""

from __future__ import annotations

import threading

from benchmark.harness import traffic
from benchmark.harness.session import TRACE_SECONDS, clock


def plan(mix: dict, seconds: float):
    times = traffic.poisson_times(mix["rate_per_s"], mix["ramp_s"] + seconds,
                                  traffic.sizes_rng(mix, "arrivals"))
    rng = traffic.sizes_rng(mix, "sizes")
    prompts = traffic.draw(mix["prompt"], rng, 4096)  # a longer window extends the same lists
    outs = traffic.draw(mix["output"], rng, 4096)
    if len(times) > 4096:
        raise ValueError("open loop: more than 4096 arrivals in a window")
    return [(t, int(p), int(o)) for t, p, o in zip(times, prompts, outs)]


def prompt_range(mix: dict):
    return mix["prompt"]["min"], mix["prompt"]["max"]


def drive(session, mix: dict, seconds: float, tracer=None) -> None:
    # a traced run's traffic runs on through the trace after the window
    arrivals = plan(mix, seconds + (TRACE_SECONDS + 30 if tracer is not None else 0))
    t0 = clock() + 0.05

    def generate():
        for i, (off, p, o) in enumerate(arrivals):
            due = t0 + off
            session.sleep_until(due)
            if session.failed() is not None or session.closed:
                return
            session.lateness.append(clock() - due)
            session.submit(p, o, ("open", i), due=due)

    session.start()
    gen = threading.Thread(target=generate, name="bench-open-loop", daemon=True)
    gen.start()
    session.sleep_until(t0 + mix["ramp_s"])
    session.window(seconds, tracer)
    gen.join(timeout=TRACE_SECONDS + 60)
    due = session.due_in_window()
    session.wait(lambda: all(r.done for r in due), mix["drain_s"])


def owed(session) -> list:
    """Requests owed an answer: every one due in the window."""
    return session.due_in_window()
