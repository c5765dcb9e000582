"""Closed loop: ``clients`` clients, each sending its next request the
moment its last one completes (no think time), from a chain of requests of
its own.  Chains come from the mix's ``sizes_seed``: a first request whose
output length is drawn from ``first_output`` (so slot ages are mixed when
the window opens), then ``output``.  The clients' first requests are all
queued, in order, before the scheduler starts: the loop then runs the same
steps in the same order on every run.  The window opens once every client's first request
has its first token (the ramp counts as set-up), and closes after
``seconds``; requests in flight then are left unfinished.
"""

from __future__ import annotations

from benchmark.harness import traffic


def chains(mix: dict, n: int = 256):
    rng = traffic.sizes_rng(mix, "chains")
    out = []
    for _ in range(mix["clients"]):
        prompts = traffic.draw(mix["prompt"], rng, n)
        outs = traffic.draw(mix["output"], rng, n)
        outs[0] = traffic.draw(mix["first_output"], rng, 1)[0]
        out.append(list(zip(prompts.tolist(), outs.tolist())))
    return out


def prompt_range(mix: dict):
    return mix["prompt"]["min"], mix["prompt"]["max"]


def drive(session, mix: dict, seconds: float, tracer=None, ramp_timeout: float = 300.0) -> None:
    plan = chains(mix)
    firsts = []

    def send(client: int, k: int):
        if session.closed or k >= len(plan[client]):
            return None
        p, o = plan[client][k]
        return session.submit(p, o, ("closed", client, k),
                              on_done=lambda: send(client, k + 1))

    for c in range(len(plan)):
        firsts.append(send(c, 0))
    session.start()
    if not session.wait(lambda: all(r.times for r in firsts), ramp_timeout):
        raise RuntimeError("closed loop: the first requests were not all admitted "
                           f"within {ramp_timeout} s")
    session.window(seconds, tracer)
