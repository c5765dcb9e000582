"""prefill_idle_share.batch: Share of the time inside the port's `engine.prefill` spans, in %,
during which no device activity ran, over the traced window (device trace:
the union of the clipped activities laid over the program's spans from its
own recorder, `pb_llm_tpu_torch.runtime.tracing`, on the same clock).
It is read under CUPTI, which slows the host work it measures: on one
H100 a prefill call's eager forward took a tenth to a third longer traced
than untraced (104-128 against 94-97 ms a call), so the share reads the
traced loop's idle, above an untraced run's.  It follows the host's speed
and which prefill shapes the traced window holds: there calls of 128 rows
idled 83-87% of their time, of 512 rows 64-72%, of 2048 rows 10-13%.
None without a trace or where the port has no recorder."""

import bisect

from benchmark.harness import trace as tracemod


def read(run):
    if run.trace is None:
        return None
    try:
        from pb_llm_tpu_torch.runtime import tracing
    except ImportError:  # a port without the recorder
        return None
    spans = tracing.spans("engine.prefill", ns0=run.trace["ns0"], ns1=run.trace["ns1"])
    inside = sum(s.ns1 - s.ns0 for s in spans)
    if not inside:
        return None
    busy = tracemod.union([(a, b) for _, a, b in tracemod.clipped(run.trace)])
    starts = [a for a, _ in busy]
    covered = 0
    for s in spans:
        k = max(0, bisect.bisect_right(starts, s.ns0) - 1)
        while k < len(busy) and busy[k][0] < s.ns1:
            covered += max(0, min(busy[k][1], s.ns1) - max(busy[k][0], s.ns0))
            k += 1
    return 100.0 * (1.0 - covered / inside)
