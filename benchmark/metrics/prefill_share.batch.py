"""prefill_share.batch: Share of the window's wall time inside `Engine.prefill_batch`, in %
(program span)."""

from benchmark.harness import stats


def read(run):
    spans = run.spans_in_window("prefill")
    return 100.0 * stats.span_seconds(spans) / run.window_s if spans else None
