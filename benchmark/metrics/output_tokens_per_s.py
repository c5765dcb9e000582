"""output_tokens_per_s: Every output token completed in the window (its on_token callback ran
there), over the window's seconds (host clock)."""

from benchmark.harness import stats


def read(run):
    return stats.window_tokens(run) / run.window_s
