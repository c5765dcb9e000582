"""mfu.decode_step.batch: The decode step's share of the chip's peak, in %: the least time the
published peaks allow for the window's decode steps (the larger of their
operations at each arithmetic's peak and their bytes at 3.35 TB/s, on the
active rows: `yardstick.step_bound`) over the time inside them."""

from benchmark.harness import stats


def read(run):
    return stats.step_share(run, "decode")
