"""idle_share.batch: Share of the traced window, in %, in which no device activity ran
(device trace)."""

from benchmark.harness import stats


def read(run):
    return stats.idle_share(run)
