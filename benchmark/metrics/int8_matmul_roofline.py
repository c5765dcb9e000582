"""int8_matmul_roofline: Share of its roofline, in %, of the PBW-v2 int8 matmul (`pb_int8_matmul*`,
every arm) with its x preparation (`pb_prep_int8`) over the traced window:
the least time of every launch, from the calls' shapes, over the device
time of the launches (device trace)."""

from benchmark.harness import stats


def read(run):
    return stats.roofline(run, stats.INT8_MATMUL, stats.int8_bound_s)
