"""decode_step_ms.batch: Mean host time inside `Engine.decode_step` over the window's steps
(program span: each call ends in a device synchronisation)."""

from benchmark.harness import stats


def read(run):
    return stats.mean_ms(run.spans_in_window("decode"))
