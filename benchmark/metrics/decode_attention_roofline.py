"""decode_attention_roofline: Share of its roofline, in %, of the strip-cache decode attention
(`decode_attention*`, the split arm's merge launch included) over the
traced window: bytes of every slot's cache rows and scales read, q in and
out (device trace)."""

from benchmark.harness import stats


def read(run):
    return stats.roofline(run, stats.DECODE_ATTENTION, stats.decode_attention_bound_s,
                          kinds=("decode",))
