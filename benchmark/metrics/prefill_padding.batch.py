"""prefill_padding.batch: Share of the prefill rows the card computed, in %, that were bucket
padding: 100 × (1 − prompt tokens / rows computed), summed over the window's
`engine.prefill` and `engine.prefill_chunk` spans (program counter: the
port's own recorder, `pb_llm_tpu_torch.runtime.tracing`; each call pads
its K prompts to one bucket, K·bucket rows, and a chunk to the chunk's
size).  None where the port has no recorder."""


def read(run):
    try:
        from pb_llm_tpu_torch.runtime import tracing
    except ImportError:  # a port without the recorder
        return None
    spans = tracing.spans("engine.prefill", "engine.prefill_chunk",
                          ns0=run.ns(run.t_open), ns1=run.ns(run.t_close))
    computed = sum(s.counts["computed"] for s in spans)
    if not computed:
        return None
    return 100.0 * (1.0 - sum(s.counts["rows"] for s in spans) / computed)
