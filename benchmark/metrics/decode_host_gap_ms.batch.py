"""decode_host_gap_ms.batch: Mean host time, in ms, from the end of one decode step's read of
its tokens (`decode.read`: the card has finished the step) to the start
of the next step's launch (`step_graph.replay`; `step_graph.eager` where
the step runs op by op, as on the CPU), over consecutive `engine.decode`
spans in the window with no other engine call between them (program span:
the port's own recorder, `pb_llm_tpu_torch.runtime.tracing`).  The card
has no queued work in that stretch: the batcher's emission and
retirement, the scheduler's handoff and the step's copy-in.  A step that
captures its graph is left out.  None where the port has no recorder."""

ENGINE_CALLS = ("engine.decode", "engine.prefill", "engine.prefill_chunk", "engine.spec_decode")
LAUNCHES = ("step_graph.replay", "step_graph.eager", "step_graph.capture")


def read(run):
    try:
        from pb_llm_tpu_torch.runtime import tracing
    except ImportError:  # a port without the recorder
        return None
    gaps, read_end = [], None
    for call in tracing.spans(*ENGINE_CALLS, ns0=run.ns(run.t_open), ns1=run.ns(run.t_close)):
        if call.name != "engine.decode":
            read_end = None
            continue
        kids = tracing.children(call)
        launch = next((k for k in kids if k.name in LAUNCHES), None)
        if read_end is not None and launch is not None and launch.name != "step_graph.capture":
            gaps.append(launch.ns0 - read_end)
        read_end = next((k.ns1 for k in kids if k.name == "decode.read"), None)
    return sum(gaps) / len(gaps) / 1e6 if gaps else None
