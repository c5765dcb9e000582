"""peak_mem_gib: Peak device memory of the measured window, in GiB:
`torch.cuda.max_memory_allocated()` from `reset_peak_memory_stats()` at the
window's opening to its close (what the traffic holds: model, KV cache and
the window's own prefill and decode calls; set-up's warm-up of every
prefill shape is left out, its peak logged beside).  None off the card."""


def read(run):
    peak = run.extra.get("close_peak_bytes", 0)
    return peak / 2**30 if peak else None
