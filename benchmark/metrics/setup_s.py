"""setup_s: Seconds from the process's start until the window opens: the
kernels built or loaded, the weights made, the engine and its warm-up,
the ramp of the traffic (host clock)."""

def read(run):
    return run.extra.get("setup_s")
