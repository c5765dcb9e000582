"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell asks
for.  Sets up the port (`pb_llm_tpu_torch`) as `BENCHMARK.json` and the
cell's files say, drives its traffic through the port's `ServingLoop` for
``--seconds``, checks the served tokens against the plain reference, and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics and a ``breakdown``), ``device`` and, last,
``check``: each number compared with its limit (also the last lines on
standard error).  Exits non-zero, printing no result, without CUDA or
with fewer cards than the cell asks for, or if the process holds a module
of JAX or of the JAX package when the window has closed.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import signal
import sys
import time

T_PROCESS = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "pb_llm_tpu")
DEADLINE_S = 340  # a run has 360 s


def process_age() -> float:
    """Seconds since this process started (Linux), 0 where unknown."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS -= process_age()


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: `pb_llm_tpu_torch` is not `pb_llm_tpu`."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # a run that hangs past its allowance dies with every thread's stack on
    # standard error, and prints no result
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    faulthandler.register(signal.SIGTERM, all_threads=True, chain=True)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness.bench import Bench
    from benchmark.harness.runner import Aborted, run_cell

    cell = Bench(ROOT).cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        result, check_lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                       T_PROCESS, after_window=_no_jax)
    except Aborted:
        return 4
    if _no_jax():
        return 4
    for line in check_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


def _no_jax() -> list:
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"run.py: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
    return bad


if __name__ == "__main__":
    sys.exit(main())
