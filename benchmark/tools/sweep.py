"""The rate sweep of an open-loop cell: the highest Poisson rate the port
sustains without a growing backlog, found once on the card; the cell's mix
then states 0.8 of it as a number.

    python3 benchmark/tools/sweep.py --workload <open-loop cell> \\
        --rates 1.5,1.5,1.75,1.75,2,2 --seconds 50 --seed 1 [--out sweep.jsonl]

One system (set up once), one open-loop window a rate with its drain (give
each rate twice, over the cell's full window).  A rate is sustained when
no backlog grew through the window: at its close no more requests wait
for admission than at its opening, and the second half's median TTFT is
at most `GROWTH` times the first half's; and every request due in it
finished within the drain.  The cell's rate is 0.8 of the highest rate
sustained in every one of its windows.  One JSON
line a rate: arrivals, completions, in flight at open and close, TTFT and
queue-wait percentiles over the window's requests.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GROWTH = 1.2  # a median TTFT that rises more than this across the window is a backlog


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="")
    ap.add_argument("--config-file", default=None, help="another size (CPU rehearsal)")
    ap.add_argument("--mix-file", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import stats
    from benchmark.harness.bench import Bench
    from benchmark.harness.session import Session
    from benchmark.harness.system import System

    cell = Bench(ROOT).cell(args.workload, args.config_file, args.mix_file)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    system = System(cell, args.seed, device)
    kind = cell.kind()
    out = open(args.out, "a") if args.out else None
    for rate in [float(r) for r in args.rates.split(",")]:
        mix = dict(cell.mix, rate_per_s=rate)
        s = Session(system.loop, system.engine, args.seed, cell.config["vocab_size"],
                    mix["engine"]["max_seq"], system.sheet, system.session.device_name)
        s.instrument()
        kind.drive(s, mix, args.seconds)
        due = s.due_in_window()

        def in_flight(t):
            return sum(1 for r in s.records if r.due <= t and not (r.done and r.finished <= t))

        def queued(t):  # due and not yet admitted by a prefill call
            return sum(1 for r in s.records if r.due <= t and not r.admitted <= t)

        half = (s.t_open + s.t_close) / 2
        halves = [[(r.times[0] - r.due) * 1e3 if r.times else float("inf") for r in due
                   if (r.due < half) == first] for first in (True, False)]

        ttft, wait = stats.ttft_ms(s), stats.queue_wait_ms(s)
        row = {"workload": cell.name, "rate_per_s": rate, "seconds": s.window_s,
               "arrivals": len(due), "finished": sum(r.done for r in due),
               "in_flight_open": in_flight(s.t_open), "in_flight_close": in_flight(s.t_close),
               "queued_open": queued(s.t_open), "queued_close": queued(s.t_close),
               "ttft_p50_first_half_ms": stats.nearest_rank(halves[0], 0.5),
               "ttft_p50_second_half_ms": stats.nearest_rank(halves[1], 0.5),
               "ttft_p50_ms": stats.nearest_rank(ttft, 0.5),
               "ttft_p95_ms": stats.nearest_rank(ttft, 0.95),
               "queue_wait_p95_ms": stats.nearest_rank(wait, 0.95),
               "itl_p99_ms": stats.nearest_rank(stats.itl_ms(s), 0.99),
               "decode_step_ms": stats.mean_ms(s.spans_in_window("decode")),
               "prefill_ms": stats.mean_ms(s.spans_in_window("prefill")),
               "lateness_max_ms": max(s.lateness, default=0.0) * 1e3,
               "card": s.device_name}
        row["sustained"] = (row["finished"] == row["arrivals"]
                            and row["queued_close"] <= row["queued_open"]
                            and row["ttft_p50_second_half_ms"]
                            <= GROWTH * row["ttft_p50_first_half_ms"])
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()
        if s.failed() is not None:
            break
    system.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
