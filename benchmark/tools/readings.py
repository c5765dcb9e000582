"""The readings that a cell's correctness limit is set from, many seeds in
one process (set-up paid once for the kernels).

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 \\
        --seconds 20 [--out readings.jsonl]

For each seed: the cell's system at its own size and load, a short window
of its traffic, then the plain reference (at the configuration's stated
precision) over the same sample of finished requests as a run compares,
giving the port's gaps (the lower reading) and each control's
(`reference.controls`: one precision that the configuration states a step
lower, the others as stated), whose smallest over the controls and the
seeds is the upper reading, each control also judged by the harness's own
check (`check.judge`, the cell's limits: ``<control>_correct`` has to read
false); and two witnesses': the model in f32 throughout
(`reference.EXACT`), which shows how far the configuration's own int8
moves the tokens, and the reference with each product's f32 sums in
another order, which shows how far the order of sums alone moves them.  Each arm's widest gap,
mean gap and share of served positions off the reference's best token.
One JSON line a seed.  Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def summary(name: str, gaps) -> dict:
    from benchmark.harness.check import gap_numbers

    return {f"{name}_{k}": v for k, v in gap_numbers(gaps).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--config-file", default=None, help="another size (CPU rehearsal)")
    ap.add_argument("--mix-file", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import reference
    from benchmark.harness import check
    from benchmark.harness.bench import Bench
    from benchmark.harness.system import System

    cell = Bench(ROOT).cell(args.workload, args.config_file, args.mix_file)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        system = System(cell, seed, device)
        kind = cell.kind()
        kind.drive(system.session, cell.mix, args.seconds)
        session = system.session
        owed = getattr(kind, "owed", lambda s: [])(session)
        system.shutdown()
        picked = check.sample(session, int(cell.limits.get("sample_requests", 8)))
        t_ref = time.perf_counter()
        ctls = reference.controls(cell.config)
        book = check.bookkeeping(session, owed)
        gaps, (wit, order, *ctl) = reference.forward_gaps(
            cell.config, seed, device, [(r.prompt, r.tokens) for r in picked],
            (reference.EXACT, reference.stated_precision(cell.config, reorder=True),
             *ctls.values()))
        row = {"workload": cell.name, "seed": seed, **summary("program", gaps),
               "program_correct": check.judge(cell, gaps, book)[0]}
        for name, g in zip(ctls, ctl):
            row.update(summary(name, g), **{f"{name}_correct": check.judge(cell, g, book)[0]})
        row.update(**summary("witness", wit), **summary("reordered", order),
                   sample_requests=len(picked), sample_tokens=sum(len(r.tokens) for r in picked),
                   **book,
                   reference_s=time.perf_counter() - t_ref, seed_s=time.perf_counter() - t,
                   card=session.device_name)
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()
        del system, session, gaps, ctl, wit, order, picked
    return 0


if __name__ == "__main__":
    sys.exit(main())
