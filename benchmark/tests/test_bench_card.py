"""On the card: one short run of each cell through `run.py`, its last line
as `run.py` documents it.  Marked `cuda`; skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from .conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,trace", [("mistral-7b.batch", 0), ("mistral-7b.batch", 1)])
def test_cell_runs(card, cell, trace):
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                        str(2**32 + 11), "--seconds", "8", "--trace", str(trace)],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[: len(KEYS)] == KEYS and list(line)[-1] == "check"
    assert line["correct"], line["check"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    group = [m for m in spec["per_layer" if trace else "end_to_end"]
             if cell in m.get("workloads", [cell])]
    assert set(line["metrics"]) == {m["name"] for m in group}
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"] and line["breakdown"]["idle_gaps"]
