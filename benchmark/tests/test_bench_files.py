"""A cell, a configuration, a traffic mix and a per-layer metric added as
files and entries alone are picked up, with no edit to a file there."""

import json
import os
import shutil
import time

from benchmark.harness.bench import Bench
from benchmark.harness.runner import run_cell

from .conftest import DATA, ROOT

READER = '''"""requests_done.tiny: requests finished in the window (a test's metric)."""


def read(run):
    return float(sum(1 for r in run.records if r.done and run.t_open <= r.finished < run.t_close))
'''


def test_new_files_make_a_new_cell(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    before = {p: open(p, "rb").read() for p in
              (str(f) for f in (tmp_path / "benchmark").rglob("*") if f.is_file())}

    shutil.copy(os.path.join(DATA, "tiny-llama.json"), tmp_path / "benchmark/configs/tiny.json")
    shutil.copy(os.path.join(DATA, "tiny_closed.json"), tmp_path / "benchmark/traffic/tiny_mix.json")
    (tmp_path / "benchmark/metrics/requests_done.tiny.py").write_text(READER)
    (tmp_path / "benchmark/checks/tiny.closed.json").write_text(
        json.dumps({"max_logit_gap": {"limit": 0.01}}))
    spec["configs"].append({"name": "tiny", "source": "a test's configuration",
                            "file": "benchmark/configs/tiny.json", "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.closed", "config": "tiny", "traffic": "tiny_mix",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "requests_done.tiny", "unit": "requests", "better": "higher",
                              "source": "program_counter", "layer": "serving loop and scheduler",
                              "moves": "output_tokens_per_s", "workloads": ["tiny.closed"]})
    spec["end_to_end"][0]["workloads"].append("tiny.closed")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = Bench(str(tmp_path)).cell("tiny.closed")
    assert cell.config["hidden_size"] == 64 and cell.mix["clients"] == 4
    assert [m["name"] for m in cell.per_layer] == ["requests_done.tiny"]
    assert [m["name"] for m in cell.end_to_end] == ["output_tokens_per_s", "peak_mem_gib",
                                                     "setup_s"]
    traced, _ = run_cell(cell, 2**35 + 9, 1.5, True, "cpu", time.perf_counter())
    plain, _ = run_cell(cell, 2**35 + 9, 1.5, False, "cpu", time.perf_counter())
    assert traced["metrics"]["requests_done.tiny"]["value"] > 0
    assert plain["metrics"]["output_tokens_per_s"]["value"] > 0 and plain["correct"]
    for p, data in before.items():  # nothing that was there changed
        assert open(p, "rb").read() == data, p
