"""`BENCHMARK.json` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration (its ``file``), a
traffic mix (``benchmark/traffic/<traffic>.json``, whose ``kind`` is a
module ``benchmark/traffic/kinds/<kind>.py``) and the chips it needs.  Each
metric is a reader ``benchmark/metrics/<metric name>.py`` with a function
``read(run) -> float | None``; a metric belongs to a cell when it lists the
cell under ``workloads`` or lists none.  The limits of a cell's correctness
check are ``benchmark/checks/<cell>.json``.  A later cell, configuration,
mix or metric is files and entries: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file, with "name" added
    mix: dict             # the traffic file, with "name" added
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict
    root: str

    def reader(self, metric: str) -> Callable:
        path = os.path.join(self.root, "benchmark", "metrics", metric + ".py")
        return load_module(path, "bench_metric_" + metric.replace(".", "_").replace("-", "_")).read

    def kind(self):
        path = os.path.join(self.root, "benchmark", "traffic", "kinds", self.mix["kind"] + ".py")
        return load_module(path, "bench_kind_" + self.mix["kind"])


class Bench:
    def __init__(self, root: str = ROOT):
        self.root = root
        self.spec = _json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {[w['name'] for w in self.spec['workloads']]})")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return dict(_json(os.path.join(self.root, c["file"])), name=name)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def cell(self, name: str, config_file: Optional[str] = None,
             mix_file: Optional[str] = None) -> Cell:
        """The cell ``name``; ``config_file`` / ``mix_file`` replace its
        configuration or mix (the CPU rehearsals' small sizes)."""
        w = self.workload(name)

        def mine(m: dict) -> bool:
            return "workloads" not in m or name in m["workloads"]

        config = (dict(_json(config_file), name=w["config"]) if config_file
                  else self.config(w["config"]))
        mix = dict(_json(mix_file or os.path.join(self.root, "benchmark", "traffic",
                                                  w["traffic"] + ".json")), name=w["traffic"])
        limits_path = os.path.join(self.root, "benchmark", "checks", name + ".json")
        limits = _json(limits_path) if os.path.exists(limits_path) else {}
        return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                    end_to_end=[m for m in self.spec["end_to_end"] if mine(m)],
                    per_layer=[m for m in self.spec["per_layer"] if mine(m)],
                    limits=limits, root=self.root)
