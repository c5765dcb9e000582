"""The general traffic generator: reads a mix's parameters
(`benchmark/traffic/<name>.json`) and draws request sizes and arrival
times.  A mix's ``kind`` (`benchmark/traffic/kinds/<kind>.py`) says how
requests are sent (closed loop, open loop).

Sizes, arrivals and their order come from the mix's own ``sizes_seed``:
every run seed has the same schedule, and makes the prompt ids and the
weights.  The work of a run is then the same from seed to seed (with the
order of the closed loop's first sends permuted by the run seed, the
batch cell's tokens/s spread 5% over three seeds: the order changes how
prefills batch for the whole window).

A length distribution is {"dist": "lognormal", "median", "sigma", "min",
"max"} or {"dist": "uniform", "min", "max"} (whole numbers, both ends
included).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..weights import derive_seed


def draw(spec: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    if spec["dist"] == "lognormal":
        v = np.round(spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(n)))
    elif spec["dist"] == "uniform":
        v = rng.integers(spec["min"], spec["max"] + 1, n)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(v, spec["min"], spec["max"]).astype(np.int64)


def sizes_rng(mix: dict, *tags) -> np.random.Generator:
    return np.random.default_rng(derive_seed(mix["sizes_seed"], *tags))


def poisson_times(rate: float, horizon: float, rng: np.random.Generator) -> List[float]:
    """Arrival offsets of a Poisson process of ``rate`` per second over
    [0, horizon), drawn gap by gap (a longer horizon extends the same
    sequence)."""
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= horizon:
            return out
        out.append(t)


def buckets_of(mix: dict, lo: int, hi: int) -> List[int]:
    """The engine's prefill buckets that prompts of lo..hi tokens pad to."""
    bs = sorted(mix["engine"]["prefill_buckets"])
    first = next(b for b in bs if b >= lo)
    last = next(b for b in bs if b >= hi)
    return [b for b in bs if first <= b <= last]
