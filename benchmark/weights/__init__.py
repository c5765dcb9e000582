"""The benchmark's inputs: random partially-binarized planes and dense
weights made on the device from the run's seed.

These are frozen copies of the port's recipes (`data/synthetic.py`'s
`random_packed_v1` / `random_packed_v2`, with `core/packing.py`'s bit and
nibble packing), kept here so that a later change to the port cannot
change what the benchmark feeds it.  They import torch alone: the plain
reference (`benchmark/reference`) regenerates its inputs from them.
"""

from __future__ import annotations

import hashlib

import torch


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit generator seed for one part of a run's inputs, from the run's
    ``seed`` (any whole number) and the part's tags: each part can be made
    again on its own, in any order."""
    h = hashlib.sha256(repr((int(seed),) + tuple(tags)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, *tags))
