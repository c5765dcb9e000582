"""Frozen copies of the port's random-plane recipes (`data/synthetic.py`:
`random_packed_v2`, `random_packed_v1`), returning each layer as a plain
dict of tensors and static fields under the names of the port's
`PackedLinearV2` / `PackedLinear` fields.  Same generator state, same
planes, bit for bit (`benchmark/tests/test_bench_frozen.py`).

PBW v2 (column-structured salient sidecar), logical weight over [ic, oc]:
``w[i, o] = hs[o]·(code − hz[o])`` at the salient rows listed in
``side_idx``, else ``low_mean[o] + (2·bit − 1)·low_scale[o]``.

PBW v1 (element-wise salient mask): ``w[i, o] = mask ? hs[o]·(sidecar −
hz[o]) : low_mean[g, o] + (2·bit − 1)·low_scale[g, o]`` (1-bit lows).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import packing


def random_v2(ic: int, oc: int, generator: torch.Generator, *, low_frac: float = 0.9,
              col_tile: int = 0, side_bits: int = 8, pack_block: int = 0,
              bias: bool = False, ic_shards: int = 1) -> dict:
    """A PBW-v2 layer with random planes, made on the generator's device:
    round((1-low_frac)·ic_s) random salient input columns per row group and
    shard, random sign bits (zero at salient rows), random codes; low scale
    0.01 around 0, high scale 0.004 around the mid code."""
    dev = generator.device
    if col_tile <= 0 or col_tile > oc:
        col_tile = oc
    n_rg = -(-oc // col_tile)
    ic_s = ic // ic_shards
    k = int(round(ic_s * (1.0 - low_frac)))
    k_pad = max(32, -(-k // 32) * 32)
    side_idx = torch.full((ic_shards * k_pad, n_rg), ic_s, dtype=torch.int32, device=dev)
    bits = torch.randint(0, 2, (ic, oc), generator=generator, device=dev, dtype=torch.int32)
    for t in range(n_rg):
        for s in range(ic_shards):
            cols = torch.sort(torch.randperm(ic_s, generator=generator, device=dev)[:k]).values
            side_idx[s * k_pad : s * k_pad + k, t] = cols.to(torch.int32)
            bits[s * ic_s + cols[:, None],
                 torch.arange(t * col_tile, min((t + 1) * col_tile, oc), device=dev)] = 0
    pack_block = pack_block or packing.default_pack_block(ic_s)
    rows = ic_shards * (k_pad // 2 if side_bits == 4 else k_pad)
    side_val = torch.randint(0, 256, (rows, oc), generator=generator, device=dev,
                             dtype=torch.int32).to(torch.uint8)

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=dev)

    return dict(
        sign_packed=packing.pack_bits(bits, pack_block), side_val=side_val, side_idx=side_idx,
        low_scale=full((1, oc), 0.01), low_mean=full((1, oc), 0.0),
        high_scale=full((oc,), 0.004), high_zero=full((oc,), 8.0 if side_bits == 4 else 128.0),
        bias=torch.randn(oc, generator=generator, device=dev) * 0.01 if bias else None,
        ic=ic, oc=oc, col_tile=col_tile, pack_block=pack_block, k_pad_shard=k_pad,
        side_bits=side_bits, low_bits=1)


def random_v1(ic: int, oc: int, generator: torch.Generator, *, low_frac: float = 0.9,
              groupsize: int = -1, sidecar_bits: int = 8, low_bits: int = 1,
              bias: bool = False, pack_block: Optional[int] = None) -> dict:
    """A PBW-v1 layer with random planes, made on the generator's device:
    each weight salient with probability 1 − low_frac; random low codes
    (zero at salient positions) and high codes (zero elsewhere); scales by
    group and column, low 0.005–0.015 (1-bit mean ±0.002), high 0.002–0.006
    around the mid code."""
    dev = generator.device
    gs = ic if groupsize == -1 else groupsize
    n_groups = -(-ic // gs)
    cap = gs if (gs < ic and ic % gs == 0 and gs % 32 == 0) else 2048
    pack_block = pack_block or packing.default_pack_block(ic, cap=cap)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    salient = torch.rand((ic, oc), generator=generator, device=dev) >= low_frac
    codes_low = torch.randint(0, 2**low_bits, (ic, oc), generator=generator, device=dev,
                              dtype=torch.int32) * ~salient
    maxq = 15 if sidecar_bits == 4 else 255
    codes = (torch.randint(0, maxq + 1, (ic, oc), generator=generator, device=dev,
                           dtype=torch.int32) * salient).to(torch.uint8)
    sidecar = packing.pack_nibbles(codes, pack_block) if sidecar_bits == 4 else codes
    scale = uniform((n_groups, oc), 0.005, 0.015)
    if low_bits == 1:
        mean = uniform((n_groups, oc), -0.002, 0.002)
    else:
        mean = torch.full((n_groups, oc), (2**low_bits - 1) / 2, device=dev)
    return dict(
        sign_packed=torch.cat([packing.pack_bits((codes_low >> j) & 1, pack_block)
                               for j in range(low_bits)], dim=0),
        mask_packed=packing.pack_bits(salient, pack_block), sidecar=sidecar,
        low_scale=scale, low_mean=mean, high_scale=uniform((oc,), 0.002, 0.006),
        high_zero=torch.full((oc,), (maxq + 1) / 2, device=dev),
        bias=torch.randn(oc, generator=generator, device=dev) * 0.01 if bias else None,
        ic=ic, oc=oc, groupsize=gs, pack_block=pack_block, sidecar_bits=sidecar_bits,
        low_bits=low_bits)


def is_layer(v) -> bool:
    return isinstance(v, dict) and "sign_packed" in v

