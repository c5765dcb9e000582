"""Partially-binarized weights: PBW v1 and v2 (port of
`pb_llm_tpu/core/pbw.py`).

PBW v1 (`PackedLinear`, element-wise salient mask), per linear layer
(logical weight W [oc, ic], planes over [ic, oc]):

  sign_packed  int32 [low_bits·ic/32, oc]  low-code bit planes, plane-major
                                           (uint32 bit pattern), zeroed at
                                           salient rows (B' convention)
  mask_packed  int32 [ic/32, oc]           salient plane (bit 1 ⇔ high code)
  sidecar      uint8 [ic, oc] | [ic/2, oc] high codes, zero where not
                                           salient; nibbles when maxq ≤ 15
  low_scale / low_mean  f32 [n_groups, oc] (2/4-bit lows: low_mean holds
                                           the zero point)
  high_scale / high_zero f32 [oc]
  bias         f32 [oc] | None

  w[i, o] = mask ? hs[o]·(sidecar[i, o] − hz[o])
                 : low_mean[g(i), o] + (2·bit − 1)·low_scale[g(i), o]

PBW v2 (`PackedLinearV2`, column-structured salient sidecar):

  sign_packed  int32 [ic/32, oc]    sign bitplane (uint32 bit pattern), zeroed
                                    at salient rows (B' convention)
  side_val     uint8 [k_pad(/2), oc] salient codes; row k holds the code for
                                    column side_idx[k, t] of row group t
  side_idx     int32 [k_pad, n_rg]  salient input columns (pad = shard width)
  low_scale / low_mean  f32 [1, oc]
  high_scale / high_zero f32 [oc]
  bias         f32 [oc] | None

Checkpoints use the JAX package's `planes.npz` + `manifest.json` layout
(bit planes stored as uint32), so artifacts cross in both directions.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..quant.reduce import tree_sum
from . import packing


@dataclasses.dataclass
class PackedLinear:
    """Element-wise partially-binarized linear (PBW v1); tensors plus the
    same static fields and derived properties as the JAX dataclass."""

    sign_packed: torch.Tensor  # int32 [low_bits * ic//32, oc]
    mask_packed: torch.Tensor  # int32 [ic//32, oc]
    sidecar: torch.Tensor      # uint8 [ic, oc], or [ic//2, oc] nibbles
    low_scale: torch.Tensor    # f32 [n_groups, oc]
    low_mean: torch.Tensor     # f32 [n_groups, oc]
    high_scale: torch.Tensor   # f32 [oc]
    high_zero: torch.Tensor    # f32 [oc]
    bias: Optional[torch.Tensor]
    ic: int
    oc: int
    groupsize: int
    pack_block: int = packing.PACK_BLOCK
    sidecar_bits: int = 8
    low_bits: int = 1
    # the planar kernel's [3G+2, oc] coefficient rows, made on first use by
    # `ops.packed_matmul_v1`; not a checkpoint field, and `to` drops it
    coef_cache: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def n_groups(self) -> int:
        return self.low_scale.shape[0]

    @property
    def ic_local(self) -> int:
        return self.sidecar.shape[0] * (2 if self.sidecar_bits == 4 else 1)

    @property
    def words_per_plane(self) -> int:
        return self.sign_packed.shape[0] // self.low_bits

    @property
    def oc_local(self) -> int:
        return self.sidecar.shape[1]

    @property
    def groupsize_local(self) -> int:
        return min(self.groupsize, self.ic_local)

    @property
    def pack_block_local(self) -> int:
        return min(self.pack_block, self.ic_local)

    @property
    def device(self) -> torch.device:
        return self.sign_packed.device

    def to(self, device) -> "PackedLinear":
        kw = {f: (None if getattr(self, f) is None else getattr(self, f).to(device))
              for f in _FIELDS}
        return dataclasses.replace(self, **kw)

    def effective_bits(self) -> float:
        """Bits of storage per logical weight."""
        n = self.ic * self.oc
        bits = (self.sign_packed.numel() + self.mask_packed.numel()) * 32 + self.sidecar.numel() * 8
        bits += (self.low_scale.numel() + self.low_mean.numel()
                 + self.high_scale.numel() + self.high_zero.numel()) * 32
        return bits / n


PACKABLE_METHODS = ("xnor", "sign", "rtn", "prune", "2bit", "4bit")
_LOW_BITS = {"xnor": 1, "sign": 1, "rtn": 1, "prune": 1, "2bit": 2, "4bit": 4}


def _low_params(low_state: Dict, method: str, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """(low_scale, low_mean) of a packable method: xnor keeps its mean and
    scale, 2/4-bit lows their scale and zero point, and the {0, s} methods
    (sign, rtn, prune) the two-point form mean' = scale' = s/2."""
    if method == "xnor":
        return _f32(low_state["scale"], dev), _f32(low_state["mean"], dev)
    if method in ("2bit", "4bit"):
        return _f32(low_state["scale"], dev), _f32(low_state["zero"], dev)
    s = _f32(low_state["scale"], dev)
    if method == "prune":
        s = torch.zeros_like(s)
    return s / 2.0, s / 2.0


def pack_linear(w_q, mask, low_state: Dict, high_state: Dict, method: str, groupsize: int = -1,
                bias=None, pack_block: Optional[int] = None) -> Tuple[PackedLinear, Dict[str, float]]:
    """Pack a fake-quantized weight ``w_q`` [oc, ic] with its element-wise
    ``mask`` [oc, ic] (True ⇔ binarized) into PBW v1 planes, on ``w_q``'s
    device (numpy inputs: the CPU).  Returns the layer and {pack_mismatch:
    fraction of entries whose dequantization differs from w_q}."""
    if method not in PACKABLE_METHODS:
        raise ValueError(f"method {method!r} is not 1-bit packable; use the 'sim' format")
    w_q = _f32(w_q)
    dev = w_q.device
    oc, ic = w_q.shape
    gs = ic if groupsize == -1 else groupsize
    if ic % 32:
        raise ValueError("pack_linear requires ic % 32 == 0 (pad upstream)")
    if isinstance(mask, torch.Tensor):
        salient = ~mask.to(dev).bool()
    else:
        salient = ~torch.from_numpy(np.array(mask, dtype=bool)).to(dev)
    low_bits = _LOW_BITS[method]
    low_scale, low_mean = _low_params(low_state, method, dev)

    # grouped layouts cap the pack block at the group size so no bit-plane
    # block straddles a scale group (the planar kernel's per-group terms)
    if pack_block is None:
        cap = gs if (gs < ic and ic % gs == 0 and gs % 32 == 0) else 2048
        pack_block = packing.default_pack_block(ic, cap=cap)
    sal_t = salient.T
    if low_bits == 1:
        mean_rows = torch.repeat_interleave(low_mean, gs, dim=0)[:ic]
        plane_list = [((w_q.T - mean_rows) >= 0) & ~sal_t]
    else:
        scale_rows = torch.clamp(torch.repeat_interleave(low_scale, gs, dim=0)[:ic], min=1e-20)
        zero_rows = torch.repeat_interleave(low_mean, gs, dim=0)[:ic]
        codes_low = torch.clamp(torch.round(w_q.T / scale_rows + zero_rows), 0, 2**low_bits - 1)
        codes_low = torch.where(sal_t, 0, codes_low.to(torch.int32))
        plane_list = [((codes_low >> j) & 1).bool() for j in range(low_bits)]

    hs, hz = _f32(high_state["scale"], dev), _f32(high_state["zero"], dev)
    maxq = float(_f32(high_state.get("maxq", 255.0)))
    sidecar_bits = 4 if maxq <= 15 and ic % 2 == 0 else 8
    codes = torch.clamp(torch.round(w_q / hs[:, None] + hz[:, None]), 0, maxq)
    sidecar = torch.where(salient, codes, 0).to(torch.uint8).T.contiguous()
    if sidecar_bits == 4:
        sidecar = packing.pack_nibbles(sidecar, pack_block)

    packed = PackedLinear(
        sign_packed=torch.cat([packing.pack_bits(pl, pack_block) for pl in plane_list], dim=0),
        mask_packed=packing.pack_bits(sal_t, pack_block), sidecar=sidecar,
        low_scale=low_scale, low_mean=low_mean, high_scale=hs, high_zero=hz,
        bias=None if bias is None else _f32(bias, dev),
        ic=ic, oc=oc, groupsize=gs, pack_block=pack_block, sidecar_bits=sidecar_bits,
        low_bits=low_bits)
    w_rt = dequantize(packed).T
    return packed, {"pack_mismatch": float(torch.mean(((w_rt - w_q).abs() > 1e-6).float()))}


def low_code(sign_packed: torch.Tensor, low_bits: int, ic: int, pack_block: int) -> torch.Tensor:
    """C = Σ_j 2^j·B_j of plane-major bit planes, f32 [ic, oc] (exact small
    integers)."""
    wpp = sign_packed.shape[0] // low_bits
    code = None
    for j in range(low_bits):
        bits = packing.unpack_bits(sign_packed[j * wpp : (j + 1) * wpp], ic, pack_block).float()
        code = bits if code is None else code + (2.0 ** j) * bits
    return code


def sidecar_codes(p: PackedLinear) -> torch.Tensor:
    """The high codes as uint8 [ic, oc] (nibbles unpacked)."""
    if p.sidecar_bits == 4:
        return packing.unpack_nibbles(p.sidecar, p.ic_local, p.pack_block_local)
    return p.sidecar


def dequantize(p: PackedLinear) -> torch.Tensor:
    """Dense f32 [ic, oc] (the kernels' oracle), in the JAX function's
    operation order."""
    ic = p.ic_local
    m = packing.unpack_bits(p.mask_packed, ic, p.pack_block_local).bool()
    mean_rows = torch.repeat_interleave(p.low_mean, p.groupsize_local, dim=0)[:ic]
    scale_rows = torch.repeat_interleave(p.low_scale, p.groupsize_local, dim=0)[:ic]
    code = low_code(p.sign_packed, p.low_bits, ic, p.pack_block_local)
    if p.low_bits == 1:
        w_bin = mean_rows + (2.0 * code - 1.0) * scale_rows
    else:
        w_bin = scale_rows * (code - mean_rows)  # low_mean holds the zero point
    w_hi = p.high_scale[None, :] * (sidecar_codes(p).float() - p.high_zero[None, :])
    return torch.where(m, w_hi, w_bin)


def matmul_reference(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    y = x.float() @ dequantize(p)
    if p.bias is not None:
        y = y + p.bias
    return y


@dataclasses.dataclass
class PackedLinearV2:
    """Column-structured partially-binarized linear (PBW v2); tensors plus
    the same static fields and derived properties as the JAX dataclass."""

    sign_packed: torch.Tensor  # int32 [low_bits * ic//32, oc]
    side_val: torch.Tensor     # uint8 [ic_shards * k_pad_shard (/2), oc]
    side_idx: torch.Tensor     # int32 [ic_shards * k_pad_shard, n_row_groups]
    low_scale: torch.Tensor    # f32 [1, oc]
    low_mean: torch.Tensor     # f32 [1, oc]
    high_scale: torch.Tensor   # f32 [oc]
    high_zero: torch.Tensor    # f32 [oc]
    bias: Optional[torch.Tensor]
    ic: int
    oc: int
    col_tile: int
    pack_block: int = packing.PACK_BLOCK
    k_pad_shard: int = 0
    side_bits: int = 8
    low_bits: int = 1
    # the int8 matmul's [5, oc] coefficient rows, made on first use by
    # `ops.packed_matmul`; not a checkpoint field, and `to` drops it
    coef_cache: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def words_per_plane(self) -> int:
        return self.sign_packed.shape[0] // self.low_bits

    @property
    def ic_local(self) -> int:
        return self.words_per_plane * 32

    @property
    def oc_local(self) -> int:
        return self.sign_packed.shape[1]

    @property
    def k_pad(self) -> int:
        return self.side_val.shape[0] * (8 // self.side_bits)

    @property
    def k_pad_shard_local(self) -> int:
        return self.k_pad_shard or self.k_pad

    @property
    def shards_local(self) -> int:
        return self.k_pad // self.k_pad_shard_local

    @property
    def ic_shard_local(self) -> int:
        return self.ic_local // self.shards_local

    @property
    def n_row_groups(self) -> int:
        return self.side_idx.shape[1]

    @property
    def pack_block_local(self) -> int:
        return min(self.pack_block, self.ic_shard_local)

    @property
    def device(self) -> torch.device:
        return self.sign_packed.device

    def to(self, device) -> "PackedLinearV2":
        kw = {f: (None if getattr(self, f) is None else getattr(self, f).to(device))
              for f in _FIELDS_V2}
        return dataclasses.replace(self, **kw)

    def effective_bits(self) -> float:
        n = self.ic * self.oc
        bits = self.sign_packed.numel() * 32 + self.side_val.numel() * 8 + self.side_idx.numel() * 32
        bits += (self.low_scale.numel() + self.low_mean.numel()
                 + self.high_scale.numel() + self.high_zero.numel()) * 32
        return bits / n


def unpack_side_codes(side_val: torch.Tensor, side_bits: int, shards: int = 1) -> torch.Tensor:
    """Sidecar codes as unpacked uint8 [k_pad, oc].  side_bits=4: packed row
    r of a shard segment holds slot rows r (low nibble) and r + kps/2 (high)."""
    if side_bits == 8:
        return side_val
    if side_bits != 4:
        raise ValueError(f"side_bits must be 4 or 8, got {side_bits}")
    lo = side_val & 0x0F
    hi = (side_val >> 4) & 0x0F
    oc = side_val.shape[1]
    return torch.cat([lo.reshape(shards, -1, oc), hi.reshape(shards, -1, oc)], dim=1).reshape(-1, oc)


def column_structured_mask(metric, low_frac: float, col_tile: int, ic_shards: int = 1) -> torch.Tensor:
    """Per row group of ``col_tile`` output channels, the top
    round((1-low_frac)·ic_shard) input columns of the group-summed metric
    are salient.  Returns mask [oc, ic] bool, True ⇔ binarized.  Ties keep
    index order (stable argsort of -seg, as `jnp.argsort`).  The group sum
    adds in XLA's order (`quant.reduce.tree_sum`), so the selection is the
    JAX package's and the same on every device."""

    metric = torch.as_tensor(metric, dtype=torch.float32)
    oc, ic = metric.shape
    if col_tile <= 0 or col_tile > oc:
        col_tile = oc
    if ic % ic_shards:
        raise ValueError(f"ic {ic} not divisible by ic_shards {ic_shards}")
    ic_s = ic // ic_shards
    n_groups = -(-oc // col_tile)
    k = int(round(ic_s * (1.0 - low_frac)))
    rows = []
    for t in range(n_groups):
        blk = metric[t * col_tile : (t + 1) * col_tile]
        agg = tree_sum(blk, dim=0)
        salient_cols = torch.zeros(ic, dtype=torch.bool, device=metric.device)
        if k:
            for s in range(ic_shards):
                order = torch.argsort(-agg[s * ic_s : (s + 1) * ic_s], stable=True)
                salient_cols[s * ic_s + order[:k]] = True
        rows.append((~salient_cols)[None, :].expand(blk.shape[0], ic))
    return torch.cat(rows, dim=0)


def _f32(a, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.float().to(device)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def pack_linear_v2(w_q, mask, low_state: Dict, high_state: Dict, method: str,
                   col_tile: int = 0, bias=None, pack_block: Optional[int] = None,
                   k_multiple: int = 32, ic_shards: int = 1) -> Tuple[PackedLinearV2, Dict[str, float]]:
    """Pack a fake-quantized weight ``w_q`` [oc, ic] with a column-structured
    ``mask`` [oc, ic] (True ⇔ binarized) into the v2 layout, on ``w_q``'s
    device (numpy inputs: the CPU).  Only the salient column lists of each
    row group pass through the host."""
    if method not in ("xnor", "sign", "rtn", "prune", "2bit", "4bit"):
        raise ValueError(f"v2 cannot pack method {method!r}")
    low_bits = {"2bit": 2, "4bit": 4}.get(method, 1)
    w_q = _f32(w_q)
    dev = w_q.device
    oc, ic = w_q.shape
    if col_tile <= 0 or col_tile > oc:
        col_tile = oc
    if ic % 32:
        raise ValueError("pack_linear_v2 requires ic % 32 == 0")
    if ic % ic_shards:
        raise ValueError(f"ic {ic} not divisible by ic_shards {ic_shards}")
    if low_bits > 1 and ic_shards > 1:
        raise ValueError("multi-bit low planes cannot use the shard-major sidecar layout")
    ic_s = ic // ic_shards
    if isinstance(mask, torch.Tensor):
        salient = ~mask.to(dev).bool()
    else:
        salient = ~torch.from_numpy(np.array(mask, dtype=bool)).to(dev)
    n_rg = -(-oc // col_tile)

    idx_cols: list = []
    for t in range(n_rg):
        blk = salient[t * col_tile : (t + 1) * col_tile]
        if not bool((blk == blk[0:1]).all()):
            raise ValueError("mask is not column-structured within row groups; "
                             "calibrate with mask_structure='column'")
        row = blk[0].cpu().numpy()
        idx_cols.append([np.nonzero(row[s * ic_s : (s + 1) * ic_s])[0] for s in range(ic_shards)])
    k_max = max((len(c) for cols in idx_cols for c in cols), default=0)
    k_pad = max(k_multiple, -(-k_max // k_multiple) * k_multiple) if k_max else k_multiple

    side_idx = np.full((ic_shards * k_pad, n_rg), ic_s, np.int32)
    for t, cols in enumerate(idx_cols):
        for s, c in enumerate(cols):
            side_idx[s * k_pad : s * k_pad + len(c), t] = c

    low_scale, low_mean = _low_params(low_state, method, dev)
    if low_scale.shape[0] != 1:
        raise ValueError("v2 requires groupsize == -1 (whole-row low groups)")

    hs, hz = _f32(high_state["scale"], dev), _f32(high_state["zero"], dev)
    maxq = float(_f32(high_state.get("maxq", 255.0)))
    codes = torch.clamp(torch.round(w_q / hs[:, None] + hz[:, None]), 0, maxq).to(torch.uint8)

    side_val = torch.zeros((ic_shards * k_pad, oc), dtype=torch.uint8, device=dev)
    for t, cols in enumerate(idx_cols):
        lo, hi = t * col_tile, min((t + 1) * col_tile, oc)
        for s, c in enumerate(cols):
            rows = torch.as_tensor(s * ic_s + c, dtype=torch.long, device=dev)
            side_val[s * k_pad : s * k_pad + len(c), lo:hi] = codes[lo:hi, rows].T
    side_bits = 4 if maxq <= 15 else 8
    if side_bits == 4:
        seg = side_val.reshape(ic_shards, k_pad, oc)
        half = k_pad // 2
        side_val = (seg[:, :half] | (seg[:, half:] << 4)).reshape(ic_shards * half, oc)

    sal_t = salient.T
    if low_bits == 1:
        bits = ((w_q.T - low_mean) >= 0) & ~sal_t
        plane_list = [bits]
    else:
        scale_rows = torch.clamp(low_scale, min=1e-20)
        codes_low = torch.clamp(torch.round(w_q.T / scale_rows + low_mean), 0, 2**low_bits - 1).to(torch.int32)
        codes_low = torch.where(sal_t, 0, codes_low)
        plane_list = [((codes_low >> j) & 1).bool() for j in range(low_bits)]
    pack_block = pack_block or packing.default_pack_block(ic_s)
    if ic_shards > 1 and ic_s % pack_block:
        raise ValueError(f"pack_block {pack_block} must divide the ic shard width {ic_s}")

    packed = PackedLinearV2(
        sign_packed=torch.cat([packing.pack_bits(pl, pack_block) for pl in plane_list], dim=0),
        side_val=side_val,
        side_idx=torch.as_tensor(side_idx, device=dev),
        low_scale=low_scale, low_mean=low_mean, high_scale=hs, high_zero=hz,
        bias=None if bias is None else _f32(bias, dev),
        ic=ic, oc=oc, col_tile=col_tile, pack_block=pack_block, k_pad_shard=k_pad,
        side_bits=side_bits, low_bits=low_bits,
    )
    w_rt = dequantize_v2(packed).T
    diag = {"pack_mismatch": float(torch.mean(((w_rt - w_q).abs() > 1e-6).float())),
            "salient_frac": float(salient.float().mean()),
            "effective_bits": packed.effective_bits()}
    return packed, diag


def dequantize_v2(p: PackedLinearV2) -> torch.Tensor:
    """Dense f32 [ic, oc] (the kernels' oracle)."""
    ic, oc = p.ic_local, p.oc_local
    shards, ic_s, kps = p.shards_local, p.ic_shard_local, p.k_pad_shard_local
    dev = p.device
    side_val = unpack_side_codes(p.side_val, p.side_bits, shards)
    code = low_code(p.sign_packed, p.low_bits, ic, p.pack_block_local)
    if p.low_bits == 1:
        w_bin = p.low_mean[0][None, :] + (2.0 * code - 1.0) * p.low_scale[0][None, :]
    else:
        w_bin = p.low_scale[0][None, :] * (code - p.low_mean[0][None, :])

    codes = torch.zeros((ic_s + 1, shards, oc), dtype=torch.float32, device=dev)  # row ic_s = sink
    m = torch.zeros((ic_s + 1, shards, oc), dtype=torch.float32, device=dev)
    for t in range(p.n_row_groups):
        lo, hi = t * p.col_tile, min((t + 1) * p.col_tile, oc)
        for s in range(shards):
            idx = p.side_idx[s * kps : (s + 1) * kps, t].long()
            codes[idx, s, lo:hi] = side_val[s * kps : (s + 1) * kps, lo:hi].float()
            m[idx, s, lo:hi] = 1.0
    codes = codes[:ic_s].permute(1, 0, 2).reshape(ic, oc)
    m = m[:ic_s].permute(1, 0, 2).reshape(ic, oc)
    w_hi = p.high_scale[None, :] * (codes - p.high_zero[None, :])
    return torch.where(m > 0, w_hi, w_bin)


def matmul_reference_v2(x: torch.Tensor, p: PackedLinearV2) -> torch.Tensor:
    y = x.float() @ dequantize_v2(p)
    if p.bias is not None:
        y = y + p.bias
    return y


def merge_packed_linears_v2(ps) -> PackedLinearV2:
    """Concatenate same-input v2 layers along oc into one layer with one row
    group per part (col_tile = a part's oc, side_idx [k_pad, G]): the fused
    q|k|v and gate|up serving layout.  Its dequantization is the concat of
    the parts'.  Requires equal ic/oc/pack_block/side_bits/low_bits/k_pad,
    global selection and un-sharded sidecars, and bias on all or none."""
    p0 = ps[0]
    for p in ps:
        if not isinstance(p, PackedLinearV2):
            raise ValueError("merge_packed_linears_v2 needs PackedLinearV2 parts")
        if p.n_row_groups != 1 or p.shards_local != 1:
            raise ValueError("parts must be global-selection, un-sharded")
        if (p.ic, p.oc, p.pack_block, p.side_bits, p.low_bits, p.k_pad) != (
                p0.ic, p0.oc, p0.pack_block, p0.side_bits, p0.low_bits, p0.k_pad):
            raise ValueError("parts must agree on ic/oc/pack_block/side_bits/low_bits/k_pad")
        if (p.bias is None) != (p0.bias is None):
            raise ValueError("parts must uniformly have or lack bias")

    def cat(f, dim):
        return torch.cat([getattr(p, f) for p in ps], dim=dim)

    return PackedLinearV2(
        sign_packed=cat("sign_packed", 1), side_val=cat("side_val", 1),
        side_idx=cat("side_idx", 1), low_scale=cat("low_scale", 1), low_mean=cat("low_mean", 1),
        high_scale=cat("high_scale", 0), high_zero=cat("high_zero", 0),
        bias=None if p0.bias is None else cat("bias", 0),
        ic=p0.ic, oc=sum(p.oc for p in ps), col_tile=p0.oc, pack_block=p0.pack_block,
        k_pad_shard=0, side_bits=p0.side_bits, low_bits=p0.low_bits)


def gather_x_v2(x: torch.Tensor, p: PackedLinearV2) -> torch.Tensor:
    """[m, ic] → [m, total_k_pad, n_row_groups]; padding indices read an
    appended zero column per shard."""
    shards, ic_s, kps = p.shards_local, p.ic_shard_local, p.k_pad_shard_local
    m = x.shape[0]
    idx = p.side_idx.long()
    if shards == 1:
        x_aug = torch.cat([x, x.new_zeros((m, 1))], dim=1)
        return x_aug[:, idx]
    xs = x.reshape(m, shards, ic_s)
    x_aug = torch.cat([xs, x.new_zeros((m, shards, 1))], dim=2)       # [m, S, ic_s+1]
    idx = idx.reshape(shards, kps, p.n_row_groups)
    gat = torch.stack([x_aug[:, s][:, idx[s]] for s in range(shards)], dim=1)  # [m, S, kps, n_rg]
    return gat.reshape(m, shards * kps, p.n_row_groups)


# ---------------------------------------------------------------------------
# Serialization: the JAX package's planes.npz + manifest.json layout.
# ---------------------------------------------------------------------------

_FIELDS = ("sign_packed", "mask_packed", "sidecar", "low_scale", "low_mean",
           "high_scale", "high_zero", "bias")
_FIELDS_V2 = ("sign_packed", "side_val", "side_idx", "low_scale", "low_mean",
              "high_scale", "high_zero", "bias")
# static fields as checkpoint manifests name them
STATIC = ("ic", "oc", "groupsize", "pack_block", "sidecar_bits", "low_bits")
STATIC_V2 = ("ic", "oc", "col_tile", "pack_block", "k_pad_shard", "side_bits", "low_bits")
_PLANES = ("sign_packed", "mask_packed")  # uint32 on disk, bit-identical int32 here


def fields_of(p) -> Tuple[str, ...]:
    return _FIELDS_V2 if isinstance(p, PackedLinearV2) else _FIELDS


def _to_numpy(f: str, v: torch.Tensor) -> np.ndarray:
    a = v.detach().cpu().numpy()
    return a.view(np.uint32) if f in _PLANES else a


def _from_numpy(f: str, a: np.ndarray) -> torch.Tensor:
    if f in _PLANES:
        a = np.ascontiguousarray(a).view(np.int32)
    return torch.from_numpy(np.array(a))


def layer_from_arrays(static: Dict, arrays: Dict[str, np.ndarray], v2: bool):
    """A PackedLinearV2 (``v2``) or PackedLinear from its static fields and
    its numpy field arrays (bit planes as uint32 or int32); missing
    optional fields take the JAX defaults."""
    kw = {f: _from_numpy(f, a) for f, a in arrays.items()}
    kw.setdefault("bias", None)
    st = {f: int(static[f]) for f in (STATIC_V2 if v2 else STATIC) if static.get(f) is not None}
    return (PackedLinearV2 if v2 else PackedLinear)(**st, **kw)


def _manifest_entry(p) -> dict:
    """A layer's entry in the JAX manifest: v2 carries "format", v1 none."""
    if isinstance(p, PackedLinearV2):
        return {"format": "v2", "ic": p.ic, "oc": p.oc, "col_tile": p.col_tile,
                "pack_block": p.pack_block, "k_pad_shard": p.k_pad_shard_local,
                "side_bits": p.side_bits, "low_bits": p.low_bits, "has_bias": p.bias is not None}
    return {"ic": p.ic, "oc": p.oc, "groupsize": p.groupsize, "pack_block": p.pack_block,
            "sidecar_bits": p.sidecar_bits, "low_bits": p.low_bits,
            "has_bias": p.bias is not None}


def save_pbw(path: str, layers: Dict, extra_meta: Optional[dict] = None) -> None:
    """Write v1 and v2 layers (keys "layer_{i}/{name}") as the JAX package
    does."""
    os.makedirs(path, exist_ok=True)
    arrays = {}
    meta = {"layers": {}, "extra": extra_meta or {}}
    for name, p in layers.items():
        meta["layers"][name] = _manifest_entry(p)
        for f in fields_of(p):
            v = getattr(p, f)
            if v is not None:
                arrays[f"{name}::{f}"] = _to_numpy(f, v)
    np.savez(os.path.join(path, "planes.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as fh:
        json.dump(meta, fh, indent=1)


class _ShardedNpz:
    """planes.npz-compatible view over per-layer shard files."""

    def __init__(self, path: str, files: Dict[str, str]):
        self._paths = {name: os.path.join(path, fname) for name, fname in files.items()}

    def __contains__(self, key: str) -> bool:
        name = key.split("::", 1)[0]
        if name not in self._paths:
            return False
        with np.load(self._paths[name]) as z:
            return key in z.files

    def __getitem__(self, key: str) -> np.ndarray:
        with np.load(self._paths[key.split("::", 1)[0]]) as z:
            return z[key]


def load_pbw(path: str) -> Tuple[Dict, dict]:
    """Load a PBW v1 or v2 artifact (monolithic or sharded) as CPU tensors."""
    with open(os.path.join(path, "manifest.json")) as fh:
        meta = json.load(fh)
    z = _ShardedNpz(path, meta["files"]) if "files" in meta else np.load(os.path.join(path, "planes.npz"))
    layers = {}
    for name, lm in meta["layers"].items():
        v2 = lm.get("format") == "v2"
        static = dict(lm, pack_block=lm.get("pack_block", packing.PACK_BLOCK))
        arrays = {f: z[f"{name}::{f}"] for f in (_FIELDS_V2 if v2 else _FIELDS)
                  if f"{name}::{f}" in z}
        layers[name] = layer_from_arrays(static, arrays, v2)
    return layers, meta["extra"]


class PBWShardWriter:
    """Incremental PBW writer: one ``planes_XXXXX.npz`` per layer, written
    the moment it is added, and ``finalize`` writes the manifest with a
    ``files`` map, as the JAX package's writer does; `load_pbw` (either
    package's) reads the result.  For conversions that never hold the
    whole model (`models.hf_stream`, `calib.pipeline`'s streamed path)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._meta: Dict[str, dict] = {}
        self._files: Dict[str, str] = {}

    def add_layer(self, name: str, p) -> str:
        """Write layer ``p`` (v1 or v2) under ``name``; returns its file."""
        self._meta[name] = _manifest_entry(p)
        arrays = {f"{name}::{f}": _to_numpy(f, getattr(p, f))
                  for f in fields_of(p) if getattr(p, f) is not None}
        fname = f"planes_{len(self._files):05d}.npz"
        np.savez(os.path.join(self.path, fname), **arrays)
        self._files[name] = fname
        return fname

    def finalize(self, extra_meta: Optional[dict] = None) -> None:
        meta = {"layers": self._meta, "files": self._files, "extra": extra_meta or {}}
        with open(os.path.join(self.path, "manifest.json"), "w") as fh:
            json.dump(meta, fh, indent=1)


def install_pbw(params: Dict, layers: Dict) -> Dict:
    """Install loaded layers (keys "layer_{i}/{name}") into a param tree,
    replacing the dense leaves; each layer moves to its leaf's device.
    Non-mutating."""
    params = dict(params)
    new_layers = [dict(lp) for lp in params["layers"]]
    for key, packed in layers.items():
        prefix, name = key.split("/", 1)
        idx = int(prefix.split("_")[1])
        old = new_layers[idx].get(name)
        dev = old["w"].device if isinstance(old, dict) else packed.device
        new_layers[idx][name] = packed.to(dev)
    params["layers"] = new_layers
    return params
