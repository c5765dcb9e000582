"""High-bit (salient side) quantizer (port of `pb_llm_tpu/quant/high_quant.py`):
per-output-channel (per row of [oc, ic]) uniform quantization with
maxq = 2**bits − 1, calibrated once on the whole weight.

    xmin = min(row_min, 0); xmax = max(row_max, 0); both zero → (−1, +1)
    sym: xmax = max(|xmin|, xmax); xmin = −xmax where xmin < 0;
         zero = (maxq + 1) / 2
    asym: zero = round(−xmin / scale)
    scale = (xmax − xmin) / maxq
    q(x) = scale · (clamp(round(x / scale) + zero, 0, maxq) − zero)

``mse`` searches clip shrinkage p = 1 − i/grid (i < maxshrink·grid) for the
least Σ|q − w|^norm per row.  Divisions by maxq and grid and the error sum
follow the f32 order the JAX package's calibration compiles to
(`quant.reduce`).
"""

from __future__ import annotations

from typing import Dict

import torch

from .reduce import fma, recip, tree_sum


def _codes(x, scale, zero, maxq):
    """clamp(round(x / scale) + zero, 0, maxq); maxq a float or 0-d tensor
    (a tensor keeps the column loop free of host syncs)."""
    q = torch.clamp(torch.round(x / scale[:, None]) + zero[:, None], min=0.0)
    return torch.minimum(q, torch.as_tensor(maxq, dtype=q.dtype, device=q.device))


def _quantize_rows(x, scale, zero, maxq):
    return scale[:, None] * (_codes(x, scale, zero, maxq) - zero[:, None])


def high_calibrate(w: torch.Tensor, bits: int, sym: bool = False, mse: bool = False,
                   norm: float = 2.4, grid: int = 100,
                   maxshrink: float = 0.8) -> Dict[str, torch.Tensor]:
    """Calibrate on the full weight [oc, ic] → {scale, zero, maxq}; scale and
    zero [oc], maxq a 0-d f32 tensor."""
    w = w.float()
    dev = w.device
    maxq = float(2**bits - 1)
    inv_maxq = recip(maxq).to(dev)
    xmin = torch.clamp(torch.amin(w, dim=-1), max=0.0)
    xmax = torch.clamp(torch.amax(w, dim=-1), min=0.0)
    if sym:
        xmax = torch.maximum(torch.abs(xmin), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)
    scale = (xmax - xmin) * inv_maxq
    if sym:
        zero = torch.full_like(scale, (maxq + 1) / 2)
    else:
        zero = torch.round(-xmin / scale)

    if mse:
        best = torch.full((w.shape[0],), float("inf"), dtype=torch.float32, device=dev)
        inv_grid = recip(grid).to(dev)
        for i in range(int(maxshrink * grid)):
            p = 1.0 - torch.tensor(float(i), device=dev) * inv_grid
            xmin1 = p * xmin
            # p·xmax − p·xmin: XLA fuses the first product into the subtraction
            scale1 = fma(p, xmax, -xmin1).to(dev) * inv_maxq
            zero1 = zero if sym else torch.round(-xmin1 / scale1)
            q = _quantize_rows(w, scale1, zero1, maxq)
            err = tree_sum(torch.abs(q - w) ** norm)
            better = err < best
            best = torch.where(better, err, best)
            scale = torch.where(better, scale1, scale)
            zero = torch.where(better, zero1, zero)

    return {"scale": scale, "zero": zero, "maxq": torch.tensor(maxq, device=dev)}


def high_quantize(x: torch.Tensor, state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Fake-quantize [oc, k] columns with the calibrated per-row params."""
    return _quantize_rows(x.float(), state["scale"], state["zero"], state["maxq"])


def high_codes(x: torch.Tensor, state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Integer codes clamp(round(x/scale)+zero, 0, maxq) as uint8 (bits ≤ 8)."""
    return _codes(x.float(), state["scale"], state["zero"], state["maxq"]).to(torch.uint8)
