"""Low-bit ("binary side") quantizers (port of `pb_llm_tpu/quant/low_quant.py`).

Weight orientation as in the reference: ``w`` is [oc, ic] and groups tile
the ic axis.  Methods:

  xnor   mean = mean(w), scale = mean(|w − mean|); q = sign(w − mean)·scale + mean
  sign   scale = mean(relu(w)); q = (w > 0)·scale
  rtn    scale = mean(|w|) + 1e-5; q = clamp(round(relu(w)/scale), 0, 1)·scale
  2bit/4bit  asymmetric uniform min/max per row (maxq 3 / 7); the per-row
         zero point, as in the JAX package (the reference's indexing slip
         at `low_quant.py:65` is not reproduced)
  no     identity; prune → 0.

Calibration runs on masked weights (w · binarized mask), zeros included in
the means, as the GPTQ-PB driver does.  Means and divisions by constants
follow the reference's f32 order (`quant.reduce`), so states are bit for
bit equal to the JAX package's.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reduce import fma, recip, tree_mean, tree_sum

LOW_METHODS = ("xnor", "sign", "rtn", "no", "prune", "2bit", "4bit")


def n_groups_for(ic: int, groupsize: int) -> int:
    gs = ic if groupsize == -1 else groupsize
    return math.ceil(ic / gs)


def _group_bounds(ic: int, groupsize: int):
    gs = ic if groupsize == -1 else groupsize
    return [(g * gs, min(g * gs + gs, ic)) for g in range(n_groups_for(ic, groupsize))]


def low_maxq(method: str) -> float:
    return 3.0 if method == "2bit" else 7.0


def low_calibrate_group(w_group: torch.Tensor, method: str) -> Dict[str, torch.Tensor]:
    """One ic-group [oc, width] (already salient-masked) → {scale, mean,
    zero}, each [oc]."""
    w = w_group.float()
    zeros = torch.zeros(w.shape[0], dtype=torch.float32, device=w.device)
    if method == "xnor":
        mean = tree_mean(w)
        return {"scale": tree_mean(torch.abs(w - mean[:, None])), "mean": mean, "zero": zeros}
    if method == "sign":
        return {"scale": tree_mean(torch.clamp(w, min=0.0)), "mean": zeros, "zero": zeros}
    if method == "rtn":
        # mean(|w|) + 1e-5: XLA fuses the mean's reciprocal product and the add
        scale = fma(tree_sum(torch.abs(w)), recip(w.shape[-1]), torch.tensor(1e-5, dtype=torch.float32))
        return {"scale": scale.to(w.device), "mean": zeros, "zero": zeros}
    if method in ("no", "prune"):
        return {"scale": zeros, "mean": zeros, "zero": zeros}
    if method in ("2bit", "4bit"):
        xmin = torch.clamp(torch.amin(w, dim=-1), max=0.0)
        xmax = torch.clamp(torch.amax(w, dim=-1), min=0.0)
        degenerate = (xmin == 0) & (xmax == 0)
        xmin = torch.where(degenerate, -1.0, xmin)
        xmax = torch.where(degenerate, 1.0, xmax)
        scale = (xmax - xmin) * recip(low_maxq(method)).to(w.device)
        return {"scale": scale, "mean": zeros, "zero": torch.round(-xmin / scale)}
    raise NotImplementedError(f"low method {method}")


def low_calibrate(w: torch.Tensor, method: str, groupsize: int = -1) -> Dict[str, torch.Tensor]:
    """All groups of w [oc, ic] (salient-masked) → {scale, mean, zero}, each
    [n_groups, oc]."""
    parts = [low_calibrate_group(w[:, st:ed], method) for st, ed in _group_bounds(w.shape[1], groupsize)]
    return {k: torch.stack([p[k] for p in parts], dim=0) for k in ("scale", "mean", "zero")}


def low_quantize_cols(w_cols: torch.Tensor, state: Dict[str, torch.Tensor], method: str,
                      groupi: int) -> torch.Tensor:
    """Fake-quantize columns [oc, k] with group ``groupi``'s params."""
    w = w_cols.float()
    scale = state["scale"][groupi][:, None]
    if method == "xnor":
        mean = state["mean"][groupi][:, None]
        return torch.sign(w - mean) * scale + mean
    if method == "sign":
        return (w > 0).float() * scale
    if method == "rtn":
        return torch.clamp(torch.round(torch.clamp(w, min=0.0) / scale), 0.0, 1.0) * scale
    if method in ("2bit", "4bit"):
        zero = state["zero"][groupi][:, None]
        q = torch.clamp(torch.round(w / scale) + zero, 0.0, low_maxq(method))
        return scale * (q - zero)
    if method == "no":
        return w
    if method == "prune":
        return torch.zeros_like(w)
    raise NotImplementedError(f"low method {method}")


def low_quantize(w: torch.Tensor, state: Dict[str, torch.Tensor], method: str,
                 groupsize: int = -1) -> torch.Tensor:
    """Fake-quantize the whole matrix [oc, ic] group by group."""
    return torch.cat([low_quantize_cols(w[:, st:ed], state, method, g)
                      for g, (st, ed) in enumerate(_group_bounds(w.shape[1], groupsize))], dim=1)
