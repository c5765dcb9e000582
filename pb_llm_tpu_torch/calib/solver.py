"""GPTQ-PB solver: Hessian-compensated partial binarization (port of
`pb_llm_tpu/calib/solver.py`, itself the reference's
`LowHighGPT.fasterquant`, `gptq_pb/gptq.py:54-187`).

Every weight entry goes to the low (binary) or the high (8-bit) quantizer
by a salient mask, with GPTQ error feedback into the columns not yet
quantized:

  1. high-quantizer calibration on the full W            (gptq.py:62-63)
  2. dead columns: diag(H) == 0 → H[ii] = 1, W[:, i] = 0  (gptq.py:69-71)
  3. damping: H += percdamp·mean(diag H)·I               (gptq.py:75-77)
  4. Hinv = upper Cholesky factor of H⁻¹                 (gptq.py:78-81)
  5. per ic-group salient mask by |W| or W²/diag(Hinv)² (mask True ⇔
     binarized), element-wise quantile or whole columns  (gptq.py:84-101)
  6. low-quantizer calibration on W·mask                 (gptq.py:102-105)
  7. blocked column loop: q = mask ? q_low : q_high; err = (w − q)/Hinv[i,i];
     W1[:, i:] −= err ⊗ Hinv1[i, i:]; then W[:, ed:] −= Err1 @ Hinv[st:ed, ed:]
  8. RTN arm (disable_gptq): the same select, no feedback (gptq.py:119-127)
  9. error = Σ (w − q)²/d²/2

The column loop is the reference's eager form: Python loops over suffix
slices (the JAX package's static-shape masked updates are a device for
XLA).  On the card that is some ten small launches per column.  Products run
in full f32 (`no_tf32`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from .. import no_tf32
from ..core.pbw import column_structured_mask
from ..quant.high_quant import high_calibrate, high_quantize
from ..quant.low_quant import low_calibrate, low_quantize_cols, n_groups_for
from ..quant.reduce import tree_mean


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    low_method: str = "xnor"         # xnor|sign|rtn|no|2bit|4bit|prune
    low_frac: float = 0.5            # fraction binarized
    high_bit: int = 8
    groupsize: int = -1              # ic-group size for the low quantizer
    salient_metric: str = "magnitude"  # magnitude|hessian
    blocksize: int = 128
    percdamp: float = 0.01
    disable_gptq: bool = False
    high_sym: bool = False
    high_mse: bool = False
    # "element": the reference's element-wise quantile; "column": whole
    # input columns per col_tile output-row group (PBW v2's constraint)
    mask_structure: str = "element"
    col_tile: int = 0                # 0 = one global column set per layer
    ic_shards: int = 1               # balance columns per contiguous ic shard


def _block_size_for(ic: int, requested: int) -> int:
    b = min(requested, ic)
    while ic % b:
        b -= 1
    return b


def prepare_hinv(h: torch.Tensor, w: torch.Tensor, percdamp: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steps 2-4 → (Hinv upper-triangular, W with dead columns zeroed)."""
    ic = h.shape[0]
    dead = torch.diagonal(h) == 0
    h = h + torch.diag(dead.float())
    w = torch.where(dead[None, :], 0.0, w)
    damp = percdamp * tree_mean(torch.diagonal(h))
    h = h + damp * torch.eye(ic, dtype=h.dtype, device=h.device)
    chol = torch.linalg.cholesky(h)
    hinv_full = torch.cholesky_solve(torch.eye(ic, dtype=h.dtype, device=h.device), chol)
    return torch.linalg.cholesky(hinv_full).T, w


def salient_masks(w: torch.Tensor, hinv: torch.Tensor, low_frac: float, groupsize: int,
                  metric: str, structure: str = "element", col_tile: int = 256,
                  ic_shards: int = 1) -> torch.Tensor:
    """Step 5: mask [oc, ic], True ⇔ binarized.  ``structure="column"``
    selects round((1 − low_frac)·cols) whole salient columns per
    ``col_tile`` output-row group (0 or ≥ oc: one global set)."""
    oc, ic = w.shape
    if col_tile <= 0 or col_tile > oc:
        col_tile = oc
    gs = ic if groupsize == -1 else groupsize
    diag = torch.diagonal(hinv)
    cols = []
    for g in range(n_groups_for(ic, groupsize)):
        st, ed = g * gs, min((g + 1) * gs, ic)
        wg = w[:, st:ed]
        if metric == "magnitude":
            saliency = torch.abs(wg)
        elif metric == "hessian":
            d = diag[st:ed][None, :]
            saliency = (wg * wg) / (d * d)
        else:
            raise NotImplementedError(f"salient metric {metric}")
        if structure == "element":
            k = min(int(saliency.numel() * low_frac), saliency.numel() - 1)
            thresh = torch.sort(saliency.reshape(-1)).values[k]
            cols.append(saliency <= thresh)
        elif structure == "column":
            if (ed - st) % ic_shards:
                raise ValueError("ic_shards must divide the group width; use groupsize=-1")
            cols.append(column_structured_mask(saliency, low_frac, col_tile, ic_shards))
        else:
            raise NotImplementedError(f"mask structure {structure}")
    return torch.cat(cols, dim=1)


def _quantize_cols(wc, mc, groupi, low_state, high_state, method):
    """q = mask ? q_low : q_high for columns wc [oc, k]."""
    return torch.where(mc, low_quantize_cols(wc, low_state, method, groupi),
                       high_quantize(wc, high_state))


def gptq_pb(w: torch.Tensor, h: torch.Tensor, cfg: SolverConfig) -> Dict[str, torch.Tensor]:
    """Quantize one linear weight w [oc, ic] given its input Hessian h
    [ic, ic] (both on one device).  Returns {w_q, mask, low_state,
    high_state, error}; w_q holds the fake-quant values that
    `core.pbw.pack_linear_v2` packs."""
    with no_tf32():
        return _solve(w.float(), h.float(), cfg)


def _solve(w0: torch.Tensor, h: torch.Tensor, cfg: SolverConfig) -> Dict[str, torch.Tensor]:
    oc, ic = w0.shape
    gs = ic if cfg.groupsize == -1 else cfg.groupsize
    high_state = high_calibrate(w0, bits=cfg.high_bit, sym=cfg.high_sym, mse=cfg.high_mse)
    hinv, w = prepare_hinv(h, w0, cfg.percdamp)
    mask = salient_masks(w, hinv, cfg.low_frac, cfg.groupsize, cfg.salient_metric,
                         cfg.mask_structure, cfg.col_tile, cfg.ic_shards)
    low_state = low_calibrate(w * mask, cfg.low_method, cfg.groupsize)
    bsz = _block_size_for(ic, cfg.blocksize)
    diag = torch.diagonal(hinv)
    losses = torch.zeros(oc, dtype=torch.float32, device=w.device)
    w = w.clone()

    def quant(wc, mc, groupi):
        return _quantize_cols(wc, mc, groupi, low_state, high_state, cfg.low_method)

    for st in range(0, ic, bsz):
        ed = st + bsz
        groupi = st // gs
        if cfg.disable_gptq:
            # the reference's RTN path tracks no losses (gptq.py:119-127);
            # the same error definition is reported for observability
            w1 = w[:, st:ed]
            q1 = quant(w1, mask[:, st:ed], groupi)
            losses += torch.sum((w1 - q1) ** 2 / diag[None, st:ed] ** 2, dim=1) / 2.0
            w[:, st:ed] = q1
            continue
        w1 = w[:, st:ed].clone()
        m1 = mask[:, st:ed]
        hinv1 = hinv[st:ed, st:ed]
        q1 = torch.zeros_like(w1)
        err1 = torch.zeros_like(w1)
        losses1 = torch.zeros(oc, dtype=torch.float32, device=w.device)
        for i in range(bsz):
            wcol = w1[:, i : i + 1]
            d = hinv1[i, i]
            q = quant(wcol, m1[:, i : i + 1], groupi)
            err = (wcol - q) / d
            losses1 += ((wcol - q) ** 2 / d**2)[:, 0]
            w1[:, i:] -= err * hinv1[i, i:][None, :]
            q1[:, i : i + 1] = q
            err1[:, i : i + 1] = err
        w[:, ed:] -= err1 @ hinv[st:ed, ed:]
        w[:, st:ed] = q1
        losses += losses1 / 2.0
    return {"w_q": w, "mask": mask, "low_state": low_state, "high_state": high_state,
            "error": torch.sum(losses)}
