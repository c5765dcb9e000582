"""Hessian accumulation for GPTQ-PB calibration (port of
`pb_llm_tpu/calib/hessian.py`).

Reference semantics (`gptq_pb/gptq.py:35-52`): each calibration sample's
layer inputs X_s [tokens, ic] fold into a running H with the rescale that
keeps H_k = (2/k)·Σ_{s≤k} X_sᵀX_s independent of how the samples are
batched.  Products are full f32 (`no_tf32`, as the reference disables TF32).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import no_tf32


def fold_coefficients(start: int, batch: int):
    """Per-sample rescale scalars for folding samples start..start+batch:
    h ← h·a_j + b_j·XᵀX with a_j = j/(j+1), b_j = 2/(j+1), computed as host
    doubles and rounded to f32, exactly as the JAX package does."""
    a = np.asarray([(start + j) / (start + j + 1) for j in range(batch)], np.float32)
    b = np.asarray([2.0 / (start + j + 1) for j in range(batch)], np.float32)
    return a, b


def hessian_fold_chunk(h: torch.Tensor, xs: torch.Tensor, coef_a, coef_b) -> torch.Tensor:
    """Fold a chunk of samples xs [B, tokens, ic] into h [ic, ic], one
    sample at a time, as the reference's per-sample update does."""
    with no_tf32():
        for j in range(xs.shape[0]):
            xj = xs[j].float()
            h = h * float(coef_a[j]) + float(coef_b[j]) * (xj.T @ xj)
    return h
