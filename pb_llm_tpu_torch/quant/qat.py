"""QAT partially-binarized linear layers (port of `pb_llm_tpu/quant/qat.py`).

  * `weight_quant_8bit` — per-row asymmetric uint8 fake-quant with a
    *rounded* zero point (zp = round(row min)), in JAX's order of
    operations, so it is bit for bit the JAX package's in both modes.
  * outlier mask — global (whole-matrix) two-sided magnitude thresholds at
    ``outlier_fraction`` via k-th order statistics (1-indexed, one sort of
    the flattened matrix), or a GPTQ-PB *binarized* mask inverted (QAT's
    mask True ⇔ salient).
  * master weight frozen to simulated-8bit at mask time.
  * forward — `where(outlier_mask, (w·outlier_scale).detach(),
    ste_sign(w)·binary_scale)` with a **scalar** binary_scale = mean
    |non-outlier w| recomputed from the live weight.
  * the XNOR, plain, IR-Net, FDA and BiReal ablation layers.

JAX's `stop_gradient`s are `.detach()`s in the same places.  A QATLinear is
a leaf the model's ``linear_fn`` dispatches on (`train.qat.qat_linear_fn`);
its ``weight`` and ``bias`` are f32 leaf tensors that require grad.

Across ranks (`train.qat` under a mesh) a QATLinear holds its tp block, and
its statistics are made global by hand, as GSPMD does for JAX's step:
``group`` is the process group the weight is split over, and
``split_ic`` says that its ic (each row) is split over it (row-parallel).
The binary scale all-reduces its f64 partial sum and its keep count over
``group``; the per-row means of xnor, irnet and bireal all-reduce their row
sums when ``split_ic`` (the centring mean with its gradient,
`parallel.collectives.all_reduce_sum`).  The outlier mask is fixed before
training and only sharded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .ste import fda_sign, irnet_sign, ste_sign

QAT_METHODS = ("xnor_outlier", "xnor_outlier_hessian", "xnor", "plain", "irnet", "fda", "bireal")


@dataclasses.dataclass
class QATLinear:
    """Partially-binarized linear under training. weight is [oc, ic] (the
    reference orientation) so the quantization math matches line for line."""

    weight: torch.Tensor                # [oc, ic] master (sim-8bit frozen at mask time)
    bias: Optional[torch.Tensor]        # [oc]
    outlier_mask: torch.Tensor          # bool [oc, ic]; True ⇔ salient (8-bit)
    method: str = "xnor_outlier"
    outlier_scale: float = 1.0
    train_outlier: bool = False


def weight_quant_8bit(w: torch.Tensor, wrap_compat: bool = False) -> torch.Tensor:
    """Per-row asymmetric uint8 fake-quant, zp rounded to an integer.

    Default clamps the code to [0, 255]; ``wrap_compat=True`` reproduces the
    reference's uint8 cast, which wraps negative codes mod 256 (int32 & 255
    of the truncated float, as the JAX package does)."""
    w = w.float()
    w_min = torch.amin(w, dim=-1, keepdim=True)
    w_range = torch.amax(w, dim=-1, keepdim=True) - w_min
    zp = torch.round(w_min)
    qf = torch.round((w - zp) / w_range * 255.0)
    if wrap_compat:
        q = (qf.to(torch.int32) & 255).float()
    else:
        q = torch.clamp(qf, 0.0, 255.0) + 0.0  # XLA's clip turns -0.0 into +0.0; so does + 0.0
    # a tensor divisor: PyTorch's CUDA kernels multiply by the reciprocal of a
    # Python-scalar divisor, which is not IEEE division (nor JAX's)
    return q * (w_range / torch.tensor(255.0, device=w.device)) + zp


def gen_outlier_mask(w: torch.Tensor, outlier_fraction: float) -> torch.Tensor:
    """Two-sided global magnitude thresholds: the k-th smallest values
    (1-indexed, as torch.kthvalue) of the flattened matrix."""
    flat = torch.sort(w.reshape(-1)).values
    n = flat.numel()
    k_lo = max(int(n * outlier_fraction / 2), 1)
    k_hi = max(int(n * (1 - outlier_fraction / 2)), 1)
    lower, upper = flat[k_lo - 1], flat[k_hi - 1]
    return (w < lower) | (w > upper)


def make_qat_linear(
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    outlier_fraction: float,
    method: str = "xnor_outlier",
    gptq_mask: Optional[np.ndarray] = None,
    freeze_8bit: bool = True,
    wrap_compat: bool = False,
) -> QATLinear:
    """Build a QATLinear from a dense [oc, ic] weight.  ``gptq_mask``: a
    GPTQ-PB *binarized* mask for the hessian variant, inverted here; the
    magnitude mask when absent."""
    w = torch.as_tensor(weight).detach().float()
    if method == "xnor_outlier_hessian" and gptq_mask is not None:
        mask = ~torch.as_tensor(np.asarray(gptq_mask, bool), device=w.device)
    else:
        mask = gen_outlier_mask(w, outlier_fraction)
    w = weight_quant_8bit(w, wrap_compat) if freeze_8bit else w.clone()
    return QATLinear(
        weight=w.requires_grad_(True),
        bias=None if bias is None else torch.as_tensor(bias).detach().float().clone()
        .requires_grad_(True),
        outlier_mask=mask,
        method=method,
    )


def binary_scale_of(q: QATLinear, group=None) -> torch.Tensor:
    """Scalar mean |non-outlier weight|, detached.  The sum accumulates in
    f64 before its f32 rounding, so it is the same on every device; JAX's
    f32 tree sum lies within a few ulps of it (tests/test_torch_qat.py).
    With ``group`` (the ranks the weight is split over) the f64 partial sums
    and keep counts are all-reduced, then rounded once."""
    keep = ~q.outlier_mask
    w = q.weight.detach()
    total = torch.sum(torch.abs(w) * keep, dtype=torch.float64)
    count = keep.sum()
    if group is not None:
        both = torch.stack([total, count.to(torch.float64)])
        dist.all_reduce(both, group=group)
        total, count = both[0], both[1].to(count.dtype)
    return total.float() / torch.clamp(count, min=1)


def _row_mean(w: torch.Tensor, group, split_ic: bool) -> torch.Tensor:
    """mean over each row (ic); over a row split across ``group`` the row
    sums are all-reduced (with the gradient when ``w`` carries one)."""
    if not split_ic or group is None:
        return torch.mean(w, dim=-1, keepdim=True)
    from ..parallel.collectives import all_reduce_sum

    n = w.shape[-1] * dist.get_world_size(group)
    return all_reduce_sum(torch.sum(w, dim=-1, keepdim=True), group) / n


def quant_weight(q: QATLinear, group=None, split_ic: bool = False) -> torch.Tensor:
    """The fake-quant weight used in the forward pass (of this rank's block
    when ``group`` is given: see the module docstring)."""
    w = q.weight
    if q.method in ("xnor_outlier", "xnor_outlier_hessian"):
        scaled = w * q.outlier_scale
        if not q.train_outlier:
            scaled = scaled.detach()
        binary = ste_sign(w) * binary_scale_of(q, group)
        return torch.where(q.outlier_mask, scaled, binary)
    if q.method in ("xnor", "irnet"):  # XnorBinaryLinear / IrBinaryLinear (quantizer.py:172-193, 89-109)
        centered = w - _row_mean(w, group, split_ic)
        scale = _row_mean(torch.abs(centered.detach()), group, split_ic)
        return (ste_sign(centered) if q.method == "xnor" else irnet_sign(centered)) * scale
    if q.method == "plain":  # BinaryLinear (quantizer.py:75-86)
        return ste_sign(w)
    if q.method == "fda":  # FdaBinaryLinear (quantizer.py:112-128)
        return fda_sign(w)
    if q.method == "bireal":  # BiRealLinear weight path (quantizer.py:140-149)
        scale = _row_mean(torch.abs(w.detach()), group, split_ic)
        # jnp.clip is max then min, whose gradient at a tie (w = ±1, which
        # the sim-8bit master holds exactly) is a half; torch.clamp's is 1
        clipped = torch.minimum(torch.maximum(w, w.new_tensor(-1.0)), w.new_tensor(1.0))
        return (scale * torch.sign(w) - clipped).detach() + clipped
    raise NotImplementedError(f"qat method {q.method}")


def bireal_activation(x: torch.Tensor) -> torch.Tensor:
    """BiReal's input binarization: forward sign, backward the piecewise
    polynomial surrogate, via the subtract-detached-residual trick."""
    out_forward = torch.sign(x)
    m1 = (x < -1).to(x.dtype)
    m2 = (x < 0).to(x.dtype)
    m3 = (x < 1).to(x.dtype)
    out1 = -1.0 * m1 + (x * x + 2 * x) * (1 - m1)
    out2 = out1 * m2 + (-x * x + 2 * x) * (1 - m2)
    out3 = out2 * m3 + 1.0 * (1 - m3)
    return (out_forward - out3).detach() + out3


def apply_qat_linear(q: QATLinear, x: torch.Tensor, group=None,
                     split_ic: bool = False) -> torch.Tensor:
    if q.method == "bireal":  # BiReal binarizes activations too
        x = bireal_activation(x)
    w = quant_weight(q, group, split_ic)
    y = x @ w.T.to(x.dtype)
    if q.bias is not None:
        y = y + q.bias.to(x.dtype)
    return y


def to_dense(q: QATLinear) -> Dict[str, Optional[torch.Tensor]]:
    """The fake-quant weight as an [ic, oc] dense leaf (no autograd history)."""
    with torch.no_grad():
        return {"w": quant_weight(q).T.contiguous(),
                "b": None if q.bias is None else q.bias.detach().clone()}


def mean_effective_bits(q: QATLinear) -> float:
    """1 (sign) + CSR sidecar bits/weight."""
    from ..core.packing import csr_sidecar_bits

    return 1.0 + csr_sidecar_bits(q.outlier_mask.cpu().numpy())
