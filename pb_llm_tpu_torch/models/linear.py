"""Linear-layer abstraction (port of `pb_llm_tpu/models/linear.py`): a
linear is a dense dict ``{"w": [ic, oc], "b": [oc] | None}``, a
`core.pbw.PackedLinear` (PBW v1), a `core.pbw.PackedLinearV2`, or a
`models.stacking.StackedPackedLinearV2` marker (layer li of stacked v2
planes), and `apply_linear` dispatches on the type."""

from __future__ import annotations

import torch

from ..core.pbw import PackedLinear, PackedLinearV2
from .stacking import StackedPackedLinearV2


def apply_linear(lin, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W (+ b); x [..., ic]."""
    if isinstance(lin, (PackedLinear, PackedLinearV2, StackedPackedLinearV2)):
        from ..ops.binary_matmul import pb_matmul, pb_matmul_stacked

        fn = pb_matmul_stacked if isinstance(lin, StackedPackedLinearV2) else pb_matmul
        lead = x.shape[:-1]
        y = fn(x.reshape(-1, x.shape[-1]), lin)
        return y.reshape(*lead, -1).to(x.dtype)
    y = x @ lin["w"].to(x.dtype)
    if lin.get("b") is not None:
        y = y + lin["b"].to(x.dtype)
    return y


def linear_shape(lin) -> tuple:
    """(ic, oc) of any of the representations."""
    if isinstance(lin, StackedPackedLinearV2):
        _, rows, oc = lin.stacked.sign_packed.shape
        return rows // lin.stacked.low_bits * 32, oc
    if isinstance(lin, (PackedLinear, PackedLinearV2)):
        return lin.ic_local, lin.oc_local
    return tuple(lin["w"].shape)
