"""Linear-layer abstraction (port of `pb_llm_tpu/models/linear.py`): a
linear is a dense dict ``{"w": [ic, oc], "b": [oc] | None}`` or a
`core.pbw.PackedLinear` (PBW v1) or `core.pbw.PackedLinearV2`, and
`apply_linear` dispatches on the type."""

from __future__ import annotations

import torch

from ..core.pbw import PackedLinear, PackedLinearV2


def apply_linear(lin, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W (+ b); x [..., ic]."""
    if isinstance(lin, (PackedLinear, PackedLinearV2)):
        from ..ops.binary_matmul import pb_matmul

        lead = x.shape[:-1]
        y = pb_matmul(x.reshape(-1, x.shape[-1]), lin)
        return y.reshape(*lead, -1).to(x.dtype)
    y = x @ lin["w"].to(x.dtype)
    if lin.get("b") is not None:
        y = y + lin["b"].to(x.dtype)
    return y
