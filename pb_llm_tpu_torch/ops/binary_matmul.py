"""Packed-matmul dispatch (port of `pb_llm_tpu/ops/binary_matmul.py`).

`pb_matmul` resolves `backend`, `decode_dot` and `prefill` from the active
`KernelConfig` exactly as the JAX package does, with "on the TPU" read as
"x lies on a CUDA device".
"""

from __future__ import annotations

import torch

from ..core.pbw import PackedLinearV2, matmul_reference_v2
from . import kernel_config as _kc
from . import packed_matmul


def _resolve_decode_dot(kcfg: _kc.KernelConfig) -> str:
    return "int8" if kcfg.decode_dot == "auto" else kcfg.decode_dot


def pb_matmul(x: torch.Tensor, p) -> torch.Tensor:
    """y = x @ dequant(p) (+ bias) with the configured backend/arms."""
    if not isinstance(p, PackedLinearV2):
        raise NotImplementedError("PBW v1 (PackedLinear) is not ported yet (ROADMAP: PBW v1)")
    kcfg = _kc.current()
    on_gpu = x.device.type == "cuda"
    supported = packed_matmul.kernel_supported_v2(p)
    mode = kcfg.backend
    if mode == "auto":
        mode = "pallas" if (on_gpu and supported) else "xla"
    if mode == "pallas" and not supported:
        mode = "xla"
    prefill = kcfg.prefill
    if prefill == "auto":
        prefill = "int8" if on_gpu else "hybrid"
    if mode in ("pallas", "pallas_interpret"):
        if prefill == "hybrid_bf16" and x.shape[0] >= packed_matmul.V2_PREFILL_M:
            raise NotImplementedError("prefill='hybrid_bf16' is not ported yet (ROADMAP Queue 2 item 4)")
        return packed_matmul.pb_matmul_v2(
            x, p, plain=mode == "pallas_interpret",
            decode_dot=_resolve_decode_dot(kcfg), prefill_int8=prefill == "int8")
    return matmul_reference_v2(x, p)
