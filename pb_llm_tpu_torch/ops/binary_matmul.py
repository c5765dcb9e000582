"""Packed-matmul dispatch (port of `pb_llm_tpu/ops/binary_matmul.py` and of
`pallas_pb.pb_matmul_pallas` / `pb_matmul_pallas_v2`).

`pb_matmul` resolves `backend`, `decode_dot` and `prefill` from the active
`KernelConfig` exactly as the JAX package does, with "on the TPU" read as
"x lies on a CUDA device".  For PBW v1, `pb_matmul_v1` takes the planar
kernel at m < 256 where `packed_matmul_v1.planar_ok` holds and the select
kernel otherwise; only prefill "hybrid_bf16" makes the select dot bf16, and
v1 reads neither decode_dot nor the int8 prefill, as in JAX.  For PBW v2,
`pb_matmul_v2` picks the arm by m:

  * m ≥ 256: prefill "int8" (1-bit lows) → the int8 kernel; "hybrid" /
    "hybrid_bf16" → `prefill.v2_prefill` (row-grouped layers fall through
    to the exact f32 kernel there, as in JAX);
  * m < 256: decode_dot "int8" (1-bit lows) → the int8 kernel; "dma"
    (1-bit lows, one row group) → the dma kernel; "pair" (1-bit lows) → the
    pair kernel; "f32" / "bf16", and "dma" / "pair" outside their gates, →
    the exact f32 kernel (bf16 dots for "bf16").  These are JAX's gates
    (`pallas_pb.py:1263-1275`).

`pb_matmul_stacked` takes a `models.stacking.StackedPackedLinearV2` marker
(layer li of stacked v2 planes, the scan_layers path), as JAX's does: on
the kernel arms, a layout `stacked_supported_v2` takes at m ≤ 256 runs the
stacked int8 kernel for decode_dot "int8" and the stacked f32 kernel for
any other arm (pair, dma and bf16 have no stacked variant); otherwise layer
li's views take `pb_matmul`.
"""

from __future__ import annotations

import torch

from ..core.pbw import PackedLinear, PackedLinearV2, matmul_reference, matmul_reference_v2
from . import kernel_config as _kc
from . import decode_arms, packed_matmul, packed_matmul_v1, prefill


def _resolve_decode_dot(kcfg: _kc.KernelConfig) -> str:
    return "int8" if kcfg.decode_dot == "auto" else kcfg.decode_dot


def pb_matmul_v2(x: torch.Tensor, p: PackedLinearV2, plain: bool = False,
                 prefill_bf16: bool = False, prefill_gather: str = "take",
                 prefill_extract: str = "pallas", decode_dot: str = "f32",
                 prefill_int8: bool = False) -> torch.Tensor:
    """y = x @ dequant_v2(p) (+ bias); x [m, ic] → f32 [m, oc].  ``plain``
    runs each kernel's plain version ("pallas_interpret")."""
    m = x.shape[0]
    if x.shape[1] != p.ic_local:
        raise ValueError(f"x ic {x.shape[1]} != packed ic {p.ic_local}")
    int8 = packed_matmul.pb_int8_matmul_plain if plain else packed_matmul.pb_int8_matmul
    if m >= packed_matmul.V2_PREFILL_M:
        if prefill_int8 and p.low_bits == 1:
            return int8(x, p)
        return prefill.v2_prefill(x, p, plain=plain,
                                  dot_dtype=torch.bfloat16 if prefill_bf16 else torch.float32,
                                  gather=prefill_gather, extract=prefill_extract)
    if decode_dot == "int8" and p.low_bits == 1:
        return int8(x, p)
    if decode_dot == "dma" and p.n_row_groups == 1 and p.low_bits == 1:
        return (decode_arms.pb_dma_v2_plain if plain else decode_arms.pb_dma_v2)(x, p)
    if decode_dot == "pair" and p.low_bits == 1:
        return (decode_arms.pb_pair_v2_plain if plain else decode_arms.pb_pair_v2)(x, p)
    f32 = packed_matmul.pb_f32_matmul_plain if plain else packed_matmul.pb_f32_matmul
    return f32(x, p, dot_dtype=torch.bfloat16 if decode_dot == "bf16" else torch.float32)


def pb_matmul_v1(x: torch.Tensor, p: PackedLinear, plain: bool = False,
                 prefill_bf16: bool = False) -> torch.Tensor:
    """y = x @ dequantize(p) (+ bias); x [m, ic] → f32 [m, oc].  ``plain``
    runs each kernel's plain version ("pallas_interpret")."""
    if x.shape[1] != p.ic_local:
        raise ValueError(f"x ic {x.shape[1]} != packed ic {p.ic_local}")
    v1 = packed_matmul_v1
    if v1.use_planar(x.shape[0], p):
        return (v1.pb_planar_v1_plain if plain else v1.pb_planar_v1)(x, p)
    fn = v1.pb_select_v1_plain if plain else v1.pb_select_v1
    return fn(x, p, dot_dtype=torch.bfloat16 if prefill_bf16 else torch.float32)


def pb_matmul(x: torch.Tensor, p) -> torch.Tensor:
    """y = x @ dequant(p) (+ bias) with the configured backend/arms."""
    kcfg = _kc.current()
    on_gpu = x.device.type == "cuda"
    v2 = isinstance(p, PackedLinearV2)
    supported = (packed_matmul.kernel_supported_v2 if v2 else packed_matmul_v1.kernel_supported_v1)(p)
    mode = kcfg.backend
    if mode == "auto":
        mode = "pallas" if (on_gpu and supported) else "xla"
    if mode == "pallas" and not supported:
        mode = "xla"
    prefill_arm = kcfg.prefill
    if prefill_arm == "auto":
        prefill_arm = "int8" if on_gpu else "hybrid"
    if mode in ("pallas", "pallas_interpret") and not v2:
        return pb_matmul_v1(x, p, plain=mode == "pallas_interpret",
                            prefill_bf16=prefill_arm == "hybrid_bf16")
    if not v2:
        return matmul_reference(x, p)
    if mode in ("pallas", "pallas_interpret"):
        return pb_matmul_v2(
            x, p, plain=mode == "pallas_interpret", prefill_bf16=prefill_arm == "hybrid_bf16",
            prefill_gather=kcfg.prefill_gather, prefill_extract=kcfg.prefill_extract,
            decode_dot=_resolve_decode_dot(kcfg), prefill_int8=prefill_arm == "int8")
    return matmul_reference_v2(x, p)


def pb_matmul_stacked(x: torch.Tensor, marker) -> torch.Tensor:
    """y = x @ dequant_v2(layer marker.idx of marker.stacked) (+ bias): the
    scan_layers path (JAX's `pb_matmul_stacked`)."""
    kcfg = _kc.current()
    pm = packed_matmul
    supported = pm.stacked_supported_v2(marker.stacked) and x.shape[0] <= pm.STACKED_MAX_M
    mode = kcfg.backend
    if mode == "auto":
        mode = "pallas" if (x.device.type == "cuda" and supported) else "xla"
    if mode in ("pallas", "pallas_interpret") and supported:
        plain = mode == "pallas_interpret"
        if _resolve_decode_dot(kcfg) == "int8":
            fn = pm.pb_int8_matmul_stacked_plain if plain else pm.pb_int8_matmul_stacked
        else:
            fn = pm.pb_f32_matmul_stacked_plain if plain else pm.pb_f32_matmul_stacked
        return fn(x, marker)
    return pb_matmul(x, pm.stacked_layer(marker))
