"""Hybrid (exact) PBW-v2 prefill: the counterpart of `pb_llm_tpu/ops/
pallas_pb.py`'s `_dequant_v2_binary` + `_v2_dequant_kernel`,
`dequant_v2_binary_xla`, `dequant_v2_pallas` and `_v2_prefill_call`.

    y = x @ w_bin + xg @ (hs·(V − hz) − β) + bias

w_bin [ic, oc] is the binary part of the weight: salient rows carry β
(their sign bits are zero), so the correction matrix subtracts β once.  xg
gathers x at the salient columns; sentinel slots (local index == shard
width) read an appended zero column and vanish.  The two large products are
plain `torch.matmul`s (the JAX package leaves them to XLA): f32 under
`no_tf32`, or for "hybrid_bf16" bf16 with f32 output.  Row-grouped layers
(n_row_groups > 1) have no single correction product and take the exact
f32 matmul (`packed_matmul.pb_f32_matmul`), as in JAX.

`dequant_v2_binary` launches the CUDA kernel (`csrc/pb_dequant_v2.cu`) on a
CUDA layer and runs `dequant_v2_binary_plain` on a CPU layer.  The plain
version computes what `dequant_v2_binary_xla` computes, in its order:
(mean − scale) + 2·scale·bit for 1-bit lows and (code − zero)·scale for 2-
and 4-bit lows.  (The JAX Pallas kernel writes β + α·code2 instead, which
XLA on the CPU contracts into an FMA: the same bits at 1 bit, within one
ulp at 2 and 4 bits.)
"""

from __future__ import annotations

import ctypes

import torch

from .. import no_tf32
from ..core.pbw import PackedLinearV2, gather_x_v2, unpack_side_codes
from . import _build, packed_matmul

launches = 0  # kernel launches of dequant_v2_binary (plain-version calls not counted)

_DTYPES = (torch.float32, torch.bfloat16)


def _dequant_coef(p: PackedLinearV2) -> torch.Tensor:
    """[2, oc]: (2·scale, mean − scale) for 1-bit lows, (scale, zero) for
    2- and 4-bit lows (the zero point is stored as low_mean)."""
    scale = p.low_scale[0].float()
    mean = p.low_mean[0].float()
    if p.low_bits == 1:
        return torch.stack([2.0 * scale, mean - scale]).contiguous()
    return torch.stack([scale, mean]).contiguous()


def dequant_v2_binary_plain(p: PackedLinearV2, dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel: binary-part weight [ic, oc]."""
    a, b = _dequant_coef(p)
    code = packed_matmul.low_code(p)
    if p.low_bits == 1:
        return (b[None, :] + a[None, :] * code).to(dtype)
    return ((code - b[None, :]) * a[None, :]).to(dtype)


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def dequant_v2_binary(p: PackedLinearV2, dtype=torch.float32) -> torch.Tensor:
    """Binary-part weight [ic, oc] in f32 or bf16.  CPU layer: the plain
    version.  CUDA layer: the kernel."""
    dev = p.sign_packed.device
    if dev.type == "cpu":
        return dequant_v2_binary_plain(p, dtype)
    if dev.type != "cuda":
        raise ValueError(f"dequant_v2_binary: unsupported device {dev}")
    if dtype not in _DTYPES:
        raise ValueError(f"dequant_v2_binary: dtype {dtype} not in {_DTYPES}")
    if p.low_bits not in (1, 2, 4):
        raise ValueError(f"dequant_v2_binary: low_bits {p.low_bits} not in (1, 2, 4)")
    if p.sign_packed.dtype != torch.int32 or not p.sign_packed.is_contiguous():
        raise ValueError("dequant_v2_binary: sign_packed must be contiguous int32")
    return launch_dequant(p, _dequant_coef(p), dtype)


def launch_dequant(p: PackedLinearV2, coef: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Launch the dequant kernel on a checked CUDA layer and its [2, oc]
    coefficient rows, on the current stream; counts one launch."""
    dev = p.sign_packed.device
    out = torch.empty((p.ic_local, p.oc_local), dtype=dtype, device=dev)
    fn = _build.load("pb_dequant_v2").pb_dequant_v2
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(p.sign_packed.data_ptr(), coef.data_ptr(), out.data_ptr(), p.ic_local, p.oc_local,
             p.pack_block_local, p.low_bits, int(dtype == torch.bfloat16),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "pb_dequant_v2")
    global launches
    launches += 1
    return out


def salient_rows(p: PackedLinearV2) -> torch.Tensor:
    """Global input row of each sidecar slot [k_pad] (one row group);
    sentinel slots map to ic.  The one-hot gather and the export scatter
    index with it; the "take" gather is `core.pbw.gather_x_v2`."""
    kps, ic_s = p.k_pad_shard_local, p.ic_shard_local
    idx_l = p.side_idx[:, 0].long()
    shard_off = (torch.arange(idx_l.shape[0], device=idx_l.device) // kps) * ic_s
    return torch.where(idx_l == ic_s, p.ic_local, idx_l + shard_off)


def _dot(a: torch.Tensor, b: torch.Tensor, dot_dtype) -> torch.Tensor:
    """f32 product of a and b rounded to ``dot_dtype``, as the JAX package
    asks with preferred_element_type=f32.  bf16 on the card: one bf16 GEMM
    with f32 output; on the CPU, which has no such GEMM, the bf16-rounded
    operands multiply in f32 (as the JAX package does there)."""
    if dot_dtype == torch.float32:
        return a.float() @ b.float()
    a, b = a.to(dot_dtype), b.to(dot_dtype)
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def v2_prefill(x: torch.Tensor, p: PackedLinearV2, plain: bool = False,
               dot_dtype=torch.float32, gather: str = "take",
               extract: str = "pallas") -> torch.Tensor:
    """y = x @ dequant_v2(p) (+ bias) for large m; x [m, ic] → f32 [m, oc].

    ``gather``: "take" indexes x at the salient rows; "dot" selects them
    with a one-hot product (exact: one 1.0 per column).  ``extract``:
    "pallas" takes the dequant kernel (its plain version when ``plain``),
    "xla" the plain extraction on any device."""
    if gather not in ("take", "dot") or extract not in ("pallas", "xla"):
        raise ValueError(f"v2_prefill: gather={gather!r} extract={extract!r}")
    if p.n_row_groups != 1:
        fn = packed_matmul.pb_f32_matmul_plain if plain else packed_matmul.pb_f32_matmul
        return fn(x, p, dot_dtype=dot_dtype)
    ic = x.shape[1]
    if extract == "xla" or plain:
        w_bin = dequant_v2_binary_plain(p, dot_dtype)
    else:
        w_bin = dequant_v2_binary(p, dot_dtype)
    xf = x.float()
    with no_tf32():
        if gather == "dot":
            rows = salient_rows(p)
            sel = (rows[None, :] == torch.arange(ic, device=x.device)[:, None]).float()
            xg = xf @ sel
        else:
            xg = gather_x_v2(xf, p)[..., 0]
        codes = unpack_side_codes(p.side_val, p.side_bits, p.shards_local).float()
        beta = packed_matmul.coef_rows(p)[1]
        corr = (codes - p.high_zero[None, :]) * p.high_scale[None, :] - beta[None, :]
        y = _dot(xf, w_bin, dot_dtype) + _dot(xg, corr, dot_dtype)
    if p.bias is not None:
        y = y + p.bias
    return y


def dequant_v2_full(p: PackedLinearV2, dtype=torch.float32, plain: bool = False) -> torch.Tensor:
    """Whole dequantized weight [ic, oc] (for export): the binary part from
    the kernel, then one row scatter of the salient codes hs·(code − hz).
    Global selection only (n_row_groups == 1), as in JAX."""
    if p.n_row_groups != 1:
        raise ValueError("dequant_v2_full needs one row group (col_tile >= oc)")
    w = dequant_v2_binary_plain(p, dtype) if plain else dequant_v2_binary(p, dtype)
    rows = salient_rows(p)
    keep = rows < p.ic_local
    codes = unpack_side_codes(p.side_val, p.side_bits, p.shards_local).float()
    vals = (codes - p.high_zero[None, :]) * p.high_scale[None, :]
    w[rows[keep]] = vals[keep].to(dtype)
    return w
