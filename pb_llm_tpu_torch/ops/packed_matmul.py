"""PBW-v2 packed matmuls: the counterparts of `pb_llm_tpu/ops/pallas_pb.py`'s
int8 path (`_planar_v2_int8_call` + `_planar_v2_int8_kernel`) and exact f32
path (`_planar_v2_call` + `_planar_v2_kernel`).

int8 (`pb_int8_matmul`, `csrc/pb_int8_matmul.cu`):

    y = rs·β + (x8·B′)·sx·2scale + (sx·(xg8·V″) [+ 128·rsg])·hs + rsg·γ + bias

x is quantized per row (absmax/127, round half to even, clip ±127); the
bit-plane and sidecar products accumulate exactly in int32.  8-bit codes
enter the sidecar dot offset-binary (V″ = code − 128) and the +128·rsg
correction sits in the sidecar term itself (the code at pallas_pb.py:441,
not the γ′ fold its docstring mentions).  4-bit codes enter as they are.

f32 (`pb_f32_matmul`, `csrc/pb_f32_matmul.cu`):

    y = rowsum(x)·β + (x·C)·2α + (xg·V)·hs + rowsum(xg)·γ + bias

C = Σ_j 2^j·B_j is the low code from {0,1} bit planes (the JAX kernel's
{0,2} planes with the 2 folded into α, which is exact), α = scale for
1-bit lows and scale/2 for 2- and 4-bit lows; xg is x gathered at each row
group's salient columns.  ``dot_dtype`` bf16 rounds x and xg to bf16 in the
two products (decode_dot "bf16"); the row sums stay f32.

stacked (`pb_int8_matmul_stacked`, `pb_f32_matmul_stacked`): the int8 and
f32 functions on layer li of a stacked layer (`models.stacking`, the
scan_layers path; `pallas_pb.pb_matmul_pallas_v2_stacked`).  The kernels
take the whole [L] planes, an [L, 5, oc] coefficient array made once, and a
device pointer to li; the x preparation uses layer li's `side_idx` view.

x preparation (`prepare_int8`, `csrc/pb_prep_int8.cu`): the int8 path's
per-row absmax scale, int8 codes, row sums and gathered salient codes in
one launch per linear, the operands both int8 kernels take.

int8 arms (`int8_arm`): the int8 kernel, flat and stacked, runs on the
CUDA cores (`__dp4a`, x8 in natural column order) or on the int8 tensor
cores (`wgmma`, x8 in `byte_permute_x`'s padded order grouped by word
group, `tc_x_columns`; xg8 padded to 32 slots).  The operands carry their
layout (`Int8Operands.layout`, named by its arm), the x preparation writes
it, and the launch takes that arm.  Both arms and the plain version give
the same bits on the same operands.

f32 arms (`f32_arm`): the exact f32 kernel, flat and stacked, runs on the
f32 CUDA cores (select-and-add) below F32_TC rows, and from there, for
1-bit lows where the layout allows, on the bf16 tensor cores
(`csrc/pb_bf16_tc.cuh`, shared with the pair arm): x and xg in three bf16
terms that carry them exactly (`split_terms`; one term, bf16(x), for dot
bf16), x in the TPU pair kernel's order padded and grouped by word group
(`tc_pair_columns`), operands in `TcOperands` (`prepare_tc`), their plain
version `tc_matmul_plain`.

Each wrapper launches its CUDA kernel on a CUDA tensor and runs its plain
PyTorch version on a CPU tensor.  The dispatch of `pb_matmul_pallas_v2`
lives in `ops.binary_matmul`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from .. import no_tf32
from ..core import packing
from ..core.pbw import PackedLinearV2, gather_x_v2, unpack_side_codes
from ..core.pbw import low_code as pbw_low_code
from . import _build

V2_PREFILL_M = 256  # pallas_pb._V2_PREFILL_M: decode below, prefill at or above

launches = 0  # kernel launches of pb_int8_matmul (plain-version calls not counted)
f32_launches = 0  # kernel launches of pb_f32_matmul (plain-version calls not counted)
stacked_launches = 0  # kernel launches of pb_int8_matmul_stacked
stacked_f32_launches = 0  # kernel launches of pb_f32_matmul_stacked
prep_launches = 0  # kernel launches of prepare_int8 (csrc/pb_prep_int8.cu)
tc_launches = 0  # kernel launches of pb_int8_matmul's tensor-core arm
stacked_tc_launches = 0  # kernel launches of pb_int8_matmul_stacked's tensor-core arm
f32_tc_launches = 0  # kernel launches of pb_f32_matmul's tensor-core arm
stacked_f32_tc_launches = 0  # kernel launches of pb_f32_matmul_stacked's tensor-core arm

# The int8 kernel's arms: "dp4a" (CUDA cores) below M_TC rows, "tc" (int8
# tensor cores) from M_TC rows on, where the layout allows (`int8_arm`).
# On an H100 (700 W) the tensor cores win alone from 8 rows on llama-7b's
# three shapes (chip_smoke.py phase 2), but in the graphed decode step of 8
# slots, kernel after kernel, they lose a quarter of a millisecond a step
# (scripts/torch_int8_arm_ab.py): decode stays on the dp4a arm (PERF.md).
M_TC = 16
TC_OC = 128  # the tensor-core arm's output columns a block: one row group each
ARMS = ("dp4a", "tc")  # also the names of their operand layouts


class Int8Operands(NamedTuple):
    x8: torch.Tensor   # int8 [m, ic] in natural column order; "tc": [m, icp], `tc_x_columns`
    sx: torch.Tensor   # f32 [m]   per-row scale absmax/127
    rs: torch.Tensor   # f32 [m]   exact f32 rowsum of x
    xg8: torch.Tensor  # int8 [n_rg, m, k_pad] gathered salient x, same scale; "tc": k padded
    rsg: torch.Tensor  # f32 [n_rg, m] exact f32 rowsum of the gathered x
    coef: torch.Tensor  # f32 [5, oc]: 2·scale, β, γ, hs, bias
    layout: str = "dp4a"  # the arm these operands are laid out for: "dp4a" or "tc"


def tc_layout_ok(p: PackedLinearV2) -> bool:
    """The layouts the tensor-core arm takes: oc a multiple of 16 (16-byte
    code rows), each 128-column tile inside one row group, and nibble
    sidecars in shard segments of a multiple of 16 slots (8 packed rows a
    copy)."""
    return (p.oc_local % 16 == 0 and (p.n_row_groups == 1 or p.col_tile % TC_OC == 0)
            and (p.side_bits == 8 or p.k_pad_shard_local % 16 == 0))


def int8_arm(m: int, p: PackedLinearV2) -> str:
    """The int8 kernel's arm for ``m`` rows of x on layout ``p``: "tc" at
    m >= M_TC where `tc_layout_ok`, else "dp4a".  The one place the arm is
    chosen, for the flat and the stacked entry."""
    return "tc" if m >= M_TC and tc_layout_ok(p) else "dp4a"


@functools.lru_cache(maxsize=64)
def padded_columns(ic: int, pack_block: int) -> torch.Tensor:
    """For each byte of `byte_permute_x`'s padded row, the natural column it
    holds, or ``ic`` for a padding zero (int64, CPU)."""
    cols, off = [], 0
    for rows in packing.block_sizes(ic, pack_block):
        g = rows // packing.WORD_BITS
        g8 = -(-g // 8) * 8
        b = torch.arange(8).view(8, 1, 1)
        i = torch.arange(g8).view(1, g8, 1)
        j = torch.arange(4).view(1, 1, 4)
        c = torch.where(i < g, off + (8 * j + b) * g + i, torch.tensor(ic))
        cols.append(c.reshape(-1))
        off += rows
    return torch.cat(cols)


@functools.lru_cache(maxsize=64)
def _group_order(ic: int, pack_block: int) -> torch.Tensor:
    """For each byte of the tensor-core arm's row, its place in
    `byte_permute_x`'s padded row: each bit run of a pack block cut into
    32-byte pieces (8 words), the 8 runs' pieces of one word group side by
    side (256 bytes a group)."""
    order, off = [], 0
    for rows in packing.block_sizes(ic, pack_block):
        g8 = -(-(rows // packing.WORD_BITS) // 8) * 8
        s = torch.arange(g8 // 8).view(-1, 1, 1)
        b = torch.arange(8).view(1, 8, 1)
        k = torch.arange(32).view(1, 1, 32)
        order.append((off + b * 4 * g8 + 32 * s + k).reshape(-1))
        off += 32 * g8
    return torch.cat(order)


@functools.lru_cache(maxsize=64)
def tc_x_columns(ic: int, pack_block: int) -> torch.Tensor:
    """For each byte of a row of x8 in the tensor-core arm's layout, the
    natural column it holds, or ``ic`` for a padding zero (int64, CPU):
    `pallas_pb.byte_permute_x`'s order (within a pack block of g words,
    column (8j + b)·g + i at b·4g + 4i + j), each bit run of 4g bytes padded
    to 4·round_up(g, 8), then grouped by word group (`_group_order`), so a
    group's 8 runs are 256 contiguous bytes: two 128-byte TMA boxes."""
    return padded_columns(ic, pack_block)[_group_order(ic, pack_block)]


def byte_permute_x(x8: torch.Tensor, ic: int, pack_block: int) -> torch.Tensor:
    """x8 [m, ic] → [m, icp] in `pallas_pb.byte_permute_x`'s order, each bit
    run padded with zeros to a multiple of 8 words."""
    cols = padded_columns(ic, pack_block).to(x8.device)
    return torch.cat([x8, x8.new_zeros((x8.shape[0], 1))], dim=1)[:, cols].contiguous()


def group_runs(xp: torch.Tensor, ic: int, pack_block: int) -> torch.Tensor:
    """`byte_permute_x`'s padded rows → the tensor-core arm's (`_group_order`)."""
    return xp[:, _group_order(ic, pack_block).to(xp.device)].contiguous()


def _from_tc_x(xp: torch.Tensor, ic: int, pack_block: int) -> torch.Tensor:
    """The inverse of `group_runs` ∘ `byte_permute_x` (padding dropped)."""
    cols = tc_x_columns(ic, pack_block).to(xp.device)
    keep = cols < ic
    out = xp.new_empty((xp.shape[0], ic))
    out[:, cols[keep]] = xp[:, keep]
    return out


def _tc_slots(k: int) -> int:
    """xg8's row width in the "tc" layout: k slots padded to a multiple of 32."""
    return -(-k // 32) * 32


def to_layout(ops: Int8Operands, p: PackedLinearV2, layout: str) -> Int8Operands:
    """The same operands in the other arm's layout: "dp4a" (x8 [m, ic],
    xg8 [n_rg, m, k_pad]) or "tc" (x8 [m, icp] in `tc_x_columns`' order,
    xg8 [n_rg, m, round_up(k_pad, 32)] padded with zeros)."""
    if layout == ops.layout:
        return ops
    pb = p.pack_block_local
    if layout == "tc":
        k = ops.xg8.shape[2]
        xg8 = torch.nn.functional.pad(ops.xg8, (0, _tc_slots(k) - k)).contiguous()
        x8 = group_runs(byte_permute_x(ops.x8, p.ic_local, pb), p.ic_local, pb)
    elif layout == "dp4a":
        xg8 = ops.xg8[..., :p.k_pad].contiguous()
        x8 = _from_tc_x(ops.x8, p.ic_local, pb)
    else:
        raise ValueError(f"unknown int8 operand layout {layout!r}")
    return ops._replace(x8=x8, xg8=xg8, layout=layout)


def prepare_int8_plain(x: torch.Tensor, p: PackedLinearV2,
                       layout: str = "dp4a") -> Int8Operands:
    """x preparation of `_planar_v2_int8_call` (pallas_pb.py:471-495):
    plain PyTorch, in natural column order (layout "dp4a") or in the
    tensor-core arm's (layout "tc": the TPU byte permutation, padded and
    grouped).  The scale is a true division on every device (on a CUDA
    tensor, ``t / 127.0`` multiplies by a rounded reciprocal).  The row sums
    are f32 sums in torch.sum's order; the kernel's differ from them by at
    most `sum_bound`."""
    xf = x.float()
    absmax = torch.amax(xf.abs(), dim=1, keepdim=True)
    sx = torch.clamp(absmax, min=1e-30) / absmax.new_tensor(127.0)
    x8 = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)  # half to even
    rs = torch.sum(xf, dim=1)
    xg = gather_x_v2(xf, p).permute(2, 0, 1)                 # [n_rg, m, k_pad]
    rsg = torch.sum(xg, dim=2)
    xg8 = torch.clamp(torch.round(xg / sx[None]), -127, 127).to(torch.int8).contiguous()
    ops = Int8Operands(x8.contiguous(), sx[:, 0].contiguous(), rs.contiguous(),
                       xg8, rsg.contiguous(), coef_rows(p))
    return to_layout(ops, p, layout)


def sum_bound(x: torch.Tensor, dim: int) -> torch.Tensor:
    """How far the kernel's row sums may lie from the plain version's along
    ``dim`` (n terms, u = 2^-24): an f32 sum in any order lies within
    (n - 1)·u/(1 - (n - 1)·u)·Σ|x| ≤ 1.5·(n - 1)·u·Σ|x| of the exact sum for
    n·u ≤ 1/4, an f64 sum rounded once to f32 within (u + n·2^-53)·Σ|x|, so
    the two lie within 2·n·u·Σ|x|."""
    n = x.shape[dim]
    return 2 * n * 2.0 ** -24 * x.abs().sum(dim=dim, dtype=torch.float64)


def prepare_int8(x: torch.Tensor, p: PackedLinearV2, layout: str = "dp4a") -> Int8Operands:
    """The int8 path's x preparation in ``layout`` ("dp4a" or "tc"): on
    a CPU tensor the plain version, on a CUDA tensor one launch of
    `csrc/pb_prep_int8.cu` (the plain version's codes and scales bit for
    bit, its sums within `sum_bound`)."""
    if layout not in ARMS:
        raise ValueError(f"prepare_int8: unknown layout {layout!r}")
    if x.device.type == "cpu":
        return prepare_int8_plain(x, p, layout)
    if x.device.type != "cuda":
        raise ValueError(f"prepare_int8: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[1] != p.ic_local:
        raise ValueError(f"prepare_int8: x {tuple(x.shape)} does not match ic {p.ic_local}")
    idx = p.side_idx
    if idx.device != x.device or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("prepare_int8: side_idx must be a contiguous int32 tensor on x's device")
    return launch_prep_int8(x.float().contiguous(), p, layout)


_PREP_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def launch_prep_int8(xf: torch.Tensor, p: PackedLinearV2, layout: str = "dp4a") -> Int8Operands:
    """Launch the x-preparation kernel on a contiguous f32 x (on the card)
    on the current stream, writing ``layout``; counts one launch."""
    m, ic = xf.shape
    n_rg, k_pad = p.n_row_groups, p.k_pad
    dev = xf.device
    tc = layout == "tc"
    if tc:
        icp = _group_order(ic, p.pack_block_local).numel()
        x8 = torch.empty((m, icp), dtype=torch.int8, device=dev)
        xg8 = torch.empty((n_rg, m, _tc_slots(k_pad)), dtype=torch.int8, device=dev)
    else:
        x8 = torch.empty((m, ic), dtype=torch.int8, device=dev)
        xg8 = torch.empty((n_rg, m, k_pad), dtype=torch.int8, device=dev)
    sx = torch.empty(m, dtype=torch.float32, device=dev)
    rs = torch.empty(m, dtype=torch.float32, device=dev)
    rsg = torch.empty((n_rg, m), dtype=torch.float32, device=dev)
    fn = _build.load("pb_prep_int8").pb_prep_int8
    fn.argtypes = _PREP_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(xf.data_ptr(), p.side_idx.data_ptr(), x8.data_ptr(), sx.data_ptr(), rs.data_ptr(),
             xg8.data_ptr(), rsg.data_ptr(), m, ic, p.shards_local, p.k_pad_shard_local, n_rg,
             p.pack_block_local, int(tc), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "pb_prep_int8")
    global prep_launches
    prep_launches += 1
    return Int8Operands(x8, sx, rs, xg8, rsg, coef_rows(p), layout)


def coef_rows(p: PackedLinearV2) -> torch.Tensor:
    """The [5, oc] rows 2α, β, γ, hs, bias (2α = 2·scale for 1-bit lows,
    scale for 2- and 4-bit lows); made once per layer.  For a stacked layer
    (tensors with a leading [L] axis) the [L, 5, oc] rows of every layer."""
    if p.coef_cache is None:
        scale = p.low_scale[..., 0, :].float()
        mean = p.low_mean[..., 0, :].float()
        if p.low_bits == 1:
            alpha2, beta = 2.0 * scale, mean - scale
        else:
            alpha2, beta = scale, -scale * mean
        gamma = -p.high_scale * p.high_zero - beta
        bias = p.bias if p.bias is not None else torch.zeros_like(scale)
        p.coef_cache = torch.stack([alpha2, beta, gamma, p.high_scale, bias], dim=-2).contiguous()
    return p.coef_cache


def _epilogue(acc_b, acc_v, ops: Int8Operands, p: PackedLinearV2) -> torch.Tensor:
    """f32 combination, one rounding per operation in the kernel's order."""
    sx = ops.sx[:, None]
    oc = p.oc_local
    group = torch.arange(oc, device=acc_b.device) // p.col_tile
    rsg = ops.rsg.t()[:, group]                              # [m, oc]
    side_f = acc_v * sx
    if p.side_bits == 8:
        side_f = side_f + 128.0 * rsg
    alpha2, beta, gamma, hs, bias = ops.coef
    y_bin = (acc_b * sx) * alpha2
    y = ops.rs[:, None] * beta + y_bin
    y = y + side_f * hs
    y = y + rsg * gamma
    return y + bias


def pb_int8_matmul_plain(x: torch.Tensor, p: PackedLinearV2) -> torch.Tensor:
    """Plain PyTorch version of x preparation and kernel."""
    return int8_matmul_plain(prepare_int8_plain(x, p), p)


def int8_matmul_plain(ops: Int8Operands, p: PackedLinearV2) -> torch.Tensor:
    """Plain PyTorch version of the kernel on its operands, in either
    layout: integer dots exact in float64 (|Σ| ≤ ic·127·255 < 2^53), the
    same f32 epilogue."""
    ops = to_layout(ops, p, "dp4a")
    ic = p.ic_local
    bits = packing.unpack_bits(p.sign_packed, ic, p.pack_block_local).to(torch.float64)
    acc_b = (ops.x8.to(torch.float64) @ bits).float()
    codes = unpack_side_codes(p.side_val, p.side_bits, p.shards_local).to(torch.float64)
    if p.side_bits == 8:
        codes = codes - 128.0
    dev = ops.x8.device
    group = torch.arange(p.oc_local, device=dev) // p.col_tile
    acc_v = torch.empty((ops.x8.shape[0], p.oc_local), dtype=torch.float64, device=dev)
    for t in range(p.n_row_groups):
        cols = group == t
        acc_v[:, cols] = ops.xg8[t].to(torch.float64) @ codes[:, cols]
    return _epilogue(acc_b, acc_v.float(), ops, p)


_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def pb_int8_matmul(x: torch.Tensor, p: PackedLinearV2) -> torch.Tensor:
    """y = x @ dequant_v2(p) (+ bias) through the int8 path; x [m, ic] → f32
    [m, oc].  CPU tensor: the plain version.  CUDA tensor: the kernel."""
    if x.device.type == "cpu":
        return pb_int8_matmul_plain(x, p)
    check_operands(x, p, "pb_int8_matmul")
    if p.low_bits != 1:
        raise ValueError("pb_int8_matmul needs low_bits == 1")
    if p.k_pad % 4:
        raise ValueError(f"pb_int8_matmul: k_pad {p.k_pad} must be a multiple of 4")
    return launch_int8(prepare_int8(x, p, int8_arm(x.shape[0], p)), p)


def check_operands(x: torch.Tensor, p: PackedLinearV2, what: str) -> None:
    """What every PBW-v2 kernel takes: x [m, ic] on a CUDA device, the
    planes on x's device, int32 sign words and uint8 codes, contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[1] != p.ic_local:
        raise ValueError(f"{what}: x {tuple(x.shape)} does not match ic {p.ic_local}")
    for name in ("sign_packed", "side_val", "side_idx"):
        t = getattr(p, name)
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
    if p.sign_packed.dtype != torch.int32 or p.side_val.dtype != torch.uint8:
        raise ValueError(f"{what}: sign_packed must be int32 and side_val uint8")
    if not (p.sign_packed.is_contiguous() and p.side_val.is_contiguous()):
        raise ValueError(f"{what}: planes must be contiguous")


def _arm_of(ops: Int8Operands, p: PackedLinearV2, what: str) -> int:
    """The C arm code the operands' layout names (0 dp4a, 1 tensor cores)."""
    if ops.layout == "dp4a":
        return 0
    if ops.layout != "tc":
        raise ValueError(f"{what}: unknown operand layout {ops.layout!r}")
    if not tc_layout_ok(p):
        raise ValueError(f"{what}: the tensor-core arm does not take this layout "
                         f"(oc {p.oc_local}, col_tile {p.col_tile})")
    return 1


def launch_int8(ops: Int8Operands, p: PackedLinearV2) -> torch.Tensor:
    """Launch the CUDA kernel on prepared operands (all on one CUDA device)
    on the current stream, in the arm their layout names; counts one launch
    of that arm."""
    arm = _arm_of(ops, p, "pb_int8_matmul")
    m, ic = ops.sx.shape[0], p.ic_local
    oc = p.oc_local
    out = torch.empty((m, oc), dtype=torch.float32, device=ops.x8.device)
    lib = _build.load("pb_int8_matmul")
    fn = lib.pb_int8_matmul
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(ops.x8.data_ptr(), ops.sx.data_ptr(), ops.rs.data_ptr(), ops.xg8.data_ptr(),
             ops.rsg.data_ptr(), p.sign_packed.data_ptr(), p.side_val.data_ptr(),
             ops.coef.data_ptr(), out.data_ptr(),
             m, ic, oc, p.pack_block_local, p.side_bits, p.k_pad, p.k_pad_shard_local,
             p.col_tile, p.n_row_groups, arm, torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "pb_int8_matmul")
    global launches, tc_launches
    if arm:
        tc_launches += 1
    else:
        launches += 1
    return out


def kernel_supported_v2(p: PackedLinearV2) -> bool:
    """`pallas_pb.pallas_supported_v2`: the layouts the kernel arms take
    (others run `matmul_reference_v2`, as in JAX)."""
    ic, oc = p.ic_local, p.oc_local
    if oc % 128 != 0 or ic % 32 != 0:
        return False
    if ic > p.pack_block_local and ic % p.pack_block_local != 0:
        return False
    return p.col_tile >= oc or oc % p.col_tile == 0


# ---------------------------------------------------------------------------
# exact f32 matmul
# ---------------------------------------------------------------------------

_DOT_DTYPES = (torch.float32, torch.bfloat16)


class F32Operands(NamedTuple):
    x: torch.Tensor     # f32 [m, ic]
    xg: torch.Tensor    # f32 [n_rg, m, k_pad] gathered salient x
    rs: torch.Tensor    # f32 [m] rowsum of x
    rsg: torch.Tensor   # f32 [n_rg, m] rowsum of xg
    coef: torch.Tensor  # f32 [5, oc]: 2α, β, γ, hs, bias


def prepare_f32(x: torch.Tensor, p: PackedLinearV2) -> F32Operands:
    xf = x.float().contiguous()
    xg = gather_x_v2(xf, p).permute(2, 0, 1).contiguous()
    return F32Operands(xf, xg, torch.sum(xf, dim=1), torch.sum(xg, dim=2).contiguous(), coef_rows(p))


def low_code(p: PackedLinearV2) -> torch.Tensor:
    """C = Σ_j 2^j·B_j as f32 [ic, oc] (exact small integers)."""
    return pbw_low_code(p.sign_packed, p.low_bits, p.ic_local, p.pack_block_local)


def pb_f32_matmul_plain(x: torch.Tensor, p: PackedLinearV2, dot_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same operands, the two
    products as f32 `torch.matmul`s of (bf16-rounded, for ``dot_dtype``
    bf16) x against the exact codes, the kernel's f32 epilogue order."""
    ops = prepare_f32(x, p)
    return plain_given_x(ops.x.to(dot_dtype).float(), ops.xg.to(dot_dtype).float(), ops, p)


def plain_given_x(xd: torch.Tensor, xgd: torch.Tensor, ops: F32Operands,
                  p: PackedLinearV2) -> torch.Tensor:
    """The plain products of x and xg as the kernel takes them (``xd`` [m,
    ic], ``xgd`` [n_rg, m, k_pad], f32) and the f32 epilogue on ``ops``."""
    codes = unpack_side_codes(p.side_val, p.side_bits, p.shards_local).float()
    group = torch.arange(p.oc_local, device=xd.device) // p.col_tile
    acc_v = torch.empty((xd.shape[0], p.oc_local), dtype=torch.float32, device=xd.device)
    with no_tf32():
        acc_b = xd @ low_code(p)
        for t in range(p.n_row_groups):
            cols = group == t
            acc_v[:, cols] = xgd[t] @ codes[:, cols]
    alpha2, beta, gamma, hs, bias = ops.coef
    rsg = ops.rsg.t()[:, group]
    y = ops.rs[:, None] * beta + acc_b * alpha2
    y = y + acc_v * hs
    y = y + rsg * gamma
    return y + bias


_F32_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def pb_f32_matmul(x: torch.Tensor, p: PackedLinearV2, dot_dtype=torch.float32) -> torch.Tensor:
    """y = x @ dequant_v2(p) (+ bias) through the exact f32 path; x [m, ic]
    → f32 [m, oc].  CPU tensor: the plain version.  CUDA tensor: the kernel."""
    if x.device.type == "cpu":
        return pb_f32_matmul_plain(x, p, dot_dtype)
    check_operands(x, p, "pb_f32_matmul")
    if dot_dtype not in _DOT_DTYPES:
        raise ValueError(f"pb_f32_matmul: dot_dtype {dot_dtype} not in {_DOT_DTYPES}")
    if p.low_bits not in (1, 2, 4):
        raise ValueError(f"pb_f32_matmul: low_bits {p.low_bits} not in (1, 2, 4)")
    if f32_arm(x.shape[0], p) == "tc":
        return launch_f32_tc(prepare_tc(x, p, terms_of(dot_dtype)), p)
    return launch_f32(prepare_f32(x, p), p, dot_dtype)


def launch_f32(ops: F32Operands, p: PackedLinearV2, dot_dtype=torch.float32) -> torch.Tensor:
    """Launch the f32 kernel on prepared operands (all on one CUDA device)
    on the current stream; counts one launch."""
    m, ic = ops.x.shape
    oc = p.oc_local
    out = torch.empty((m, oc), dtype=torch.float32, device=ops.x.device)
    fn = _build.load("pb_f32_matmul").pb_f32_matmul
    fn.argtypes = _F32_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(ops.x.data_ptr(), ops.xg.data_ptr(), ops.rs.data_ptr(), ops.rsg.data_ptr(),
             p.sign_packed.data_ptr(), p.side_val.data_ptr(), ops.coef.data_ptr(), out.data_ptr(),
             m, ic, oc, p.pack_block_local, p.low_bits, p.side_bits, p.k_pad,
             p.k_pad_shard_local, p.col_tile, int(dot_dtype == torch.bfloat16),
             torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "pb_f32_matmul")
    global f32_launches
    f32_launches += 1
    return out


# ---------------------------------------------------------------------------
# the bf16 tensor-core arm (pair and exact f32; csrc/pb_bf16_tc.cuh)
# ---------------------------------------------------------------------------

# The exact f32 kernel's arms: "cores" (select-and-add on the f32 CUDA
# cores) below F32_TC rows, "tc" (wgmma bf16, x in three bf16 terms) from
# F32_TC rows on, for 1-bit lows where the layout allows (`f32_arm`).  On an
# H100 (700 W) the tensor cores take less time from 32 rows on all three of
# llama-7b's shapes, the CUDA cores at 16 on two of them (chip_smoke.py
# phase 2; PERF.md).
F32_TC = 32
F32_ARMS = ("cores", "tc")
TC_GROUP = 256  # bf16 values of a word group (8 sign words) in a row of the arm's x
TC_SLOTS = 64   # the arm's sidecar chunk: xg rows padded to a multiple of it


def f32_arm(m: int, p: PackedLinearV2) -> str:
    """The exact f32 kernel's arm for ``m`` rows of x on layout ``p``: "tc"
    at m >= F32_TC for 1-bit lows where `tc_layout_ok`, else "cores" (the
    reference's 2- and 4-bit ablations stay there).  The one place the arm
    is chosen, for the flat and the stacked entry."""
    return "tc" if m >= F32_TC and p.low_bits == 1 and tc_layout_ok(p) else "cores"


def terms_of(dot_dtype) -> int:
    """bf16 terms of x for the tensor-core arm: 3 carry an f32 x exactly, 1
    is x rounded to bf16 (decode_dot "bf16", the pair arm)."""
    return 1 if dot_dtype == torch.bfloat16 else 3


def split_terms(x: torch.Tensor, terms: int) -> torch.Tensor:
    """f32 x → [terms, *x.shape] bf16.  One term: bf16(x), nearest even.
    Three: hi, mid, lo with x == hi + mid·2^-8 + lo·2^-16 exactly for every
    finite f32 (subnormal and huge included): hi is x with its low 16 bits
    cleared (truncation never rounds up past the largest f32), mid the same
    on (x - hi)·2^8, lo = ((x - hi)·2^8 - mid)·2^8, each exact in bf16."""
    if terms == 1:
        return x.to(torch.bfloat16)[None]
    if terms != 3:
        raise ValueError(f"split_terms: terms {terms} not in (1, 3)")

    def trunc(v):
        return (v.contiguous().view(torch.int32) & -65536).view(torch.float32)

    xf = x.float()
    hi = trunc(xf)
    r = (xf - hi) * 256.0
    mid = trunc(r)
    lo = (r - mid) * 256.0
    return torch.stack([hi, mid, lo]).to(torch.bfloat16)


def join_terms(planes: torch.Tensor) -> torch.Tensor:
    """The f32 value of `split_terms`' planes (exact)."""
    scale = (1.0, 2.0 ** -8, 2.0 ** -16)
    out = planes[0].double()
    for k in range(1, planes.shape[0]):
        out = out + planes[k].double() * scale[k]
    return out.float()


@functools.lru_cache(maxsize=64)
def pair_padded_columns(ic: int, pack_block: int) -> torch.Tensor:
    """For each value of `pallas_pb.pair_permute_x`'s row with each bit
    pair's run of 2g values padded to 2·round_up(g, 8), the natural column
    it holds, or ``ic`` for a padding zero (int64, CPU): within a pack block
    of g words, column p·2g8 + 2i + h holds weight row (p + 16h)·g + i."""
    cols, off = [], 0
    for rows in packing.block_sizes(ic, pack_block):
        g = rows // packing.WORD_BITS
        g8 = -(-g // 8) * 8
        p = torch.arange(16).view(16, 1, 1)
        i = torch.arange(g8).view(1, g8, 1)
        h = torch.arange(2).view(1, 1, 2)
        c = torch.where(i < g, off + (p + 16 * h) * g + i, torch.tensor(ic))
        cols.append(c.reshape(-1))
        off += rows
    return torch.cat(cols)


@functools.lru_cache(maxsize=64)
def _pair_group_order(ic: int, pack_block: int) -> torch.Tensor:
    """For each value of the arm's row, its place in `pair_padded_columns`'
    row: each bit pair's run cut into 16-value pieces (8 words), the 16
    runs' pieces of one word group side by side (TC_GROUP values a group)."""
    order, off = [], 0
    for rows in packing.block_sizes(ic, pack_block):
        g8 = -(-(rows // packing.WORD_BITS) // 8) * 8
        s = torch.arange(g8 // 8).view(-1, 1, 1)
        p = torch.arange(16).view(1, 16, 1)
        k = torch.arange(16).view(1, 1, 16)
        order.append((off + p * 2 * g8 + 16 * s + k).reshape(-1))
        off += 32 * g8
    return torch.cat(order)


@functools.lru_cache(maxsize=64)
def tc_pair_columns(ic: int, pack_block: int) -> torch.Tensor:
    """For each value of a row of x in the bf16 tensor-core arm's layout,
    the natural column it holds, or ``ic`` for a padding zero (int64, CPU):
    `pair_padded_columns` grouped by word group (`_pair_group_order`), so
    word group u is values TC_GROUP·u.. of the row: in its 16-value piece of
    bit pair p, value 2j + h is x of bit p + 16h of the group's word j."""
    return pair_padded_columns(ic, pack_block)[_pair_group_order(ic, pack_block)]


class TcOperands(NamedTuple):
    """The bf16 tensor-core arm's operands: x and the gathered x as
    ``terms`` bf16 planes (`split_terms`), x in `tc_pair_columns`' order."""
    xp: torch.Tensor    # bf16 [terms, m, icp]
    xgp: torch.Tensor   # bf16 [terms, n_rg, m, kst]: k_pad slots, zeros to a multiple of TC_SLOTS
    f32: F32Operands    # rs, rsg, coef (and the f32 x and xg)


_tc_cols: Dict[Tuple[int, int, str], torch.Tensor] = {}


def _tc_columns_on(ic: int, pack_block: int, device) -> torch.Tensor:
    """`tc_pair_columns` on ``device``, copied there once (a decode step
    captured into a CUDA graph makes no host copy)."""
    key = (ic, pack_block, str(device))
    if key not in _tc_cols:
        _tc_cols[key] = tc_pair_columns(ic, pack_block).to(device)
    return _tc_cols[key]


def prepare_tc(x: torch.Tensor, p: PackedLinearV2, terms: int) -> TcOperands:
    """The tensor-core arm's operands (PyTorch ops on x's device)."""
    ops = prepare_f32(x, p)
    m, ic = ops.x.shape
    cols = _tc_columns_on(ic, p.pack_block_local, x.device)
    planes = split_terms(ops.x, terms)                                  # [T, m, ic]
    xp = torch.cat([planes, planes.new_zeros((terms, m, 1))], dim=2)[:, :, cols].contiguous()
    k = ops.xg.shape[2]
    xgp = torch.nn.functional.pad(split_terms(ops.xg, terms), (0, -(-k // TC_SLOTS) * TC_SLOTS - k))
    return TcOperands(xp, xgp.contiguous(), ops)


def tc_x(ops: TcOperands, p: PackedLinearV2) -> torch.Tensor:
    """The x [m, ic] f32 the arm's products take (`join_terms` of its
    planes, back in natural column order; padding dropped)."""
    ic = p.ic_local
    cols = _tc_columns_on(ic, p.pack_block_local, ops.xp.device)
    keep = cols < ic
    xj = join_terms(ops.xp)
    out = xj.new_empty((xj.shape[0], ic))
    out[:, cols[keep]] = xj[:, keep]
    return out


def tc_matmul_plain(ops: TcOperands, p: PackedLinearV2) -> torch.Tensor:
    """Plain PyTorch version of the tensor-core arm on its operands: the
    products of the x and xg its planes carry, the f32 epilogue."""
    return plain_given_x(tc_x(ops, p), join_terms(ops.xgp)[..., :p.k_pad], ops.f32, p)


_TC_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def _check_tc(ops: TcOperands, p: PackedLinearV2, what: str) -> None:
    if p.low_bits != 1 or not tc_layout_ok(p):
        raise ValueError(f"{what}: the tensor-core arm does not take this layout (low_bits "
                         f"{p.low_bits}, oc {p.oc_local}, col_tile {p.col_tile})")


def launch_f32_tc(ops: TcOperands, p: PackedLinearV2) -> torch.Tensor:
    """Launch the exact f32 kernel's tensor-core arm on prepared operands
    (all on one CUDA device) on the current stream; counts one launch."""
    _check_tc(ops, p, "pb_f32_matmul")
    terms, m, _ = ops.xp.shape
    oc = p.oc_local
    out = torch.empty((m, oc), dtype=torch.float32, device=ops.xp.device)
    fn = _build.load("pb_f32_matmul").pb_f32_matmul_tc
    fn.argtypes = _TC_ARGTYPES
    fn.restype = ctypes.c_int
    f = ops.f32
    err = fn(ops.xp.data_ptr(), ops.xgp.data_ptr(), f.rs.data_ptr(), f.rsg.data_ptr(),
             p.sign_packed.data_ptr(), p.side_val.data_ptr(), f.coef.data_ptr(), out.data_ptr(),
             m, p.ic_local, oc, p.pack_block_local, p.side_bits, p.k_pad, p.k_pad_shard_local,
             p.col_tile, p.n_row_groups, terms, torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "pb_f32_matmul (tensor cores)")
    global f32_tc_launches
    f32_tc_launches += 1
    return out


# ---------------------------------------------------------------------------
# stacked layers (scan_layers)
# ---------------------------------------------------------------------------

STACKED_MAX_M = 256  # pb_matmul_stacked: larger m takes the layer's views


def stacked_supported_v2(sp: PackedLinearV2) -> bool:
    """`pallas_pb.stacked_supported_v2`: global selection, 1-bit lows, an
    unsharded sidecar, lane-aligned dims (sp's tensors carry the [L] axis)."""
    _, wpp, oc = sp.sign_packed.shape
    ic = wpp * 32
    if sp.side_idx.shape[2] != 1 or sp.low_bits != 1:
        return False
    if sp.k_pad_shard and sp.k_pad_shard != sp.side_val.shape[1] * (8 // sp.side_bits):
        return False
    if oc % 128 or ic % 32:
        return False
    pb = min(sp.pack_block, ic)
    return not (ic > pb and ic % pb)


def stacked_layer(marker) -> PackedLinearV2:
    """Layer li's views, with its row of the stacked coefficient cache."""
    coef_rows(marker.stacked)
    return marker.layer()


def pb_int8_matmul_stacked_plain(x: torch.Tensor, marker) -> torch.Tensor:
    """The flat plain version on layer li's views."""
    return pb_int8_matmul_plain(x, stacked_layer(marker))


def pb_f32_matmul_stacked_plain(x: torch.Tensor, marker) -> torch.Tensor:
    """The flat plain version on layer li's views."""
    return pb_f32_matmul_plain(x, stacked_layer(marker))


def _check_stacked(x: torch.Tensor, marker, what: str) -> PackedLinearV2:
    """The stacked kernels' conditions; returns layer li's views."""
    p = stacked_layer(marker)
    check_operands(x, p, what)
    sp = marker.stacked
    if not stacked_supported_v2(sp):
        raise ValueError(f"{what}: layout not supported by the stacked kernels")
    if not (sp.sign_packed.is_contiguous() and sp.side_val.is_contiguous()):
        raise ValueError(f"{what}: stacked planes must be contiguous")
    if marker.idx_t.device != x.device or marker.idx_t.dtype != torch.int32:
        raise ValueError(f"{what}: the layer index must be a device int32 tensor")
    return p


def pb_int8_matmul_stacked(x: torch.Tensor, marker) -> torch.Tensor:
    """y = x @ dequant_v2(layer li) (+ bias) through the int8 path, for a
    `models.stacking.StackedPackedLinearV2` marker.  CPU tensor: the plain
    version.  CUDA tensor: the stacked kernel."""
    if x.device.type == "cpu":
        return pb_int8_matmul_stacked_plain(x, marker)
    p = _check_stacked(x, marker, "pb_int8_matmul_stacked")
    if p.k_pad % 4:
        raise ValueError(f"pb_int8_matmul_stacked: k_pad {p.k_pad} must be a multiple of 4")
    return launch_int8_stacked(prepare_int8(x, p, int8_arm(x.shape[0], p)), marker)


def pb_f32_matmul_stacked(x: torch.Tensor, marker) -> torch.Tensor:
    """y = x @ dequant_v2(layer li) (+ bias) through the exact f32 path, for
    a stacked marker.  CPU tensor: the plain version.  CUDA tensor: the
    stacked kernel."""
    if x.device.type == "cpu":
        return pb_f32_matmul_stacked_plain(x, marker)
    p = _check_stacked(x, marker, "pb_f32_matmul_stacked")
    if f32_arm(x.shape[0], p) == "tc":
        return launch_f32_stacked(prepare_tc(x, p, 3), marker)
    return launch_f32_stacked(prepare_f32(x, p), marker)


_STACKED_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_STACKED_F32_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_STACKED_F32_TC_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def launch_int8_stacked(ops: Int8Operands, marker) -> torch.Tensor:
    """Launch the stacked int8 kernel on layer li's prepared operands; it
    reads the whole [L] planes and coefficients (``ops.coef`` is unused) and
    li from ``marker.idx_t``, in the arm the operands' layout names.
    Counts one launch of that arm."""
    sp = marker.stacked
    arm = _arm_of(ops, stacked_layer(marker), "pb_int8_matmul_stacked")
    m, ic = ops.sx.shape[0], sp.sign_packed.shape[1] * 32
    oc = sp.sign_packed.shape[2]
    out = torch.empty((m, oc), dtype=torch.float32, device=ops.sx.device)
    fn = _build.load("pb_int8_matmul").pb_int8_matmul_stacked
    fn.argtypes = _STACKED_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(ops.x8.data_ptr(), ops.sx.data_ptr(), ops.rs.data_ptr(), ops.xg8.data_ptr(),
             ops.rsg.data_ptr(), sp.sign_packed.data_ptr(), sp.side_val.data_ptr(),
             coef_rows(sp).data_ptr(), out.data_ptr(), marker.idx_t.data_ptr(),
             m, ic, oc, min(sp.pack_block, ic), sp.side_bits,
             sp.side_val.shape[1] * (8 // sp.side_bits), sp.sign_packed.shape[0], arm,
             torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "pb_int8_matmul_stacked")
    global stacked_launches, stacked_tc_launches
    if arm:
        stacked_tc_launches += 1
    else:
        stacked_launches += 1
    return out


def launch_f32_stacked(ops, marker) -> torch.Tensor:
    """Launch the stacked f32 kernel on layer li's prepared operands (as
    `launch_int8_stacked`), in the arm the operands name: `F32Operands` the
    CUDA cores, `TcOperands` (three terms) the tensor cores.  Counts one
    launch of that arm."""
    sp = marker.stacked
    tc = isinstance(ops, TcOperands)
    f = ops.f32 if tc else ops
    m, ic = f.x.shape
    oc = sp.sign_packed.shape[2]
    out = torch.empty((m, oc), dtype=torch.float32, device=f.x.device)
    lib = _build.load("pb_f32_matmul")
    common = (f.rs.data_ptr(), f.rsg.data_ptr(), sp.sign_packed.data_ptr(),
              sp.side_val.data_ptr(), coef_rows(sp).data_ptr(), out.data_ptr(),
              marker.idx_t.data_ptr(), m, ic, oc, min(sp.pack_block, ic), sp.side_bits,
              f.xg.shape[2], torch.cuda.current_stream(out.device).cuda_stream)
    if tc:
        _check_tc(ops, stacked_layer(marker), "pb_f32_matmul_stacked")
        if ops.xp.shape[0] != 3:
            raise ValueError("pb_f32_matmul_stacked: the tensor-core arm takes three terms")
        fn = lib.pb_f32_matmul_stacked_tc
        fn.argtypes = _STACKED_F32_TC_ARGTYPES
        fn.restype = ctypes.c_int
        err = fn(ops.xp.data_ptr(), ops.xgp.data_ptr(), *common[:-1], sp.sign_packed.shape[0],
                 common[-1])
    else:
        fn = lib.pb_f32_matmul_stacked
        fn.argtypes = _STACKED_F32_ARGTYPES
        fn.restype = ctypes.c_int
        err = fn(f.x.data_ptr(), f.xg.data_ptr(), *common)
    _build.check(err, "pb_f32_matmul_stacked")
    global stacked_f32_launches, stacked_f32_tc_launches
    if tc:
        stacked_f32_tc_launches += 1
    else:
        stacked_f32_launches += 1
    return out
