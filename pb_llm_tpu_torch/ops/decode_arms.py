"""The PBW-v2 decode arms "pair" and "dma": the counterparts of
`pb_llm_tpu/ops/pallas_pb.py`'s pair path (`_planar_v2_call` with
pair=True + `_planar_v2_pair_kernel`) and dma path (`_planar_v2_dma_call` +
`_planar_v2_dma_kernel`).  Their gates (1-bit lows; dma also one row group
and m ≤ 256) live in `ops.binary_matmul`.

pair (`pb_pair_v2`, `csrc/pb_pair_v2.cu`), on the tensor cores:

    y = rowsum(x)·β + (bf16(x)·B′)·2α + (bf16(xg)·V)·hs + rowsum(xg)·γ + bias

x and xg round to bf16 (nearest even) inside the two products only; the
products are exact in f32 and sum in f32; the row sums come from the
unrounded x.  This is `packed_matmul.pb_f32_matmul_plain` with dot_dtype
bf16, which is its plain version.  The kernel takes x pair-permuted
(`pair_permute_x`) in bf16.

dma (`pb_dma_v2`, `csrc/pb_dma_v2.cu`): the exact f32 arm's function
(`pb_f32_matmul_plain` is its plain version), with the sign planes and x
streamed through a two-stage shared-memory ring by bulk copies.  The kernel
takes x in [m tile][word][bit][row] order (`dma_x_layout`).

Each wrapper launches its CUDA kernel on a CUDA tensor and runs its plain
PyTorch version on a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from ..core import packing
from ..core.pbw import PackedLinearV2
from . import _build
from .packed_matmul import F32Operands, check_operands, pb_f32_matmul_plain, prepare_f32

pair_launches = 0  # kernel launches of pb_pair_v2 (plain-version calls not counted)
dma_launches = 0   # kernel launches of pb_dma_v2 (plain-version calls not counted)

PAIR_TM = 16   # the pair kernel's m tile (the MMA's 16 rows)
DMA_TM = 8     # the dma kernel's m tile
DMA_CW = 16    # the dma kernel's sign-word rows per stage


def pair_permute_x(x: torch.Tensor, ic: int, pack_block: int) -> torch.Tensor:
    """`pallas_pb.pair_permute_x`: within each pack block (g = rows/32
    words) old column b·g + i moves to p·2g + 2i + h, where b = p + 16h."""
    m = x.shape[0]
    parts, r_off = [], 0
    for rows in packing.block_sizes(ic, pack_block):
        g = rows // 32
        blk = x[:, r_off : r_off + rows].reshape(m, 2, 16, g)  # (h, p, i)
        parts.append(blk.permute(0, 2, 3, 1).reshape(m, rows))
        r_off += rows
    return torch.cat(parts, dim=1)


def pb_pair_v2_plain(x: torch.Tensor, p: PackedLinearV2) -> torch.Tensor:
    """Plain PyTorch version of the pair kernel (see the module note)."""
    return pb_f32_matmul_plain(x, p, torch.bfloat16)


def pb_dma_v2_plain(x: torch.Tensor, p: PackedLinearV2) -> torch.Tensor:
    """Plain PyTorch version of the dma kernel: the exact f32 arm's."""
    return pb_f32_matmul_plain(x, p)


def _check(x: torch.Tensor, p: PackedLinearV2, what: str) -> None:
    check_operands(x, p, what)
    if p.low_bits != 1:
        raise ValueError(f"{what} needs low_bits == 1")
    if p.oc_local % 32:
        raise ValueError(f"{what}: oc {p.oc_local} must be a multiple of 32")


# ---------------------------------------------------------------------------
# pair
# ---------------------------------------------------------------------------

_PAIR_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


class PairOperands(NamedTuple):
    xp: torch.Tensor   # bf16 [m_pad, ic]: x pair-permuted, rows zero-padded to 16
    f32: F32Operands   # xg, rs, rsg, coef (and the f32 x, m rows)


def prepare_pair(x: torch.Tensor, p: PackedLinearV2) -> PairOperands:
    ops = prepare_f32(x, p)
    m, ic = ops.x.shape
    xp = torch.zeros((-(-m // PAIR_TM) * PAIR_TM, ic), dtype=torch.bfloat16, device=x.device)
    xp[:m] = pair_permute_x(ops.x, ic, p.pack_block_local)
    return PairOperands(xp, ops)


def pb_pair_v2(x: torch.Tensor, p: PackedLinearV2) -> torch.Tensor:
    """y = x @ dequant_v2(p) (+ bias) through the pair arm; x [m, ic] → f32
    [m, oc].  CPU tensor: the plain version.  CUDA tensor: the kernel."""
    if x.device.type == "cpu":
        return pb_pair_v2_plain(x, p)
    _check(x, p, "pb_pair_v2")
    return launch_pair(prepare_pair(x, p), p)


def launch_pair(ops: PairOperands, p: PackedLinearV2) -> torch.Tensor:
    """Launch the pair kernel on prepared operands (all on one CUDA device)
    on the current stream; counts one launch."""
    f = ops.f32
    m, ic = f.x.shape
    out = torch.empty((m, p.oc_local), dtype=torch.float32, device=f.x.device)
    fn = _build.load("pb_pair_v2").pb_pair_v2
    fn.argtypes = _PAIR_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(ops.xp.data_ptr(), f.xg.data_ptr(), f.rs.data_ptr(), f.rsg.data_ptr(),
             p.sign_packed.data_ptr(), p.side_val.data_ptr(), f.coef.data_ptr(),
             out.data_ptr(), m, ops.xp.shape[0], ic, p.oc_local, p.pack_block_local,
             p.side_bits, p.k_pad, p.k_pad_shard_local, p.col_tile,
             torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "pb_pair_v2")
    global pair_launches
    pair_launches += 1
    return out


# ---------------------------------------------------------------------------
# dma
# ---------------------------------------------------------------------------

_DMA_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_row_index: Dict[Tuple[int, int, str], torch.Tensor] = {}


def _dma_rows(ic: int, pack_block: int, device) -> torch.Tensor:
    """[nwords_pad, 32] long: the weight row of bit b of sign word w (bit b
    of word gi in a pack block at blk_off holds row blk_off + b·g + gi);
    padding words read column ic, a zero column."""
    key = (ic, pack_block, str(device))
    if key not in _row_index:
        nwords = ic // 32
        nwords_pad = -(-nwords // DMA_CW) * DMA_CW
        idx = torch.full((nwords_pad, 32), ic, dtype=torch.long)
        w_off = r_off = 0
        for rows in packing.block_sizes(ic, pack_block):
            g = rows // 32
            gi = torch.arange(g)
            idx[w_off : w_off + g] = r_off + torch.arange(32)[None, :] * g + gi[:, None]
            w_off += g
            r_off += rows
        _row_index[key] = idx.to(device)
    return _row_index[key]


def dma_x_layout(x: torch.Tensor, ic: int, pack_block: int) -> torch.Tensor:
    """x [m, ic] f32 → [ceil(m/8), nwords_pad, 32, 8]: each m tile's x in the
    [word][bit][row] order the dma kernel's stages hold, zero past m and ic."""
    m = x.shape[0]
    m_pad = -(-m // DMA_TM) * DMA_TM
    xa = torch.zeros((m_pad, ic + 1), dtype=torch.float32, device=x.device)
    xa[:m, :ic] = x
    g = xa[:, _dma_rows(ic, pack_block, x.device)]              # [m_pad, nwords_pad, 32]
    return g.reshape(m_pad // DMA_TM, DMA_TM, *g.shape[1:]).permute(0, 2, 3, 1).contiguous()


class DmaOperands(NamedTuple):
    xt: torch.Tensor   # f32 [ceil(m/8), nwords_pad, 32, 8] (`dma_x_layout`)
    f32: F32Operands   # xg, rs, rsg, coef (and the f32 x, m rows)


def prepare_dma(x: torch.Tensor, p: PackedLinearV2) -> DmaOperands:
    ops = prepare_f32(x, p)
    return DmaOperands(dma_x_layout(ops.x, p.ic_local, p.pack_block_local), ops)


def pb_dma_v2(x: torch.Tensor, p: PackedLinearV2) -> torch.Tensor:
    """y = x @ dequant_v2(p) (+ bias) through the dma arm (one row group);
    x [m, ic] → f32 [m, oc].  CPU tensor: the plain version.  CUDA tensor:
    the kernel."""
    if x.device.type == "cpu":
        return pb_dma_v2_plain(x, p)
    _check(x, p, "pb_dma_v2")
    if p.n_row_groups != 1:
        raise ValueError("pb_dma_v2 needs one row group (global selection)")
    return launch_dma(prepare_dma(x, p), p)


def launch_dma(ops: DmaOperands, p: PackedLinearV2) -> torch.Tensor:
    """Launch the dma kernel on prepared operands (all on one CUDA device)
    on the current stream; counts one launch."""
    f = ops.f32
    m, ic = f.x.shape
    out = torch.empty((m, p.oc_local), dtype=torch.float32, device=f.x.device)
    fn = _build.load("pb_dma_v2").pb_dma_v2
    fn.argtypes = _DMA_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(ops.xt.data_ptr(), f.xg.data_ptr(), f.rs.data_ptr(), f.rsg.data_ptr(),
             p.sign_packed.data_ptr(), p.side_val.data_ptr(), f.coef.data_ptr(),
             out.data_ptr(), m, ic, p.oc_local, p.side_bits, p.k_pad, p.k_pad_shard_local,
             torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "pb_dma_v2")
    global dma_launches
    dma_launches += 1
    return out
