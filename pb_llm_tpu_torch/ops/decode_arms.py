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
bf16, which is its plain version.  Three arms (`pair_arm`, the one place
one is chosen): "tc" from PAIR_TC rows on (wgmma with TMA,
`csrc/pb_bf16_tc.cuh`), "split" below (the same device code with its K
loop split over blocks, `pair_ksplit`), both with x in the tensor cores'
order (`packed_matmul.tc_pair_columns`); "mma" (`mma.sync`, x
pair-permuted, `pair_permute_x`) for the layouts they do not take.  The
operands name their layout (`PairOperands.layout`, "mma" or "tc"), and the
plain version on operands (`pair_matmul_plain`) reads either.

dma (`pb_dma_v2`, `csrc/pb_dma_v2.cu`): the exact f32 arm's function
(`pb_f32_matmul_plain` is its plain version).  Two arms (`dma_arm`, the one
place one is chosen): "split" wherever the tensor-core code takes the
layout (`packed_matmul.tc_layout_ok`), the bf16 tensor cores with x and xg
in three exact bf16 terms (`packed_matmul.split_terms`, x in
`tc_pair_columns`' order, the three terms' rows stacked as one wgmma N),
the K stages of a 128-column tile cut into `dma_ksplit` ranges whose
blocks add their sums through a cluster's distributed shared memory, its
operands written by one launch (`prepare_dma`: `pb_prep_dma` in the same source); and
"cores" elsewhere, the f32 CUDA cores with the sign planes and x streamed
through a two-stage shared-memory ring by bulk copies, x in [m
tile][word][bit][row] order (`dma_x_layout`).  The operands name their
layout (`DmaOperands.layout`, the arm's name), and the plain version on
operands (`dma_matmul_plain`) reads either.  The "split" device code, its
launch (`packed_matmul.launch_split`), its K ranges and its x preparation
are also the exact f32 kernel's arm "split" below `packed_matmul.F32_TC`
rows, flat and stacked: at one row group the two arms make the same
launch.

Each wrapper launches its CUDA kernel on a CUDA tensor and runs its plain
PyTorch version on a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..core import packing
from ..core.pbw import PackedLinearV2
from . import _build
from . import packed_matmul as pm
from .packed_matmul import F32Operands, check_operands, pb_f32_matmul_plain, prepare_f32

pair_launches = 0  # kernel launches of pb_pair_v2's "mma" arm (plain-version calls not counted)
pair_split_launches = 0  # kernel launches of pb_pair_v2's "split" arm
pair_tc_launches = 0  # kernel launches of pb_pair_v2's "tc" arm
dma_launches = 0   # kernel launches of pb_dma_v2's "cores" arm (plain-version calls not counted)
dma_split_launches = 0  # kernel launches of pb_dma_v2's "split" arm

PAIR_TM = 16   # the "mma" arm's m tile (the MMA's 16 rows)
# The pair kernel's arms: "split" below PAIR_TC rows, "tc" from PAIR_TC rows
# on, "mma" for the layouts the tensor-core code does not take (`pair_arm`).
# On an H100 (700 W), over a llama-7b layer's four linears (fused q|k|v, o,
# fused gate|up, down), "split" takes less time up to 64 rows and "tc" from
# 128 (chip_smoke.py phase 2); in the graphed decode step of 8 slots
# "split" wins too (scripts/torch_pair_arm_ab.py; PERF.md).
PAIR_TC = 128
PAIR_ARMS = ("mma", "split", "tc")
SPLIT_BLOCKS = pm.SPLIT_BLOCKS  # pair "split" cuts K so that a launch has about this many blocks
DMA_TM = 8     # the "cores" arm's m tile
DMA_CW = 16    # the "cores" arm's sign-word rows per stage
# The dma kernel's arms: DMA_ARM where the tensor cores take the layout
# (`dma_arm`), "cores" elsewhere.  "split" is the redesign for the card
# (PERF.md: its time against "cores" in one call, and the dma pass's step
# in turns); "cores" stays as a yardstick.
DMA_ARM = "split"
DMA_ARMS = ("cores", "split")


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
_PAIR_TC_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def pair_arm(m: int, p: PackedLinearV2) -> str:
    """The pair kernel's arm for ``m`` rows of x on layout ``p``: "tc" at
    m >= PAIR_TC, "split" below, where the tensor-core code takes the
    layout (`packed_matmul.tc_layout_ok`); else "mma"."""
    if not pm.tc_layout_ok(p):
        return "mma"
    return "tc" if m >= PAIR_TC else "split"


def pair_ksplit(p: PackedLinearV2) -> int:
    """The "split" arm's K ranges for layout ``p``, from its shape alone (so
    a row's sums run in one order whatever m is): enough that the 128-column
    tiles times the ranges reach SPLIT_BLOCKS, at most one range a unit (a
    word group of 8 sign words, or 64 sidecar slots)."""
    ic, pb = p.ic_local, p.pack_block_local
    units = sum(-(-rows // 256) for rows in packing.block_sizes(ic, pb))
    units += -(-p.k_pad // pm.TC_SLOTS)
    tiles = -(-p.oc_local // 128)
    return max(1, min(units, -(-SPLIT_BLOCKS // tiles)))


class PairOperands(NamedTuple):
    xp: torch.Tensor   # bf16: "mma" [m_pad, ic] pair-permuted, rows zero-padded to 16;
                       # "tc" [1, m, icp] (`packed_matmul.tc_pair_columns`)
    f32: F32Operands   # xg, rs, rsg, coef (and the f32 x, m rows)
    layout: str = "mma"  # the arms these operands are laid out for: "mma", or "tc" (split, tc)
    xgp: Optional[torch.Tensor] = None  # "tc": bf16 [1, n_rg, m, kst] gathered x, zero-padded


def prepare_pair(x: torch.Tensor, p: PackedLinearV2, layout: str = "mma") -> PairOperands:
    """The pair kernel's operands in ``layout`` ("mma" or "tc")."""
    if layout == "tc":
        ops = pm.prepare_tc(x, p, 1)
        return PairOperands(ops.xp, ops.f32, "tc", ops.xgp)
    if layout != "mma":
        raise ValueError(f"prepare_pair: unknown layout {layout!r}")
    ops = prepare_f32(x, p)
    m, ic = ops.x.shape
    xp = torch.zeros((-(-m // PAIR_TM) * PAIR_TM, ic), dtype=torch.bfloat16, device=x.device)
    xp[:m] = pair_permute_x(ops.x, ic, p.pack_block_local)
    return PairOperands(xp, ops)


def _layout_of(arm: str) -> str:
    return "mma" if arm == "mma" else "tc"


def pair_matmul_plain(ops: PairOperands, p: PackedLinearV2) -> torch.Tensor:
    """Plain PyTorch version of the kernel on its operands, in either
    layout: the products of the bf16 x and xg they carry, the f32
    epilogue."""
    f = ops.f32
    if ops.layout == "tc":
        return pm.tc_matmul_plain(pm.TcOperands(ops.xp, ops.xgp, f), p)
    m, ic = f.x.shape
    xp = ops.xp[:m].float()
    x = torch.empty_like(xp)
    x[:, pair_permute_index(ic, p.pack_block_local).to(xp.device)] = xp
    return pm.plain_given_x(x, f.xg.to(torch.bfloat16).float(), f, p)


def pair_permute_index(ic: int, pack_block: int) -> torch.Tensor:
    """For each column of `pair_permute_x`'s row, the natural column it holds."""
    return pair_permute_x(torch.arange(ic, dtype=torch.float64)[None], ic, pack_block)[0].long()


def pb_pair_v2(x: torch.Tensor, p: PackedLinearV2) -> torch.Tensor:
    """y = x @ dequant_v2(p) (+ bias) through the pair arm; x [m, ic] → f32
    [m, oc].  CPU tensor: the plain version.  CUDA tensor: the kernel, in
    the arm `pair_arm` picks."""
    if x.device.type == "cpu":
        return pb_pair_v2_plain(x, p)
    _check(x, p, "pb_pair_v2")
    arm = pair_arm(x.shape[0], p)
    return launch_pair(prepare_pair(x, p, _layout_of(arm)), p, arm)


def launch_pair(ops: PairOperands, p: PackedLinearV2, arm: Optional[str] = None) -> torch.Tensor:
    """Launch the pair kernel on prepared operands (all on one CUDA device)
    on the current stream, in ``arm`` (by default "mma" for "mma" operands,
    `pair_arm`'s pick for "tc" ones); counts one launch of that arm."""
    f = ops.f32
    m, ic = f.x.shape
    if arm is None:
        arm = "mma" if ops.layout == "mma" else pair_arm(m, p)
    if arm not in PAIR_ARMS or _layout_of(arm) != ops.layout:
        raise ValueError(f"pb_pair_v2: arm {arm!r} does not take {ops.layout!r} operands")
    out = torch.empty((m, p.oc_local), dtype=torch.float32, device=f.x.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    lib = _build.load("pb_pair_v2")
    if arm == "mma":
        fn = lib.pb_pair_v2
        fn.argtypes = _PAIR_ARGTYPES
        fn.restype = ctypes.c_int
        err = fn(ops.xp.data_ptr(), f.xg.data_ptr(), f.rs.data_ptr(), f.rsg.data_ptr(),
                 p.sign_packed.data_ptr(), p.side_val.data_ptr(), f.coef.data_ptr(),
                 out.data_ptr(), m, ops.xp.shape[0], ic, p.oc_local, p.pack_block_local,
                 p.side_bits, p.k_pad, p.k_pad_shard_local, p.col_tile, stream)
    else:
        if not pm.tc_layout_ok(p):
            raise ValueError(f"pb_pair_v2: the tensor-core arm does not take this layout "
                             f"(oc {p.oc_local}, col_tile {p.col_tile})")
        ksplit = pair_ksplit(p) if arm == "split" else 1
        part = (torch.empty((ksplit, 2, m, p.oc_local), dtype=torch.float32, device=out.device)
                if ksplit > 1 else None)
        fn = lib.pb_pair_v2_tc
        fn.argtypes = _PAIR_TC_ARGTYPES
        fn.restype = ctypes.c_int
        err = fn(ops.xp.data_ptr(), ops.xgp.data_ptr(), f.rs.data_ptr(), f.rsg.data_ptr(),
                 p.sign_packed.data_ptr(), p.side_val.data_ptr(), f.coef.data_ptr(),
                 out.data_ptr(), None if part is None else part.data_ptr(), m, ic, p.oc_local,
                 p.pack_block_local, p.side_bits, p.k_pad, p.k_pad_shard_local, p.col_tile,
                 p.n_row_groups, ksplit, stream)
    _build.check(err, f"pb_pair_v2 ({arm})")
    global pair_launches, pair_split_launches, pair_tc_launches
    if arm == "mma":
        pair_launches += 1
    elif arm == "split":
        pair_split_launches += 1
    else:
        pair_tc_launches += 1
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
    xt: torch.Tensor   # "cores": f32 [ceil(m/8), nwords_pad, 32, 8] (`dma_x_layout`);
                       # "split": bf16 [3, m, icp] (`packed_matmul.tc_pair_columns`)
    f32: F32Operands   # rs, rsg, coef (and the f32 x, m rows; "cores": xg)
    layout: str = "cores"  # the arm these operands are laid out for
    xgp: Optional[torch.Tensor] = None  # "split": bf16 [3, 1, m, kst], zero-padded slots


def dma_arm(p: PackedLinearV2) -> str:
    """The dma kernel's arm on layout ``p`` (the same for every m):
    DMA_ARM where `packed_matmul.tc_layout_ok`, else "cores"."""
    return DMA_ARM if pm.tc_layout_ok(p) else "cores"


# the "split" arm's K ranges: the packed matmul module's rule, shared with
# the exact f32 kernel's arm "split" (the same device code)
dma_ksplit = pm.split_ksplit
dma_ranges = pm.split_ranges


def prepare_dma(x: torch.Tensor, p: PackedLinearV2, layout: str = "cores") -> DmaOperands:
    """The dma kernel's operands in ``layout`` ("cores" or "split").  For
    "split": on a CPU tensor the plain version (`packed_matmul.prepare_tc`
    with three terms), on a CUDA tensor one launch of `pb_prep_dma` (the
    same terms bit for bit, the row sums within `packed_matmul.sum_bound`)."""
    if layout == "split":
        ops = pm.prepare_split(x, p)
        return DmaOperands(ops.xp, ops.f32, "split", ops.xgp)
    if layout != "cores":
        raise ValueError(f"prepare_dma: unknown layout {layout!r}")
    ops = prepare_f32(x, p)
    return DmaOperands(dma_x_layout(ops.x, p.ic_local, p.pack_block_local), ops)


def launch_prep_dma(xf: torch.Tensor, p: PackedLinearV2) -> DmaOperands:
    """Launch the "split" arm's x preparation (`packed_matmul.
    launch_prep_split`, `pb_prep_dma`) on a contiguous f32 x on the card;
    counts one launch."""
    ops = pm.launch_prep_split(xf, p)
    return DmaOperands(ops.xp, ops.f32, "split", ops.xgp)


def dma_matmul_plain(ops: DmaOperands, p: PackedLinearV2) -> torch.Tensor:
    """Plain PyTorch version of the kernel on its operands, in either
    layout: the exact products of the x and xg they carry, the f32
    epilogue."""
    f = ops.f32
    if ops.layout == "split":
        return pm.tc_matmul_plain(pm.TcOperands(ops.xt, ops.xgp, f), p)
    return pm.plain_given_x(f.x, f.xg, f, p)


def pb_dma_v2(x: torch.Tensor, p: PackedLinearV2) -> torch.Tensor:
    """y = x @ dequant_v2(p) (+ bias) through the dma arm (one row group);
    x [m, ic] → f32 [m, oc].  CPU tensor: the plain version.  CUDA tensor:
    the kernel, in the arm `dma_arm` picks."""
    if x.device.type == "cpu":
        return pb_dma_v2_plain(x, p)
    _check(x, p, "pb_dma_v2")
    if p.n_row_groups != 1:
        raise ValueError("pb_dma_v2 needs one row group (global selection)")
    return launch_dma(prepare_dma(x, p, dma_arm(p)), p)


def launch_dma(ops: DmaOperands, p: PackedLinearV2) -> torch.Tensor:
    """Launch the dma kernel on prepared operands (all on one CUDA device)
    on the current stream, in the arm of their layout; counts one launch of
    that arm."""
    f = ops.f32
    m = f.rs.shape[0]
    arm = ops.layout
    if arm not in DMA_ARMS:
        raise ValueError(f"pb_dma_v2: no arm takes {arm!r} operands")
    global dma_launches, dma_split_launches
    if arm == "split":
        if not pm.tc_layout_ok(p) or p.n_row_groups != 1:
            raise ValueError(f"pb_dma_v2: the split arm does not take this layout "
                             f"(oc {p.oc_local}, row groups {p.n_row_groups})")
        out = pm.launch_split(pm.TcOperands(ops.xt, ops.xgp, f, "split"), p)
        dma_split_launches += 1
        return out
    out = torch.empty((m, p.oc_local), dtype=torch.float32, device=f.rs.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    fn = _build.load("pb_dma_v2").pb_dma_v2
    fn.argtypes = _DMA_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(ops.xt.data_ptr(), f.xg.data_ptr(), f.rs.data_ptr(), f.rsg.data_ptr(),
             p.sign_packed.data_ptr(), p.side_val.data_ptr(), f.coef.data_ptr(),
             out.data_ptr(), m, p.ic_local, p.oc_local, p.side_bits, p.k_pad,
             p.k_pad_shard_local, stream)
    _build.check(err, "pb_dma_v2 (cores)")
    dma_launches += 1
    return out
