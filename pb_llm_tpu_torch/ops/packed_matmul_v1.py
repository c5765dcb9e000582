"""PBW-v1 packed matmuls: the counterparts of `pb_llm_tpu/ops/pallas_pb.py`'s
planar path (`_planar_call` + `_planar_kernel`) and select path
(`_select_call` + `_select_kernel` + `_reconstruct_tile`); the dispatch of
`pb_matmul_pallas` between them lives in `ops.binary_matmul`.

planar (`pb_planar_v1`, `csrc/pb_planar_v1.cu`), decode at m < 256:

    y = Σ_g [rs_g·β_g + (x·C)_g·2α_g + (x·M)_g·2γ_g] + (x·V)·hs + bias

g runs over the low-scale groups (a pack block never straddles one), rs_g
is the row sum of x over the group's rows, C = Σ_j 2^j·B_j the low code
from {0,1} bit planes, M the salient mask plane and V the high codes (zero
where not salient).  For 1-bit lows α = scale and β = mean − scale; for 2-
and 4-bit lows α = scale/2 and β = −scale·zero; γ = ½(−hs·hz − β).  The
JAX kernel's {0,2} planes carry the factor 2 that lives in 2α and 2γ here,
which is exact.

select (`pb_select_v1`, `csrc/pb_select_v1.cu`), m ≥ 256 or where the
planar path does not fit:

    w = w_bin + M·(w_hi − w_bin),  y = x·w + bias

with w_bin = mean + (2·C − 1)·scale (1-bit lows) or scale·(C − zero) (2-
and 4-bit lows) and w_hi = hs·(V − hz), each operation rounded once in f32
as `_reconstruct_tile` writes it.  ``dot_dtype`` bf16 (prefill
"hybrid_bf16") rounds x and w to bf16; the products are exact in f32 and
sum in f32.  Two arms (`select_arm`): "cores", the f32 CUDA cores, and
"tc", the bf16 tensor cores with x and w in bf16 terms (`SELECT_TERMS`).

Each wrapper launches its CUDA kernel on a CUDA tensor and runs its plain
PyTorch version on a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import no_tf32
from ..core import packing
from ..core.pbw import PackedLinear, low_code, sidecar_codes
from . import _build, bf16_terms

V1_PLANAR_M = 256                    # pb_matmul_pallas: planar below, select at or above
_PLANAR_VMEM_CAP = 12 * 1024 * 1024  # pallas_pb._PLANAR_VMEM_CAP

# The select kernel's arms: "cores" (f32 CUDA cores), "tc" (bf16 tensor
# cores) from SELECT_TC rows, measured on an H100 (PERF.md, §6: the select
# crossover).
SELECT_ARMS = ("cores", "tc")
SELECT_TC = 1
# "tc" with an f32 dot: the products (x term, w term) it issues, in order,
# x and w each in three bf16 terms (`bf16_terms.split`).  The fewest whose
# CPU emulation stays within a third of the 1e-4 bound on y; all three of
# w's terms meet x's first, so an identity x reads back w bit for bit
# (tests/test_torch_tc_terms.py).  A bf16 dot issues (0, 0) alone.
SELECT_TERMS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
_TC_OC, _TC_ROWS, _TC_STAGE = 128, 128, 64  # arm "tc": a block's columns and x rows, a stage's k
SPLIT_MIN_STAGES = 8  # arm "tc"'s K split: the fewest stages a range takes

planar_launches = 0  # kernel launches of pb_planar_v1 (plain-version calls not counted)
select_launches = 0  # launches of pb_select_v1's arm "cores" (plain-version calls not counted)
select_tc_launches = 0  # launches of its arm "tc"

_DOT_DTYPES = (torch.float32, torch.bfloat16)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def default_oc_tile(oc: int) -> int:
    """`pallas_pb._default_oc_tile`: the TPU kernel's output tile, which
    only `planar_ok`'s budget reads here."""
    for cand in (512, 256, 128):
        if oc % cand == 0:
            return cand
    return oc


def groups_hold_blocks(p: PackedLinear) -> bool:
    """Every pack block lies inside one scale group and the groups tile ic
    (what the planar path's per-group terms need)."""
    gs, ic = p.groupsize_local, p.ic_local
    return gs >= ic or (ic % gs == 0 and gs % p.pack_block_local == 0)


def planar_ok(m: int, p: PackedLinear) -> bool:
    """`pallas_pb._planar_ok`: `groups_hold_blocks`, and the TPU kernel's
    resident x and plane tiles must fit its 12 MB VMEM budget.  The budget
    is a TPU artefact, kept so that the port takes the same arm as the JAX
    package at every m."""
    ic, oc = p.ic_local, p.oc_local
    if not groups_hold_blocks(p):
        return False
    m_pad = _round_up(max(m, 8), 8)
    oc_tile = default_oc_tile(oc)
    vmem = m_pad * ic * 4 + ic * oc_tile + 2 * (ic // 32) * oc_tile * 4 + m_pad * oc_tile * 4
    return vmem < _PLANAR_VMEM_CAP


def use_planar(m: int, p: PackedLinear) -> bool:
    """The arm `pb_matmul_pallas` takes for m rows."""
    return m < V1_PLANAR_M and planar_ok(m, p)


def kernel_supported_v1(p: PackedLinear) -> bool:
    """`pallas_pb.pallas_supported`: the layouts the kernels take (others
    run `core.pbw.matmul_reference`, as in JAX)."""
    ic, oc = p.ic_local, p.oc_local
    pack_block = p.pack_block_local
    if oc % 128 or ic % 32 or (ic > pack_block and ic % pack_block):
        return False
    ic_tile = pack_block if ic > pack_block else ic
    gs = p.groupsize_local
    if gs < ic_tile and ic_tile % gs:
        return False
    return not (gs > ic_tile and gs % ic_tile)


def planar_coef(p: PackedLinear) -> torch.Tensor:
    """The [3G+2, oc] rows 2α (G), β (G), 2γ (G), hs, bias, made once per
    layer on its device."""
    if p.coef_cache is None:
        scale, mean = p.low_scale.float(), p.low_mean.float()
        if p.low_bits == 1:
            alpha2, beta = 2.0 * scale, mean - scale
        else:
            alpha2, beta = scale, -scale * mean
        gamma2 = -(p.high_scale * p.high_zero)[None, :] - beta
        bias = p.bias if p.bias is not None else torch.zeros_like(p.high_scale)
        p.coef_cache = torch.cat([alpha2, beta, gamma2, p.high_scale[None], bias[None]],
                                 dim=0).contiguous()
    return p.coef_cache


def _check(x: torch.Tensor, p: PackedLinear, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[1] != p.ic_local:
        raise ValueError(f"{what}: x {tuple(x.shape)} does not match ic {p.ic_local}")
    if not kernel_supported_v1(p):
        raise ValueError(f"{what}: layout ic={p.ic_local} oc={p.oc_local} pack_block="
                         f"{p.pack_block_local} groupsize={p.groupsize_local} is not supported")
    if p.low_bits not in (1, 2, 4) or p.sidecar_bits not in (4, 8):
        raise ValueError(f"{what}: low_bits {p.low_bits} / sidecar_bits {p.sidecar_bits}")
    for name in ("sign_packed", "mask_packed", "sidecar", "low_scale", "low_mean",
                 "high_scale", "high_zero", "bias"):
        t = getattr(p, name)
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be contiguous and on x's device {x.device} "
                             f"(it lies on {t.device})")
    if p.sidecar.data_ptr() % 16:
        raise ValueError(f"{what}: the sidecar must be 16-byte aligned (16-byte code loads)")
    if (p.sign_packed.dtype, p.mask_packed.dtype, p.sidecar.dtype) != (
            torch.int32, torch.int32, torch.uint8):
        raise ValueError(f"{what}: planes must be int32 / int32 / uint8")


# ---------------------------------------------------------------------------
# planar
# ---------------------------------------------------------------------------

def pb_planar_v1_plain(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """Plain PyTorch version of the planar kernel: the same coefficient
    rows, the three plane products per group as f32 `torch.matmul`s, the
    kernel's epilogue order."""
    xf = x.float()
    ic, n_groups, gs = p.ic_local, p.n_groups, p.groupsize_local
    coef = planar_coef(p)
    code = low_code(p.sign_packed, p.low_bits, ic, p.pack_block_local)
    mbits = packing.unpack_bits(p.mask_packed, ic, p.pack_block_local).float()
    total = torch.zeros((x.shape[0], p.oc_local), dtype=torch.float32, device=x.device)
    with no_tf32():
        for g in range(n_groups):
            xs = xf[:, g * gs : (g + 1) * gs]
            rows = slice(g * gs, (g + 1) * gs)
            total = total + (xs.sum(dim=1, keepdim=True) * coef[n_groups + g]
                             + (xs @ code[rows]) * coef[g]
                             + (xs @ mbits[rows]) * coef[2 * n_groups + g])
        acc_v = xf @ sidecar_codes(p).float()
    return total + acc_v * coef[3 * n_groups] + coef[3 * n_groups + 1]


_PLANAR_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def pb_planar_v1(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """y = x @ dequantize(p) (+ bias) through the planar path; x [m, ic] →
    f32 [m, oc].  CPU tensor: the plain version.  CUDA tensor: the kernel."""
    if x.device.type == "cpu":
        return pb_planar_v1_plain(x, p)
    _check(x, p, "pb_planar_v1")
    if not groups_hold_blocks(p):
        raise ValueError("pb_planar_v1: scale groups must hold whole pack blocks")
    return launch_planar(x.float().contiguous(), p)


def launch_planar(x: torch.Tensor, p: PackedLinear) -> torch.Tensor:
    """Launch the planar kernel on a checked layer and contiguous f32 x on
    the current stream; counts one launch."""
    m, ic = x.shape
    oc = p.oc_local
    out = torch.empty((m, oc), dtype=torch.float32, device=x.device)
    coef = planar_coef(p)
    fn = _build.load("pb_planar_v1").pb_planar_v1
    fn.argtypes = _PLANAR_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), p.sign_packed.data_ptr(), p.mask_packed.data_ptr(),
             p.sidecar.data_ptr(), coef.data_ptr(), out.data_ptr(),
             m, ic, oc, p.pack_block_local, p.low_bits, p.sidecar_bits, p.groupsize_local,
             p.n_groups, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "pb_planar_v1")
    global planar_launches
    planar_launches += 1
    return out


# ---------------------------------------------------------------------------
# select
# ---------------------------------------------------------------------------

def select_weight(p: PackedLinear) -> torch.Tensor:
    """The weight [ic, oc] as `_reconstruct_tile` rebuilds it: the blend
    w_bin + M·(w_hi − w_bin), each operation rounded once in f32."""
    ic, gs = p.ic_local, p.groupsize_local
    code = low_code(p.sign_packed, p.low_bits, ic, p.pack_block_local)
    mbits = packing.unpack_bits(p.mask_packed, ic, p.pack_block_local).float()
    scale = torch.repeat_interleave(p.low_scale, gs, dim=0)[:ic]
    mean = torch.repeat_interleave(p.low_mean, gs, dim=0)[:ic]
    if p.low_bits == 1:
        w_bin = mean + (2.0 * code - 1.0) * scale
    else:
        w_bin = scale * (code - mean)  # low_mean holds the zero point
    w_hi = p.high_scale[None, :] * (sidecar_codes(p).float() - p.high_zero[None, :])
    return w_bin + mbits * (w_hi - w_bin)


def pb_select_v1_plain(x: torch.Tensor, p: PackedLinear, dot_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the select kernel: the same rebuilt weight,
    one f32 `torch.matmul` of (bf16-rounded, for ``dot_dtype`` bf16) x and
    w, then the bias."""
    w = select_weight(p).to(dot_dtype).float()
    with no_tf32():
        y = x.float().to(dot_dtype).float() @ w
    return y + p.bias if p.bias is not None else y


_SELECT_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_SELECT_TC_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def select_arm(m: int, p: PackedLinear) -> str:
    """The select kernel's arm for ``m`` rows of x: "tc" from SELECT_TC rows,
    else "cores".  The one place the arm is chosen."""
    return "tc" if m >= SELECT_TC else "cores"


def select_ksplit(m: int, p: PackedLinear, sms: int) -> int:
    """Arm "tc"'s K split on a card of ``sms`` multiprocessors: a grid of
    fewer blocks (128 columns by 128 rows of x each) than multiprocessors
    cuts K into that many more ranges, each of at least SPLIT_MIN_STAGES
    stages; a second launch adds the ranges' sums in range order."""
    blocks = (p.oc_local // _TC_OC) * -(-m // _TC_ROWS)
    stages = -(-p.ic_local // _TC_STAGE)
    return max(1, min(sms // blocks, stages // SPLIT_MIN_STAGES))


def select_products(dot_dtype) -> tuple:
    """The (x term, w term) products arm "tc" issues for ``dot_dtype``."""
    return ((0, 0),) if dot_dtype == torch.bfloat16 else SELECT_TERMS


def tc_x_order(ic: int, pack_block: int) -> torch.Tensor:
    """Arm "tc"'s column order of x: position 32·W + b (global sign word W,
    bit b) holds weight row (W // g)·32g + b·g + W % g, g the words of a
    pack block (int64, CPU)."""
    g = min(ic, pack_block) // 32
    w = torch.arange(ic // 32).view(-1, 1)
    b = torch.arange(32).view(1, -1)
    return ((w // g) * 32 * g + b * g + w % g).reshape(-1)


def select_x_terms_plain(x: torch.Tensor, p: PackedLinear, dot_dtype=torch.float32) -> torch.Tensor:
    """Plain version of arm "tc"'s x preparation: x's bf16 terms [terms, m,
    ic] in `tc_x_order`."""
    order = tc_x_order(p.ic_local, p.pack_block_local).to(x.device)
    return bf16_terms.split(x.float()[:, order], bf16_terms.count(select_products(dot_dtype))[0])


def pb_select_v1(x: torch.Tensor, p: PackedLinear, dot_dtype=torch.float32,
                 arm: Optional[str] = None) -> torch.Tensor:
    """y = x @ w (+ bias) through the select path; x [m, ic] → f32 [m, oc].
    CPU tensor: the plain version.  CUDA tensor: the kernel's arm ``arm``,
    by default `select_arm`'s."""
    if x.device.type == "cpu":
        return pb_select_v1_plain(x, p, dot_dtype)
    _check(x, p, "pb_select_v1")
    if dot_dtype not in _DOT_DTYPES:
        raise ValueError(f"pb_select_v1: dot_dtype {dot_dtype} not in {_DOT_DTYPES}")
    x = x.float().contiguous()
    x = x if x.data_ptr() % 16 == 0 else x.clone()
    return launch_select(x, p, dot_dtype, select_arm(x.shape[0], p) if arm is None else arm)


def launch_select(x: torch.Tensor, p: PackedLinear, dot_dtype, arm: str,
                  scratch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch arm ``arm`` of the select kernel on a checked layer and
    contiguous, 16-byte aligned f32 x on the current stream; counts one
    launch of that arm.  Arm "tc" writes x's terms into ``scratch`` (bf16
    [terms, m, ic], made here when not given) first, in the same call."""
    if arm not in SELECT_ARMS:
        raise ValueError(f"pb_select_v1: arm {arm!r} not in {SELECT_ARMS}")
    m, ic = x.shape
    oc = p.oc_local
    out = torch.empty((m, oc), dtype=torch.float32, device=x.device)
    lib = _build.load("pb_select_v1")
    planes = (p.sign_packed.data_ptr(), p.mask_packed.data_ptr(), p.sidecar.data_ptr(),
              p.low_scale.data_ptr(), p.low_mean.data_ptr(), p.high_scale.data_ptr(),
              p.high_zero.data_ptr(), None if p.bias is None else p.bias.data_ptr())
    shape = (m, ic, oc, p.pack_block_local, p.low_bits, p.sidecar_bits, p.groupsize_local,
             p.n_groups, int(dot_dtype == torch.bfloat16))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    global select_launches, select_tc_launches
    if arm == "cores":
        fn = lib.pb_select_v1
        fn.argtypes = _SELECT_ARGTYPES
        fn.restype = ctypes.c_int
        _build.check(fn(x.data_ptr(), *planes, out.data_ptr(), *shape, stream), "pb_select_v1")
        select_launches += 1
        return out
    if p.sign_packed.data_ptr() % 16 or p.mask_packed.data_ptr() % 16:
        raise ValueError("pb_select_v1 (tc): sign and mask planes must be 16-byte aligned (TMA)")
    terms = bf16_terms.count(select_products(dot_dtype))[0]
    if scratch is None:
        scratch = torch.empty((terms, m, ic), dtype=torch.bfloat16, device=x.device)
    elif scratch.shape != (terms, m, ic) or scratch.dtype != torch.bfloat16:
        raise ValueError(f"pb_select_v1 (tc): scratch {tuple(scratch.shape)} {scratch.dtype}, "
                         f"want {(terms, m, ic)} bf16")
    ksplit = select_ksplit(m, p, torch.cuda.get_device_properties(x.device).multi_processor_count)
    part = torch.empty((ksplit, m, oc), dtype=torch.float32, device=x.device) if ksplit > 1 else None
    fn = lib.pb_select_v1_tc
    fn.argtypes = _SELECT_TC_ARGTYPES
    fn.restype = ctypes.c_int
    _build.check(fn(x.data_ptr(), scratch.data_ptr(), *planes, out.data_ptr(),
                    None if part is None else part.data_ptr(), *shape, ksplit, stream),
                 "pb_select_v1_tc")
    select_tc_launches += 1
    return out
