"""Flash attention over whole windows (port of `pb_llm_tpu/ops/
flash_attention.py`): causal or full attention with an online softmax and
f32 statistics, for the no-cache path (`models.attention.
full_causal_attention`: eval and perplexity windows).

q, k, v arrive as [B, T, H, D] with equal head counts (callers repeat GQA
heads first).  Keys at or past ``kv_len`` (default: all of k) and, when
causal, keys after the query are masked with NEG_INF = -1e30 and weigh 0, so
a row with no allowed key gives 0, not NaN.  ``dots_bf16`` rounds q, k, v and
the softmax weights to bf16 before the two products; sums and statistics
stay f32.  ``return_residuals`` adds the per-row running max m and
normalizer l as [B, T, H] f32.

`flash_attention` launches the CUDA kernel (`csrc/flash_attention.cu`) on
CUDA tensors and runs `flash_attention_plain` — the same function in plain
PyTorch, scores materialized — on CPU tensors.  The kernel has two arms
(`flash_arm`): "tc", the bf16 tensor cores with q, k, p and v in bf16
terms (`FLASH_TERMS`), takes every call; "cores", the f32 CUDA cores, only
a call that names it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import no_tf32
from . import _build, bf16_terms

NEG_INF = -1e30
MAX_HEAD_DIM = 128

ARMS = ("tc", "cores")
# Arm "tc": the products it issues, in order, without dots_bf16: (q term, k
# term) for S, each in three bf16 terms (`bf16_terms.split`), and (p term,
# v term) for P.V, each in two.  The fewest whose CPU emulation keeps out, l
# and the running max m within a third of their bounds
# (tests/test_torch_tc_terms.py).  dots_bf16 issues (0, 0) alone in both.
FLASH_TERMS = (((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)), ((1, 0), (0, 1), (0, 0)))

launches = 0  # launches of the kernel's arm "cores" (plain-version calls not counted)
tc_launches = 0  # launches of its arm "tc"


def _allowed(t: int, s: int, kv_len: int, causal: bool, device) -> torch.Tensor:
    kpos = torch.arange(s, device=device)
    allowed = (kpos < kv_len)[None, :].expand(t, s)
    if causal:
        allowed = allowed & (kpos[None, :] <= torch.arange(t, device=device)[:, None])
    return allowed


def flash_attention_plain(q, k, v, scale: float, causal: bool = True,
                          kv_len: Optional[int] = None, dots_bf16: bool = False,
                          return_residuals: bool = False):
    """Plain PyTorch version of the kernel: the same masked softmax with the
    scores materialized; output in q's dtype."""
    b, t, h, d = q.shape
    s = k.shape[1]
    kv_len = s if kv_len is None else kv_len
    dt = torch.bfloat16 if dots_bf16 else torch.float32
    qf, kf, vf = (a.to(dt).float() for a in (q, k, v))
    allowed = _allowed(t, s, kv_len, causal, q.device)
    with no_tf32():
        sc = torch.einsum("bthd,bshd->bhts", qf, kf) * scale
        sc = torch.where(allowed, sc, NEG_INF)
        m = torch.amax(sc, dim=-1)
        p = torch.where(allowed, torch.exp(sc - m[..., None]), 0.0)
        l = torch.sum(p, dim=-1)
        acc = torch.einsum("bhts,bshd->bthd", p.to(dt).float(), vf)
    inv = torch.where(l == 0.0, 1.0, 1.0 / l).permute(0, 2, 1)[..., None]
    out = (acc * inv).to(q.dtype)
    if return_residuals:
        return out, m.permute(0, 2, 1), l.permute(0, 2, 1)
    return out


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
_TC_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def flash_arm(arm: Optional[str] = None) -> str:
    """The kernel's arm: "tc" unless a call names "cores"."""
    if arm is None:
        return "tc"
    if arm not in ARMS:
        raise ValueError(f"flash_attention: arm {arm!r} not in {ARMS}")
    return arm


def tc_products(dots_bf16: bool) -> tuple:
    """The (S, P.V) products arm "tc" issues."""
    return (((0, 0),), ((0, 0),)) if dots_bf16 else FLASH_TERMS


def tc_scratch(b: int, t: int, s: int, h: int, d: int, dots_bf16: bool):
    """Shapes of arm "tc"'s bf16 terms: q [QT, B·H, T, DP], k [KT, B·H, S,
    DP], v transposed [VT, B·H, DP, Sp]; DP = 64 for d <= 64, else 128; Sp =
    s rounded up to 8."""
    (qt, kt), (_, vt) = (bf16_terms.count(pr) for pr in tc_products(dots_bf16))
    dp, sp = 64 if d <= 64 else 128, -(-s // 8) * 8
    return (qt, b * h, t, dp), (kt, b * h, s, dp), (vt, b * h, dp, sp)


def tc_terms_plain(q, k, v, dots_bf16: bool = False):
    """Plain version of arm "tc"'s preparation: the three scratch tensors of
    `tc_scratch` as its first launch writes them."""
    b, t, h, d = q.shape
    s = k.shape[1]
    shapes = tc_scratch(b, t, s, h, d, dots_bf16)
    dp = shapes[0][3]
    out = []
    for i, (x, shape) in enumerate(zip((q, k, v), shapes)):
        x = torch.nn.functional.pad(x.float().permute(0, 2, 1, 3), (0, dp - d))
        x = x.reshape(b * h, -1, dp)
        if i == 2:  # v transposed, keys padded with zeros to Sp
            x = torch.nn.functional.pad(x.transpose(1, 2), (0, shape[3] - s))
        out.append(bf16_terms.split(x, shape[0]))
    return tuple(out)


def flash_attention(q, k, v, scale: float, causal: bool = True, kv_len: Optional[int] = None,
                    dots_bf16: bool = False, return_residuals: bool = False,
                    arm: Optional[str] = None, scratch=None):
    """q [B, T, H, D], k/v [B, S, H, D] → [B, T, H, D] in q's dtype (and m,
    l [B, T, H] f32 with ``return_residuals``).  CPU tensors: the plain
    version.  CUDA tensors: the kernel's arm `flash_arm(arm)`; arm "tc"
    writes its terms into ``scratch`` (`tc_scratch`'s three bf16 tensors,
    made here when not given) first, in the same call."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal, kv_len, dots_bf16, return_residuals)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, t, h, d = q.shape
    s = k.shape[1]
    kv_len = s if kv_len is None else kv_len
    if k.shape != (b, s, h, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} need equal batch, heads and head_dim")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must lie on one device")
    if d % 4 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {d} must be a multiple of 4, at most "
                         f"{MAX_HEAD_DIM}")
    if not 0 <= kv_len <= s:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside [0, {s}]")
    arm = flash_arm(arm)
    qf, kf, vf = (a.float().contiguous() for a in (q, k, v))
    out = torch.empty_like(qf)
    stats = [torch.empty((b, t, h), dtype=torch.float32, device=q.device)
             for _ in range(2)] if return_residuals else [None, None]
    lib = _build.load("flash_attention")
    ptrs = (qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
            None if stats[0] is None else stats[0].data_ptr(),
            None if stats[1] is None else stats[1].data_ptr())
    args = (b, t, s, h, d, kv_len, int(causal), int(dots_bf16), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    global launches, tc_launches
    if arm == "cores":
        fn = lib.flash_attention
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _build.check(fn(*ptrs, *args), "flash_attention")
        launches += 1
    else:
        shapes = tc_scratch(b, t, s, h, d, dots_bf16)
        if scratch is None:
            scratch = [torch.empty(sh, dtype=torch.bfloat16, device=q.device) for sh in shapes]
        elif [tuple(x.shape) for x in scratch] != list(shapes) or any(
                x.dtype != torch.bfloat16 or not x.is_contiguous() for x in scratch):
            raise ValueError(f"flash_attention (tc): scratch must be contiguous bf16 {shapes}")
        fn = lib.flash_attention_tc
        fn.argtypes = _TC_ARGTYPES
        fn.restype = ctypes.c_int
        _build.check(fn(*ptrs, *(x.data_ptr() for x in scratch), *args), "flash_attention_tc")
        tc_launches += 1
    out = out.to(q.dtype)
    return (out, stats[0], stats[1]) if return_residuals else out
