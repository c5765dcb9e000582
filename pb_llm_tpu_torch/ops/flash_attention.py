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
PyTorch, scores materialized — on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import no_tf32
from . import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 128

launches = 0  # kernel launches of flash_attention (plain-version calls not counted)


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


def flash_attention(q, k, v, scale: float, causal: bool = True, kv_len: Optional[int] = None,
                    dots_bf16: bool = False, return_residuals: bool = False):
    """q [B, T, H, D], k/v [B, S, H, D] → [B, T, H, D] in q's dtype (and m,
    l [B, T, H] f32 with ``return_residuals``).  CPU tensors: the plain
    version.  CUDA tensors: the kernel."""
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
    qf, kf, vf = (a.float().contiguous() for a in (q, k, v))
    out = torch.empty_like(qf)
    stats = [torch.empty((b, t, h), dtype=torch.float32, device=q.device)
             for _ in range(2)] if return_residuals else [None, None]
    fn = _build.load("flash_attention").flash_attention
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
             None if stats[0] is None else stats[0].data_ptr(),
             None if stats[1] is None else stats[1].data_ptr(),
             b, t, s, h, d, kv_len, int(causal), int(dots_bf16), float(scale),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    global launches
    launches += 1
    out = out.to(q.dtype)
    return (out, stats[0], stats[1]) if return_residuals else out
