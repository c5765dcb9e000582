"""Ring sequence-parallel causal attention (port of `pb_llm_tpu/parallel/
ring_attention.py`).

The sequence axis is cut into ``sp`` blocks, one a rank of an ``sp`` mesh
(`parallel.mesh.make_sp_mesh`); K/V blocks travel around the ring
(`parallel.collectives.ppermute`, one hop a step) while each rank merges
the per-block softmax states of its own queries: running max m,
normalizer l and the unnormalized accumulator, all f32, exactly as JAX's
``step``.  No rank holds more than a [T/sp, T/sp] block of scores.

Block kinds, by the origin j of the K/V block a rank i holds: j < i is a
full (non-causal) block, j == i the causal diagonal, j > i lies above the
diagonal and contributes (-1e30, 0, 0), which the merge leaves unchanged,
so it is skipped (the port is eager; JAX switches on a traced index).  The
diagonal block comes first, so every row's m is finite before a skip.

The per-block attention (``inner``): "xla", the masked softmax at global
positions (JAX's `_block_attend`); "flash", the flash kernel with its (m,
l) residuals (`ops.flash_attention`, ``return_residuals=True``; acc =
out · l, JAX's `_flash_block`); "flash_interpret", its plain version;
"auto", flash where `models.attention._flash_eligible` holds for the LOCAL
block, else "xla".

`ring_attention` takes a rank's local blocks [B, T/sp, H, D];
`ring_attention_global` takes the whole [B, T, H, D] on every rank (JAX's
signature), raises on a T that sp does not divide, and gathers the result.
GQA callers repeat K/V heads first.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from .. import no_tf32
from .collectives import ppermute

NEG_INF = -1e30
INNERS = ("auto", "xla", "flash", "flash_interpret")


def _block_attend(q, k, v, qpos0: int, kpos0: int, scale: float):
    """One q block against one k/v block → (m, l, acc) f32 [B, Tl, H, 1],
    [B, Tl, H, 1], [B, Tl, H, D], causally masked at GLOBAL positions."""
    with no_tf32():
        s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * scale
        qpos = qpos0 + torch.arange(q.shape[1], device=q.device)
        kpos = kpos0 + torch.arange(k.shape[1], device=q.device)
        allowed = (kpos[None, :] <= qpos[:, None])[None, :, None, :]
        s = torch.where(allowed, s, NEG_INF)
        m = torch.amax(s, dim=3, keepdim=True)
        p = torch.where(allowed, torch.exp(s - m), 0.0)
        l = torch.sum(p, dim=3, keepdim=True)
        acc = torch.einsum("bqhk,bkhd->bqhd", p, v.float())
    return m, l, acc


def _flash_block(q, k, v, scale: float, causal: bool, plain: bool):
    """(m, l, acc) of one block from the flash kernel's residuals (or its
    plain version): acc = out · l un-normalizes the output for the merge."""
    from ..ops import flash_attention as _fa

    fn = _fa.flash_attention_plain if plain else _fa.flash_attention
    out, m, l = fn(q, k, v, scale, causal=causal, return_residuals=True)
    return m[..., None], l[..., None], out.float() * l[..., None]


def _resolve_inner(inner: str, q: torch.Tensor) -> str:
    if inner not in INNERS:
        raise ValueError(f"ring_attention: inner {inner!r} not in {INNERS}")
    if inner == "auto":
        from ..models.attention import _flash_eligible

        return "flash" if _flash_eligible(q) else "xla"
    return inner


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, mesh,
                   axis: str = "sp", inner: str = "auto") -> torch.Tensor:
    """A rank's local blocks q, k, v [B, T/sp, H, D] (block i of the
    sequence on the rank at index i of ``mesh``'s ``axis``) → its block of
    the causal attention output, in q's dtype.  Every rank of the axis must
    call it together."""
    n, i = mesh.shape[axis], mesh.coord(axis)
    group = getattr(mesh, "group", None)
    b, tl, h, d = q.shape
    inner = _resolve_inner(inner, q)
    m = torch.full((b, tl, h, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, tl, h, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, tl, h, d), dtype=torch.float32, device=q.device)
    kc, vc = k, v
    for s in range(n):
        j = (i - s) % n  # origin block of the K/V held now
        if j <= i:
            if inner == "xla":
                mb, lb, ab = _block_attend(q, kc, vc, i * tl, j * tl, scale)
            else:
                mb, lb, ab = _flash_block(q, kc, vc, scale, causal=j == i,
                                          plain=inner == "flash_interpret")
            m_new = torch.maximum(m, mb)
            alpha, beta = torch.exp(m - m_new), torch.exp(mb - m_new)
            l = alpha * l + beta * lb
            acc = alpha * acc + beta * ab
            m = m_new
        if s < n - 1:  # every rank passes its block on, in every step
            kc, vc = ppermute(kc, group), ppermute(vc, group)
    l_inv = torch.where(l == 0.0, 1.0, 1.0 / l)
    return (acc * l_inv).to(q.dtype)


def local_rows(x: torch.Tensor, mesh, axis: str = "sp", dim: int = 1) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (the sequence); a length
    the axis does not divide raises ValueError."""
    n = mesh.shape[axis]
    t = x.shape[dim]
    if t % n:
        raise ValueError(f"T {t} not divisible by {axis}={n}")
    return x.narrow(dim, mesh.coord(axis) * (t // n), t // n)


def gather_rows(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """Every rank's block of ``x`` joined along ``dim`` in rank order."""
    group = getattr(mesh, "group", None)
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if n == 1:
        return x
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def ring_attention_global(q, k, v, scale: float, mesh, axis: str = "sp",
                          inner: str = "auto") -> torch.Tensor:
    """JAX's signature: q, k, v [B, T, H, D] whole on every rank → the
    whole [B, T, H, D] output on every rank (each computes its block)."""
    blocks = [local_rows(a, mesh, axis) for a in (q, k, v)]
    return gather_rows(ring_attention(*blocks, scale, mesh, axis, inner), mesh)
