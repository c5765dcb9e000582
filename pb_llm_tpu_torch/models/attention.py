"""Attention helpers (port of `pb_llm_tpu/models/attention.py` without its
sequence-parallel parts): the no-cache full-sequence dispatch (flash
attention or the masked softmax), causal masking, the KV-cache write and
the cached attention over strip caches or a paged pool
(`runtime.paged_kv`), at a scalar position (prefill, chunk) or a per-slot
position vector [B] (continuous-batching decode, speculative verify).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

Pos = Union[int, torch.Tensor]


def _flash_eligible(q: torch.Tensor) -> bool:
    """"auto" picks flash on the card for windows of 1024 or more and head
    dims divisible by 8, the rule of the JAX package on its chip
    (`_flash_eligible`).  A head dim the kernel cannot take then raises
    from `flash_attention`."""
    t, d = q.shape[1], q.shape[3]
    return t >= 1024 and d % 8 == 0 and q.device.type == "cuda"


def full_causal_attention(q, k, v, scale, window: Optional[int] = None) -> torch.Tensor:
    """No-cache path, q,k,v [B, T, H*, D].  ``window`` (sliding window)
    keeps the masked softmax; otherwise the configured attention arm:
    "flash" the kernel, "flash_interpret" its plain version, "xla" the
    masked softmax, "auto" flash where `_flash_eligible`."""
    from ..ops import kernel_config as _kc

    t = q.shape[1]
    if window is not None:
        return masked_softmax_attention(q, k, v, causal_allowed(0, t, t, None, window, q.device),
                                        scale)
    impl = _kc.current().attention
    if impl == "auto":
        impl = "flash" if _flash_eligible(q) else "xla"
    if impl in ("flash", "flash_interpret"):
        from ..ops import flash_attention as _fa

        hq, hkv = q.shape[2], k.shape[2]
        if hq != hkv:
            k = torch.repeat_interleave(k, hq // hkv, dim=2)
            v = torch.repeat_interleave(v, hq // hkv, dim=2)
        fn = _fa.flash_attention_plain if impl == "flash_interpret" else _fa.flash_attention
        return fn(q, k, v, float(scale), causal=True)
    return masked_softmax_attention(q, k, v, causal_allowed(0, t, t, None, None, q.device), scale)


def causal_allowed(pos: Pos, t: int, s: int, kv_len_valid: Optional[Pos],
                   window: Optional[int] = None, device=None) -> torch.Tensor:
    """Boolean [*, 1, t, s] mask: query i at absolute position pos(+i) sees
    cache rows at or before it, inside the valid length and, with
    ``window``, within the last ``window`` positions."""
    p = torch.as_tensor(pos, device=device)
    dev = p.device
    kpos = torch.arange(s, device=dev)
    if p.dim() == 0:
        qpos = p + torch.arange(t, device=dev)
        allowed = kpos[None, :] <= qpos[:, None]
        if window is not None:
            allowed = allowed & (kpos[None, :] > qpos[:, None] - window)
        if kv_len_valid is not None:
            allowed = allowed & (kpos[None, :] < torch.as_tensor(kv_len_valid, device=dev))
        return allowed[None, None]
    qpos = p[:, None] + torch.arange(t, device=dev)[None, :]
    allowed = kpos[None, None, :] <= qpos[:, :, None]
    if window is not None:
        allowed = allowed & (kpos[None, None, :] > qpos[:, :, None] - window)
    if kv_len_valid is not None:
        kl = torch.as_tensor(kv_len_valid, device=dev)
        allowed = allowed & (kpos[None, None, :] < kl[:, None, None])
    return allowed[:, None]


def masked_softmax_attention(q, k, v, allowed, scale) -> torch.Tensor:
    """q [B,t,Hq,d], k,v [B,s,H,d], allowed [*,1,t,s] → [B,t,Hq,d]; softmax
    in float32."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq != hkv:
        k = torch.repeat_interleave(k, hq // hkv, dim=2)
        v = torch.repeat_interleave(v, hq // hkv, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q * scale, k)
    scores = torch.where(allowed, scores.float(), -torch.inf)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _scatter(buf: torch.Tensor, val: torch.Tensor, p: Pos) -> None:
    """In place: write val [B, t, ...] into buf [B, S, ...] at rows p(+i)
    (p an int, or a [B] tensor of per-slot rows).  The port updates the
    cache in place where JAX returns a new array."""
    t = val.shape[1]
    if isinstance(p, int):
        buf[:, p : p + t] = val.to(buf.dtype)
        return
    b = val.shape[0]
    rows = torch.arange(b, device=buf.device)[:, None]
    cols = p.to(buf.device)[:, None] + torch.arange(t, device=buf.device)[None, :]
    # a slot parked at max_seq-1 (chunked prefill) writes its verify window
    # onto its last row, which no request reads (JAX drops such writes)
    buf[rows, cols.clamp(max=buf.shape[1] - 1)] = val.to(buf.dtype)


def _paged_update(cache: Dict[str, torch.Tensor], k, v, pos: Pos) -> None:
    """In place: k/v [B, t, Hkv, d] into the page pool.  Prefill (a
    "slot_pages" [K, n] entry, scalar pos) writes whole pages; otherwise
    each of a slot's t tokens (t == 1 at decode) looks up its page in the
    table, clamped to the last position (a slot parked at max_seq-1 would
    otherwise index past its table row)."""
    from ..runtime import paged_kv

    if "slot_pages" in cache:
        def write(name, val):
            paged_kv.write_prompts(cache[name], val, cache["slot_pages"])
    else:
        table, page = cache["table"], cache["k_pages"].shape[2]
        p = torch.as_tensor(pos, device=table.device).long()
        ptok = p[:, None] + torch.arange(k.shape[1], device=p.device)[None, :]
        ptok = ptok.clamp(max=table.shape[1] * page - 1)
        ids, off = torch.gather(table, 1, ptok // page).long(), ptok % page

        def write(name, val):
            paged_kv.write_tokens(cache[name], val, ids, off)
    for name, val in (("k", k), ("v", v)):
        if "k_scale_pages" in cache:
            val, scale = quantize_kv(val)
            write(f"{name}_scale_pages", scale[..., 0])
        write(f"{name}_pages", val)


def quantize_kv(val: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absmax int8 per (token, head): scale = max(absmax/127, 1e-8), round
    half to even, clip ±127 (attention.py:234-241)."""
    scale = torch.amax(val.abs(), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    return torch.clamp(torch.round(val / scale), -127, 127), scale


def cache_update(cache: Dict[str, torch.Tensor], k, v, pos: Pos) -> Dict[str, torch.Tensor]:
    """Write k/v [B, t, H, d] into the strip cache [B, S, H, d] at ``pos``,
    or into the paged pool ("k_pages"/"v_pages" + "table", see
    `_paged_update`), in place; returns the same dict.  int8 caches
    ("k_scale"/"v_scale", "k_scale_pages"/"v_scale_pages") are quantized
    on write."""
    if "k_pages" in cache:
        _paged_update(cache, k, v, pos)
        return cache
    p = pos if isinstance(pos, int) else torch.as_tensor(pos, device=cache["k"].device)
    if "k_scale" in cache:
        for name, val in (("k", k), ("v", v)):
            qv, scale = quantize_kv(val)
            _scatter(cache[name], qv, p)
            _scatter(cache[f"{name}_scale"], scale, p)
        return cache
    _scatter(cache["k"], k, p)
    _scatter(cache["v"], v, p)
    return cache


def cached_attention(kv_cache: Dict[str, torch.Tensor], q, k_new, v_new, pos: Pos,
                     scale, window: Optional[int] = None) -> torch.Tensor:
    """Attention over an already-updated cache; q [B, t, Hq, d] →
    [B, t, Hq, d].

    Strip caches: batched single-token decode (vector pos, t == 1, no
    window) takes the decode-attention kernel when the config says so;
    everything else runs the masked softmax over the cache.  Paged pools
    read through the paged-attention kernel (`ops.paged_attention`): a
    chunk or prefix suffix ("chunk_table", scalar pos) and a speculative
    window (vector pos, t > 1) as windows with base = pos, a decode step
    with lengths = pos + 1; one-shot prefill (scalar pos) attends its own
    fresh K/V.  Both kernels bound each slot's read by its own length,
    which replaces the TPU path's power-of-two window switch (a device for
    XLA's static shapes)."""
    if "k_pages" in kv_cache:
        return _paged_attention(kv_cache, q, k_new, v_new, pos, scale, window)
    b, t, hq, d = q.shape
    s = kv_cache["k"].shape[1]
    p = torch.as_tensor(pos, device=q.device)
    if p.dim() == 1 and t == 1 and window is None:
        from ..ops import kernel_config as _kc

        impl = _kc.current().decode_attention
        if impl == "auto":
            impl = "pallas" if q.device.type == "cuda" else "xla"
        if impl in ("pallas", "pallas_q8", "pallas_interpret"):
            from ..ops import decode_attention as _da

            fn = _da.decode_attention_plain if impl == "pallas_interpret" else _da.decode_attention
            out = fn(q[:, 0], kv_cache["k"], kv_cache["v"], p + 1, scale,
                     k_scale=kv_cache.get("k_scale"), v_scale=kv_cache.get("v_scale"),
                     q_int8=impl == "pallas_q8" and "k_scale" in kv_cache)
            return out[:, None].to(q.dtype)
    allowed = causal_allowed(p, t, s, p + t, window)
    ck, cv = cache_kv(kv_cache, q.dtype)
    return masked_softmax_attention(q, ck, cv, allowed, scale)


def _paged_attention(kv_cache, q, k_new, v_new, pos: Pos, scale, window) -> torch.Tensor:
    if window is not None:
        raise NotImplementedError(
            "sliding-window attention requires strip caches — serve Mistral-family models "
            "without --page_size")
    from ..ops import paged_attention as _pa

    kp, vp = kv_cache["k_pages"], kv_cache["v_pages"]
    common = dict(page_size=kp.shape[2], k_scale_pages=kv_cache.get("k_scale_pages"),
                  v_scale_pages=kv_cache.get("v_scale_pages"))
    p = torch.as_tensor(pos, device=q.device)
    if "chunk_table" in kv_cache:
        # chunk continuation / prefix suffix: its rows are in the pages
        # already; attend the slot's whole history through its table row
        out = _pa.paged_attention_multi(q, kp, vp, kv_cache["chunk_table"], p[None], scale,
                                        **common)
    elif p.dim() == 0:  # one-shot prefill: the window is self-contained
        return full_causal_attention(q, k_new, v_new, scale)
    elif q.shape[1] == 1:
        out = _pa.paged_attention(q[:, 0], kp, vp, kv_cache["table"], p + 1, scale,
                                  **common)[:, None]
    else:  # speculative verify: the window's rows are written already
        out = _pa.paged_attention_multi(q, kp, vp, kv_cache["table"], p, scale, **common)
    return out.to(q.dtype)


def cache_kv(cache: Dict[str, torch.Tensor], dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k, v) [B, S, H, d] in compute dtype, dequantizing int8 caches."""
    if "k_scale" in cache:
        k = cache["k"].to(dtype) * cache["k_scale"].to(dtype)
        v = cache["v"].to(dtype) * cache["v_scale"].to(dtype)
        return k, v
    return cache["k"].to(dtype), cache["v"].to(dtype)
