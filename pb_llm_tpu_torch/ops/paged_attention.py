"""Paged attention: the counterpart of `pb_llm_tpu/ops/paged_attention.py`
(`paged_attention`, `paged_attention_multi` and their `_kernel`).

A query window q [B, t, Hq, D] attends the slot's keys through its page
table: key p lives in page table[b, p // page] at offset p % page of the
head-major pool [P+1, Hkv, page, D]; window row j sees keys p <= base[b] + j
(its own rows are already written).  GQA is grouped: q head i reads kv
head i // G.  Pages are f32, bf16 or int8 (JAX's rule: int8 pages iff
scale pages).  int8 pages carry f32 scale planes [P+1, Hkv, page]: the K
scale multiplies the scores after the dot, the V scale folds into the
probabilities.  q is scaled by ``scale`` here, in f32, before the kernel.
A masked key weighs exactly 0 and a row with no allowed key returns 0.
The output is f32; `models.attention` casts it to q's type, as the TPU
kernel writes q's type for unquantized pages.

Precision: over bf16 pages the TPU kernel dots q in q's type against the
bf16 keys; the kernel and its plain version here widen each bf16 element to
f32 and keep q, p and the sums in f32.

`paged_attention` (decode, t = 1, ``lengths`` including the token just
written) and `paged_attention_multi` (speculative verify, chunked prefill,
prefix-cache suffixes) launch `csrc/paged_attention.cu` on a CUDA tensor and
run `paged_attention_plain` on a CPU tensor.  The source has two arms, and
`window_arm` picks one by a fixed rule: windows (t > 1) over int8 or bf16
pages take the tensor-core arm (q and p split into two bf16 terms each, f32
sums), decode and f32 pages the CUDA-core arm.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_attention import KV_TYPES

NEG_INF = -1e30

# kernel launches (plain-version calls are not counted): all, by entry,
# over bf16 pages, and of the tensor-core window arm
launches = 0
decode_launches = 0
multi_launches = 0
bf16_launches = 0
window_launches = 0

TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"


def _check_args(q, k_pages, v_pages, table, base, page_size, k_scale_pages, v_scale_pages):
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} / pages {tuple(k_pages.shape)} "
                         f"/ {tuple(v_pages.shape)} do not match")
    b, _, hq, d = q.shape
    hkv = k_pages.shape[1]
    if k_pages.shape[2] != page_size or k_pages.shape[3] != d:
        raise ValueError(f"paged_attention: pages {tuple(k_pages.shape)} are not "
                         f"[P+1, Hkv, {page_size}, {d}]")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if table.dim() != 2 or table.shape[0] != b or base.shape != (b,):
        raise ValueError(f"paged_attention: table {tuple(table.shape)} / base "
                         f"{tuple(base.shape)} do not match B={b}")
    quantized = k_scale_pages is not None
    if quantized != (v_scale_pages is not None) or quantized != (k_pages.dtype == torch.int8):
        raise ValueError("int8 pages require k/v scale pages (and vice versa)")
    if quantized and (k_scale_pages.shape != k_pages.shape[:3]
                      or v_scale_pages.shape != k_pages.shape[:3]):
        raise ValueError("paged_attention: scale pages must be [P+1, Hkv, page]")


def paged_attention_plain(q, k_pages, v_pages, table, base, scale, page_size,
                          k_scale_pages=None, v_scale_pages=None) -> torch.Tensor:
    """Plain PyTorch version of the window entry (`paged_attention_multi`'s
    contract), with the kernel's f32 arithmetic: the pages a window may read
    are gathered into dense rows, keys past every row's limit are zeroed
    (never used), the K scale multiplies the scores, the V scale the
    weights, and an empty row returns 0."""
    _check_args(q, k_pages, v_pages, table, base, page_size, k_scale_pages, v_scale_pages)
    b, t, hq, d = q.shape
    hkv = k_pages.shape[1]
    g = hq // hkv
    dev = q.device
    lim = base.to(dev).long()[:, None] + 1 + torch.arange(t, device=dev)[None, :]  # [B, t]
    n = min(table.shape[1], max(1, -(-int(lim.max()) // page_size)))
    tbl = table[:, :n].to(dev).long()
    s = n * page_size
    kpos = torch.arange(s, device=dev)
    valid = kpos[None, :] < lim.max(dim=1).values[:, None]  # [B, S]

    def gather(pages):  # [B, S, Hkv, (D)] in f32, keys past every limit zeroed
        x = pages[tbl].transpose(2, 3).reshape(b, s, hkv, *pages.shape[3:]).float()
        return torch.where(valid.reshape(b, s, *([1] * (x.dim() - 2))), x, 0.0)

    qf = (q.float() * scale).reshape(b, t, hkv, g, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qf, gather(k_pages))
    if k_scale_pages is not None:
        scores = scores * gather(k_scale_pages).permute(0, 2, 1)[:, :, None, None, :]
    allowed = (kpos[None, None, :] < lim[:, :, None])[:, None, None]  # [B, 1, 1, t, S]
    scores = torch.where(allowed, scores, NEG_INF)
    mx = torch.amax(scores, dim=-1, keepdim=True)
    pw = torch.where(allowed, torch.exp(scores - mx), 0.0)
    l = torch.sum(pw, dim=-1, keepdim=True)
    if v_scale_pages is not None:
        pw = pw * gather(v_scale_pages).permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bkgts,bskd->bkgtd", pw, gather(v_pages))
    out = out * torch.where(l == 0.0, 1.0, 1.0 / l)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq, d)


def paged_attention(q, k_pages, v_pages, table, lengths, scale, page_size,
                    k_scale_pages=None, v_scale_pages=None) -> torch.Tensor:
    """Decode: one query token per slot, q [B, Hq, D] (not pre-scaled);
    ``lengths`` [B] counts the token just written.  Returns [B, Hq, D] f32."""
    out = _call(q[:, None], k_pages, v_pages, table, lengths - 1, scale, page_size,
                k_scale_pages, v_scale_pages, decode=True)
    return out[:, 0]


def paged_attention_multi(q, k_pages, v_pages, table, base_lengths, scale, page_size,
                          k_scale_pages=None, v_scale_pages=None) -> torch.Tensor:
    """A window of t rows per slot, q [B, t, Hq, D] (not pre-scaled); row j
    attends keys p <= base_lengths[b] + j, the window's own rows already
    written.  Returns [B, t, Hq, D] f32."""
    return _call(q, k_pages, v_pages, table, base_lengths, scale, page_size,
                 k_scale_pages, v_scale_pages, decode=False)


def _call(q, k_pages, v_pages, table, base, scale, page_size, k_scale_pages, v_scale_pages,
          decode: bool) -> torch.Tensor:
    base = torch.as_tensor(base)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, table, base, scale, page_size,
                                     k_scale_pages, v_scale_pages)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    _check_args(q, k_pages, v_pages, table, base, page_size, k_scale_pages, v_scale_pages)
    d = q.shape[3]
    quantized = k_scale_pages is not None
    if not quantized and k_pages.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_attention: unscaled pages must be float32 or bfloat16, got "
                         f"{k_pages.dtype}")
    if v_pages.dtype != k_pages.dtype:
        raise ValueError(f"paged_attention: k pages are {k_pages.dtype}, v pages {v_pages.dtype}")
    epl = _EPL[k_pages.dtype]
    if d % epl or d > 128:
        raise ValueError(f"paged_attention: head_dim {d} must be at most 128 and a multiple of "
                         f"{epl} for {k_pages.dtype} pages")
    pools = [k_pages, v_pages] + ([k_scale_pages, v_scale_pages] if quantized else [])
    for x in pools:
        if x.device != q.device or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("paged_attention: pages must be contiguous, 16-byte aligned and on "
                             "q's device")
    if quantized and k_scale_pages.dtype != torch.float32:
        raise ValueError("paged_attention: scale pages must be float32")
    if table.dtype not in (torch.int32, torch.int64) or table.device != q.device:
        raise ValueError("paged_attention: the table must be an integer tensor on q's device")
    qs = (q.float() * scale).contiguous()
    tbl = table.to(torch.int32).contiguous()
    bs = base.to(device=q.device, dtype=torch.int32).contiguous()
    return launch(qs, k_pages, v_pages, tbl, bs, k_scale_pages, v_scale_pages, decode=decode)


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
_WINDOW_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# elements of a K row one lane reads in one 16-byte load
_EPL = {torch.int8: 16, torch.bfloat16: 8, torch.float32: 4}


def _tiling(rows: int):
    """(rows a warp carries, log2 of the warps splitting one row group's
    keys): short windows give all 8 warps the same rows and split the keys,
    long ones give each warp 8 rows of a 64-row block."""
    if rows <= 8:
        return 1 << (rows - 1).bit_length(), 3
    groups = min(8, 1 << (-(-rows // 8) - 1).bit_length())
    return 8, 3 - (groups.bit_length() - 1)


def window_arm(t: int, dtype: torch.dtype) -> str:
    """The arm a launch takes: windows (t > 1) over int8 or bf16 pages on
    the tensor cores, decode and f32 pages on the CUDA cores."""
    return TENSOR_CORES if t > 1 and dtype in (torch.int8, torch.bfloat16) else CUDA_CORES


def launch(qs, k_pages, v_pages, table, base, k_scale_pages=None, v_scale_pages=None,
           decode: bool = False, _arm_for_timing=None) -> torch.Tensor:
    """Launch the CUDA kernel on checked operands (q already scaled, int32
    table and base) on the current stream; the arm follows `window_arm`.
    ``_arm_for_timing`` forces one arm, only so that chip_smoke.py and the
    card tests can time and check both on the same inputs.  Counts one
    launch."""
    b, t, hq, d = qs.shape
    hkv, ps = k_pages.shape[1], k_pages.shape[2]
    quantized = k_scale_pages is not None
    arm = _arm_for_timing or window_arm(t, k_pages.dtype)
    out = torch.empty((b, t, hq, d), dtype=torch.float32, device=qs.device)
    lib = _build.load("paged_attention")
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    pages = (qs.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             k_scale_pages.data_ptr() if quantized else None,
             v_scale_pages.data_ptr() if quantized else None,
             table.data_ptr(), base.data_ptr(), out.data_ptr(), b, t, hq, hkv, d, ps,
             table.shape[1], KV_TYPES[k_pages.dtype])
    if arm == TENSOR_CORES:
        fn = lib.paged_attention_window
        fn.argtypes = _WINDOW_ARGTYPES
        fn.restype = ctypes.c_int
        err = fn(*pages, stream)
    else:
        rw, wk_log2 = _tiling(t * (hq // hkv))
        fn = lib.paged_attention
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        err = fn(*pages, rw, wk_log2, stream)
    _build.check(err, "paged_attention")
    global launches, decode_launches, multi_launches, bf16_launches, window_launches
    launches += 1
    bf16_launches += k_pages.dtype == torch.bfloat16
    window_launches += arm == TENSOR_CORES
    if decode:
        decode_launches += 1
    else:
        multi_launches += 1
    return out
