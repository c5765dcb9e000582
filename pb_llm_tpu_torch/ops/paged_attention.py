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
run `paged_attention_plain` on a CPU tensor.  The source has three arms, and
`window_arm` picks one by a fixed rule: decode (t = 1) takes DECODE_ARM,
"split" (a slot's keys cut into splits of whole pages, `split_keys`, one
block a split over a grid fixed by the table's width, `n_splits`, and a
merge launch that adds the splits in order; `split_plain` is its
arithmetic in PyTorch, `SPLIT_GRID` blocks a slot and kv head each taking
every SPLIT_GRID-th split), wherever G = Hq / Hkv <= SPLIT_MAX_ROWS and the
head dim is a multiple of 8 (the kernel also takes windows of t·G <=
SPLIT_MAX_ROWS rows a kv head, reached only by name for timing); windows (t > 1) over int8 or bf16 pages take the
tensor-core arm (q and p split into two bf16 terms each, f32 sums); the
CUDA-core arm takes the rest and stays reachable for decode as the
yardstick the split arm replaced.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_attention import KV_TYPES

NEG_INF = -1e30

# kernel launches (plain-version calls are not counted): all, by entry,
# over bf16 pages, and by arm: tensor-core windows, split, CUDA cores
launches = 0
decode_launches = 0
multi_launches = 0
bf16_launches = 0
window_launches = 0
split_launches = 0
cores_launches = 0

TENSOR_CORES, CUDA_CORES, SPLIT = "tensor_cores", "cuda_cores", "split"
ARMS = (SPLIT, TENSOR_CORES, CUDA_CORES)
# The decode arm (t = 1) where the split arm takes the shape; "split" is
# the redesign for the card (PERF.md: both arms in one call, and 6b's pass
# i in turns), CUDA_CORES the yardstick.
DECODE_ARM = SPLIT
# The split arm's shape, from the card (scripts/torch_paged_split_variants.py
# times it beside (64, 4), (64, 8), (128, 2), (128, 8), (256, 4), (256, 8)
# on the decode cases, PERF.md).
SPLIT_KEYS = 128  # keys a split: SPLIT_KEYS // page whole pages (one page above it)
SPLIT_GRID = 4    # blocks a (slot, kv head): block c takes splits c, c + SPLIT_GRID, ...
SPLIT_MAX_ROWS = 8  # window rows t·G a kv head the split arm takes (decode: G <= 8)


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


def split_keys(page_size: int) -> int:
    """Keys a split of the decode arm "split": whole pages, SPLIT_KEYS //
    page of them (128 keys in 8 pages of 16), or one page above SPLIT_KEYS."""
    return page_size * max(1, SPLIT_KEYS // page_size)


def n_splits(table_width: int, page_size: int) -> int:
    """The split arm's splits a slot: its grid and workspace follow the
    table's width (max_seq) alone, never the lengths."""
    return -(-table_width * page_size // split_keys(page_size))


def split_plain(q, k_pages, v_pages, table, lengths, scale, page_size, k_scale_pages=None,
                v_scale_pages=None) -> torch.Tensor:
    """The split arm's arithmetic in plain PyTorch (f32), decode's contract
    (q [B, Hq, D] not pre-scaled, ``lengths`` counting the token just
    written): each slot's keys below its length cut into splits of
    `split_keys` keys; per split its max m_c, exponential sum l_c and
    unnormalised P·V (the K scale on the scores, the V scale on p); then the
    merge in split order, out = Σ_c w_c·acc_c / Σ_c w_c·l_c with w_c =
    exp(m_c − max m); a slot with no key returns 0.  Only live keys are
    gathered: nothing at or past a slot's length is read."""
    base = torch.as_tensor(lengths).to(q.device) - 1
    _check_args(q[:, None], k_pages, v_pages, table, base, page_size, k_scale_pages,
                v_scale_pages)
    b, hq, d = q.shape
    hkv = k_pages.shape[1]
    g = hq // hkv
    sk = split_keys(page_size)
    qf = q.float() * scale
    lens = torch.clamp(base + 1, min=0).long().clamp(max=table.shape[1] * page_size)
    out = torch.zeros((b, hq, d), dtype=torch.float32, device=q.device)
    for bi in range(b):
        n = int(lens[bi])
        parts = []
        for k0 in range(0, n, sk):
            key = torch.arange(k0, min(k0 + sk, n), device=q.device)
            pg = table[bi].to(q.device).long()[key // page_size]
            off = key % page_size

            def rows(pages):  # [keys, Hq, (D)] in f32: each kv head's rows for its G heads
                x = pages[pg, :, off].float()
                return x.repeat_interleave(g, dim=1)

            sc = torch.einsum("hd,khd->hk", qf[bi], rows(k_pages))
            if k_scale_pages is not None:
                sc = sc * rows(k_scale_pages).t()
            mx = sc.amax(dim=1)
            pw = torch.exp(sc - mx[:, None])
            l = pw.sum(dim=1)
            if v_scale_pages is not None:
                pw = pw * rows(v_scale_pages).t()
            parts.append((mx, l, torch.einsum("hk,khd->hd", pw, rows(v_pages))))
        if not parts:
            continue
        top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        lt = torch.zeros_like(top)
        acc = torch.zeros((hq, d), dtype=torch.float32, device=q.device)
        for mx, l, a in parts:
            w = torch.exp(mx - top)
            lt = lt + w * l
            acc = acc + w[:, None] * a
        out[bi] = acc / lt[:, None]
    return out


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
_SPLIT_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
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


def split_ok(rows: int, head_dim: int) -> bool:
    """The shapes the arm "split" takes: t·G window rows a kv head (decode:
    G = Hq / Hkv) up to SPLIT_MAX_ROWS, the head dim a multiple of 8 up to
    128."""
    return rows <= SPLIT_MAX_ROWS and head_dim % 8 == 0 and head_dim <= 128


def window_arm(t: int, dtype: torch.dtype, group: int = 1, head_dim: int = 128) -> str:
    """The arm a launch takes, by a fixed rule: decode (t = 1) DECODE_ARM
    where `split_ok`; windows (t > 1) over int8 or bf16 pages the tensor
    cores; the CUDA cores the rest.  ``group`` is Hq / Hkv."""
    if t == 1:
        return DECODE_ARM if split_ok(group, head_dim) else CUDA_CORES
    return TENSOR_CORES if dtype in (torch.int8, torch.bfloat16) else CUDA_CORES


def launch(qs, k_pages, v_pages, table, base, k_scale_pages=None, v_scale_pages=None,
           decode: bool = False, _arm_for_timing=None) -> torch.Tensor:
    """Launch the CUDA kernel on checked operands (q already scaled, int32
    table and base) on the current stream; the arm follows `window_arm`.
    ``_arm_for_timing`` forces one arm, only so that chip_smoke.py and the
    card tests can time and check every arm on the same inputs.  Counts one
    launch."""
    b, t, hq, d = qs.shape
    hkv, ps = k_pages.shape[1], k_pages.shape[2]
    quantized = k_scale_pages is not None
    arm = _arm_for_timing or window_arm(t, k_pages.dtype, hq // hkv, d)
    if arm not in ARMS:
        raise ValueError(f"paged_attention: unknown arm {arm!r}, not in {ARMS}")
    out = torch.empty((b, t, hq, d), dtype=torch.float32, device=qs.device)
    lib = _build.load("paged_attention")
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    pages = (qs.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             k_scale_pages.data_ptr() if quantized else None,
             v_scale_pages.data_ptr() if quantized else None,
             table.data_ptr(), base.data_ptr(), out.data_ptr(), b, t, hq, hkv, d, ps,
             table.shape[1], KV_TYPES[k_pages.dtype])
    if arm == SPLIT:
        if not split_ok(t * (hq // hkv), d):
            raise ValueError(f"paged_attention: the split arm takes t·G <= {SPLIT_MAX_ROWS} rows "
                             f"a kv head and a head dim a multiple of 8 up to 128; got t={t}, "
                             f"G={hq // hkv}, D={d}")
        maxp = table.shape[1]
        # sized by the table's width alone: a captured step's workspace holds at every length
        part = torch.empty((b, t, hq, n_splits(maxp, ps), d + 2), dtype=torch.float32,
                           device=qs.device)
        fn = lib.paged_attention_split
        fn.argtypes = _SPLIT_ARGTYPES
        fn.restype = ctypes.c_int
        err = fn(*pages[:8], part.data_ptr(), b, t, hq, hkv, d, ps, maxp,
                 KV_TYPES[k_pages.dtype], split_keys(ps), SPLIT_GRID, stream)
    elif arm == TENSOR_CORES:
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
    global split_launches, cores_launches
    launches += 1
    bf16_launches += k_pages.dtype == torch.bfloat16
    window_launches += arm == TENSOR_CORES
    split_launches += arm == SPLIT
    cores_launches += arm == CUDA_CORES
    if decode:
        decode_launches += 1
    else:
        multi_launches += 1
    return out
