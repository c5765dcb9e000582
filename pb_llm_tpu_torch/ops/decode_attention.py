"""Strip-cache decode attention: the counterpart of
`pb_llm_tpu/ops/decode_attention.py` (`decode_attention` + its `_kernel`).

One query token per slot over the strip cache [B, S, Hkv, D], GQA
(Hq = G·Hkv), rows s < lengths[b] (the token just written included), online
softmax in f32.  The arms follow the cache's type, as the TPU kernel's do:

  * f32 or bf16 strips, no scales (the TPU kernel's unquantized branch);
  * int8 strips: the per-(token, head) K scale multiplies the scores and
    the V scale folds into the probabilities before the PV sum;
  * ``q_int8`` over int8 strips (`KernelConfig.decode_attention=
    "pallas_q8"`): q (scaled) is absmax-quantized per (slot, head) as JAX
    does, ``qsc = max(max|q|, 1e-30) / 127`` and codes
    ``clip(round_half_even(q / qsc), ±127)`` (`quantize_q`, bit for bit
    with JAX); the scores are exact int32 dots of the codes against the
    uncast int8 keys, then ``(s · kscale) · qsc`` in f32; the V side is the
    int8 arm's.

Precision: the TPU kernel rounds q to bf16 in its bf16 and int8 dots (a bf16
Qbd scratch) and p to bf16 before its PV dots; the port keeps q and p in f32
in every arm, in the kernel and in its plain version.  The q8 arm rounds q
to int8 codes on both.

Arms of the kernel (`csrc/decode_attention.cu`; every cache type in each):
"split" (the default): each slot's rows cut into splits of SPLIT_ROWS, one
block a (split, slot, head), the splits merged in order by a second
launch; the split count follows the cache's max_seq alone, so a captured
step's grid holds for every length.  "slot": one block a (slot, head),
online softmax row by row (the first design, kept as the yardstick).
`split_plain` is the split arm's arithmetic in plain PyTorch.

`decode_attention` launches the kernel on a CUDA tensor and runs
`decode_attention_plain` on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30

# kernel launches (plain-version calls are not counted): all arms, the split
# arm, and the q8 and bf16 cache arms on their own
launches = 0
split_launches = 0
q8_launches = 0
bf16_launches = 0

ARMS = ("split", "slot")
SPLIT_ROWS = 64  # rows a split (csrc/decode_attention.cu: GROUPS * STEPS)


# the kernel's cache-type codes (csrc/decode_attention.cu, csrc/paged_attention.cu)
KV_TYPES = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}
# elements of a row one lane reads: 16 bytes a load (two for f32)
_EPL = {torch.int8: 16, torch.bfloat16: 8, torch.float32: 8}


def _check_args(q, k, v, lengths, k_scale, v_scale):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale go together")
    b, hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} / k {tuple(k.shape)} "
                         f"/ v {tuple(v.shape)} do not match")
    if hq % k.shape[2]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[2]}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [B]={b}, got {tuple(lengths.shape)}")


def quantize_q(qs: torch.Tensor):
    """The q8 arm's q codes, as JAX makes them from the scaled f32 q
    [B, Hq, D]: (int8 codes, f32 qsc [B, Hq]) with qsc = max(max|q|, 1e-30)
    / 127 and codes clip(round_half_even(q / qsc), -127, 127)."""
    qsc = torch.clamp(qs.abs().amax(dim=-1), min=1e-30) / 127.0
    return torch.clamp(torch.round(qs / qsc[..., None]), -127, 127).to(torch.int8), qsc


def decode_attention_plain(q, k, v, lengths, scale, *, k_scale=None, v_scale=None,
                           q_int8=False):
    """Plain PyTorch version: same contract and the same f32 arithmetic as
    the kernel (scores scaled by k_scale, p scaled by v_scale, rows past a
    slot's length carry zero weight, empty slots return zeros; with
    ``q_int8`` the scores are the int8 codes' dots, exact in f32, times
    k_scale, then times qsc)."""
    _check_args(q, k, v, lengths, k_scale, v_scale)
    q_int8 = q_int8 and k_scale is not None
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    valid = torch.arange(s, device=q.device)[None, :] < lengths.to(q.device)[:, None]  # [B, S]

    def rows(t):  # [B, S, Hkv, X] in f32 with rows past each length zeroed (never read)
        return torch.where(valid[:, :, None, None], t.float(), 0.0)

    qf = q.float() * scale
    if q_int8:
        qf, qsc = quantize_q(qf)
        # products of int8 codes summed in f32: exact below 2**24 (|s| <= 127²·D)
        qf = qf.float()
    scores = torch.einsum("bkgd,bskd->bkgs", qf.reshape(b, hkv, g, d), rows(k))
    if k_scale is not None:
        scores = scores * rows(k_scale).reshape(b, s, hkv).permute(0, 2, 1)[:, :, None, :]
    if q_int8:
        scores = scores * qsc.reshape(b, hkv, g)[..., None]
    allowed = valid[:, None, None, :]
    scores = torch.where(allowed, scores, NEG_INF)
    mx = torch.amax(scores, dim=-1, keepdim=True)
    pw = torch.where(allowed, torch.exp(scores - mx), 0.0)
    l = torch.sum(pw, dim=-1, keepdim=True)
    if v_scale is not None:
        pw = pw * rows(v_scale).reshape(b, s, hkv).permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bkgs,bskd->bkgd", pw, rows(v))
    out = out / torch.where(l == 0.0, 1.0, l)
    return out.reshape(b, hq, d)


def split_plain(q, k, v, lengths, scale, *, k_scale=None, v_scale=None, q_int8=False,
                split_rows=SPLIT_ROWS):
    """The split arm's arithmetic in plain PyTorch (f32): per split of
    ``split_rows`` rows its max m_c, exponential sum l_c and unnormalised
    P·V (p scaled by v_scale), then the merge in split order: out =
    Σ_c w_c·acc_c / Σ_c w_c·l_c, w_c = exp(m_c − max m); empty slots zeros."""
    _check_args(q, k, v, lengths, k_scale, v_scale)
    q_int8 = q_int8 and k_scale is not None
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float() * scale
    if q_int8:
        qc, qsc = quantize_q(qf)
        qf = qc.float()
    lens = lengths.to(q.device).long()
    out = torch.zeros((b, hq, d), dtype=torch.float32, device=q.device)
    for bi in range(b):
        n = min(int(lens[bi]), s)
        if n == 0:
            continue
        parts = []
        for r0 in range(0, n, split_rows):
            r1 = min(r0 + split_rows, n)
            kk = k[bi, r0:r1].float().repeat_interleave(g, dim=1)          # [r, hq, d]
            vv = v[bi, r0:r1].float().repeat_interleave(g, dim=1)
            sc = torch.einsum("hd,rhd->hr", qf[bi], kk)
            if k_scale is not None:
                sc = sc * k_scale[bi, r0:r1, :, 0].float().repeat_interleave(g, dim=1).t()
            if q_int8:
                sc = sc * qsc[bi][:, None]
            mx = sc.amax(dim=1)
            pw = torch.exp(sc - mx[:, None])
            l = pw.sum(dim=1)
            if v_scale is not None:
                pw = pw * v_scale[bi, r0:r1, :, 0].float().repeat_interleave(g, dim=1).t()
            parts.append((mx, l, torch.einsum("hr,rhd->hd", pw, vv)))
        top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        lt = torch.zeros_like(top)
        acc = torch.zeros((hq, d), dtype=torch.float32, device=q.device)
        for mx, l, a in parts:
            w = torch.exp(mx - top)
            lt = lt + w * l
            acc = acc + w[:, None] * a
        out[bi] = acc / lt[:, None]
    return out


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_SPLIT_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def decode_attention(q, k, v, lengths, scale, *, k_scale=None, v_scale=None,
                     q_int8=False, arm: str = "split"):
    """Batched single-token decode attention over a strip cache.

    q: [B, Hq, D] — NOT pre-scaled (``scale`` is folded in here).
    k, v: [B, S, Hkv, D] int8 with k_scale/v_scale [B, S, Hkv, 1] f32, or
      f32 or bf16 without scales.
    q_int8: the q8 arm, q quantized per (slot, head); as in JAX it takes
      effect over int8 caches only.
    lengths: [B] int — rows s < lengths[b] are attended (the just-written
      token included); the kernel reads no row past a slot's own length.
    arm: the kernel's arm on a CUDA tensor, "split" or "slot" (`ARMS`).
    Returns [B, Hq, D] float32.  CPU tensor: the plain version; CUDA tensor:
    the kernel."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, scale, k_scale=k_scale,
                                      v_scale=v_scale, q_int8=q_int8)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if arm not in ARMS:
        raise ValueError(f"decode_attention: unknown arm {arm!r}, not in {ARMS}")
    _check_args(q, k, v, lengths, k_scale, v_scale)
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    quantized = k_scale is not None
    q_int8 = q_int8 and quantized
    if quantized and k.dtype != torch.int8:
        raise ValueError("decode_attention: scaled caches must be int8")
    if not quantized and k.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_attention: unscaled caches must be float32 or bfloat16, "
                         f"got {k.dtype}")
    if v.dtype != k.dtype:
        raise ValueError(f"decode_attention: k is {k.dtype}, v is {v.dtype}")
    epl = _EPL[k.dtype]
    if d % epl or d > 32 * epl:
        raise ValueError(f"decode_attention: head_dim {d} must be a multiple of {epl} "
                         f"and at most {32 * epl} for a {k.dtype} cache")
    tensors = [k, v] + ([k_scale, v_scale] if quantized else [])
    for t in tensors:
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("decode_attention: cache tensors must be contiguous, 16-byte "
                             "aligned and on q's device")
    if quantized and (k_scale.dtype != torch.float32 or k_scale.shape != (b, s, hkv, 1)):
        raise ValueError("decode_attention: scales must be f32 [B, S, Hkv, 1]")
    qs = (q.float() * scale).contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    return launch(qs, k, v, lens, k_scale, v_scale, q_int8=q_int8, arm=arm)


def launch(qs, k, v, lens, k_scale=None, v_scale=None, q_int8=False,
           arm: str = "split") -> torch.Tensor:
    """Launch the CUDA kernel's ``arm`` on checked operands (q already
    scaled, int32 lengths) on the current stream; the cache arm follows k's
    type and ``q_int8``; counts one launch (the split arm's two kernels are
    one launch of the arm)."""
    b, hq, d = qs.shape
    s, hkv = k.shape[1], k.shape[2]
    quantized = k_scale is not None
    lpr_log2 = max(0, (d // _EPL[k.dtype] - 1).bit_length())  # lanes a row: 2**lpr_log2
    out = torch.empty((b, hq, d), dtype=torch.float32, device=qs.device)
    lib = _build.load("decode_attention")
    stream = torch.cuda.current_stream(qs.device).cuda_stream
    scales = (k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None)
    if arm == "split":
        ns = -(-s // SPLIT_ROWS)
        part = torch.empty((b, hq, ns, d), dtype=torch.float32, device=qs.device)
        part_ml = torch.empty((b, hq, ns, 2), dtype=torch.float32, device=qs.device)
        fn = lib.decode_attention_split
        fn.argtypes = _SPLIT_ARGTYPES
        fn.restype = ctypes.c_int
        err = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), *scales, lens.data_ptr(),
                 out.data_ptr(), part.data_ptr(), part_ml.data_ptr(), b, s, hq, hkv, d,
                 KV_TYPES[k.dtype], int(q_int8), lpr_log2, stream)
    elif arm == "slot":
        fn = lib.decode_attention
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        err = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), *scales, lens.data_ptr(),
                 out.data_ptr(), b, s, hq, hkv, d, KV_TYPES[k.dtype], int(q_int8), lpr_log2,
                 stream)
    else:
        raise ValueError(f"decode_attention: unknown arm {arm!r}, not in {ARMS}")
    _build.check(err, f"decode_attention ({arm})")
    global launches, split_launches, q8_launches, bf16_launches
    launches += 1
    split_launches += arm == "split"
    q8_launches += bool(q_int8)
    bf16_launches += k.dtype == torch.bfloat16
    return out
