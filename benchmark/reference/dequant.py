"""Dense f32 weights [ic, oc] from the planes as the benchmark made them
(`benchmark/weights/pbw.py`), by this file's own reading of the PBW v1 and
v2 layouts.  Plain torch; nothing of the port."""

from __future__ import annotations

import torch


def unpack_bits(words: torch.Tensor, ic: int, block_rows: int) -> torch.Tensor:
    """int32 words [ic // 32, oc] → {0, 1} f32 [ic, oc]: within a pack block
    of r rows (g = r // 32 words), bit b of word row gi is block row b·g + gi."""
    oc = words.shape[1]
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)[:, None, None]
    out, st, row = [], 0, 0
    while row < ic:
        r = min(block_rows, ic - row)
        g = r // 32
        bits = (words[st : st + g][None] >> shifts) & 1  # [32, g, oc]: row b·g + gi
        out.append(bits.reshape(r, oc).float())
        st, row = st + g, row + r
    return torch.cat(out, dim=0)


def unpack_nibbles(b: torch.Tensor, ic: int, block_rows: int) -> torch.Tensor:
    """uint8 [ic // 2, oc] → codes [ic, oc]: in a block of r rows (h = r//2),
    the low nibble of byte row g is row g, the high nibble row h + g."""
    out, st, row = [], 0, 0
    while row < ic:
        r = min(block_rows, ic - row)
        blk = b[st : st + r // 2]
        out += [blk & 0xF, (blk >> 4) & 0xF]
        st, row = st + r // 2, row + r
    return torch.cat(out, dim=0)


def parts_v2(p: dict):
    """PBW v2 (1-bit lows) as W = W_off + W_cen, f32 [ic, oc] each: the
    centred part is what the int8 arms multiply by rounded x (2·scale·bit
    at the binary rows, hs·(code − 128) at the salient rows; 4-bit codes
    hs·code), the offset part what they multiply by exact x through their
    row sums (low_mean − scale at the binary rows, hs·(128 − hz) or −hs·hz
    at the salient rows).  Salient rows of each row
    group and shard come from side_idx (the pad index ic_s marks an empty
    slot)."""
    if p["low_bits"] != 1:
        raise NotImplementedError("the reference reads 1-bit lows only")
    ic, oc, ct = p["ic"], p["oc"], p["col_tile"]
    kps = p["k_pad_shard"]
    shards = p["side_idx"].shape[0] // kps
    ic_s = ic // shards
    bits = unpack_bits(p["sign_packed"], ic, min(p["pack_block"], ic_s))
    scale, mean = p["low_scale"][0], p["low_mean"][0]
    w_cen = 2.0 * scale * bits
    w_off = (mean - scale).expand(ic, oc).clone()
    codes = p["side_val"]
    if p["side_bits"] == 4:  # shard segment of kps/2 packed rows: slots r and r + kps/2
        c = codes.reshape(shards, kps // 2, oc)
        codes = torch.cat([c & 0xF, (c >> 4) & 0xF], dim=1).reshape(shards * kps, oc)
    mid = 128.0 if p["side_bits"] == 8 else 0.0  # 8-bit codes enter offset-binary, 4-bit as they are
    hs, hz = p["high_scale"], p["high_zero"]
    cen, off = hs * (codes.float() - mid), hs * (mid - hz)  # [k_pad, oc], [oc]
    for t in range(p["side_idx"].shape[1]):
        cols = slice(t * ct, min((t + 1) * ct, oc))
        for s in range(shards):
            idx = p["side_idx"][s * kps : (s + 1) * kps, t].long()
            rows = s * ic_s + idx[idx < ic_s]
            w_cen[rows, cols] = cen[s * kps : (s + 1) * kps][idx < ic_s][:, cols]
            w_off[rows, cols] = off[cols]
    return w_off, w_cen


def dense_v2(p: dict) -> torch.Tensor:
    w_off, w_cen = parts_v2(p)
    return w_off + w_cen


def dense_v1(p: dict) -> torch.Tensor:
    """PBW v1 (1-bit lows): salient where the mask bit is set."""
    if p["low_bits"] != 1:
        raise NotImplementedError("the reference reads 1-bit lows only")
    ic, gs = p["ic"], p["groupsize"]
    pb = min(p["pack_block"], ic)
    mask = unpack_bits(p["mask_packed"], ic, pb) > 0
    bits = unpack_bits(p["sign_packed"], ic, pb)
    rows = torch.arange(ic, device=bits.device) // min(gs, ic)
    w_lo = p["low_mean"][rows] + (2.0 * bits - 1.0) * p["low_scale"][rows]
    codes = p["sidecar"] if p["sidecar_bits"] == 8 else unpack_nibbles(p["sidecar"], ic, pb)
    w_hi = p["high_scale"] * (codes.float() - p["high_zero"])
    return torch.where(mask, w_hi, w_lo)


def dense(p: dict) -> dict:
    """A layer for the reference: {"w": f32 [ic, oc], "b": f32 [oc] | None};
    a v2 layer as its two parts {"w_off", "w_cen"} (`parts_v2`) instead of
    "w", so that its input can be rounded where the int8 arms round it."""
    if "side_idx" in p:
        w_off, w_cen = parts_v2(p)
        return {"w_off": w_off, "w_cen": w_cen, "b": p["bias"]}
    return {"w": dense_v1(p), "b": p["bias"]}
