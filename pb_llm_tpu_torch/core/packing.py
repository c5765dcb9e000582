"""Bitplane packing for PBW (port of `pb_llm_tpu/core/packing.py`).

Block-local bit-plane-major layout: rows are grouped into pack blocks of
``block_rows`` rows (the last may be shorter, any multiple of 32).  Within
a block of ``r`` rows (``g = r // 32`` words), bit ``b`` of ``words[gi, :]``
holds block-row ``b * g + gi``.

torch's ``uint32`` supports few operations, so packed words live in
``int32`` tensors that are bit-identical views of the uint32 words (numpy
``.view(np.int32)`` / ``.view(np.uint32)`` converts losslessly).  Right
shifts on int32 are arithmetic — bit 31 sign-extends — so every shift is
followed by a mask.
"""

from __future__ import annotations

import torch

WORD_BITS = 32
PACK_BLOCK = 256


def _check_rows(ic: int) -> int:
    if ic % WORD_BITS != 0:
        raise ValueError(f"packing requires ic % 32 == 0, got ic={ic}")
    return ic // WORD_BITS


def block_sizes(ic: int, block_rows: int = PACK_BLOCK):
    """Row counts of each independently-packed block (last may be shorter)."""
    sizes = []
    while ic > 0:
        sizes.append(min(ic, block_rows))
        ic -= sizes[-1]
    return sizes


def default_pack_block(ic: int, cap: int = 2048) -> int:
    """Largest multiple-of-32 divisor of ic not exceeding ``cap``."""
    best = 32
    for r in range(32, min(ic, cap) + 1, 32):
        if ic % r == 0:
            best = r
    return best


def _to_int32_bits(words64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 with the same 32-bit pattern."""
    return torch.where(words64 >= 2**31, words64 - 2**32, words64).to(torch.int32)


def pack_bits(bits: torch.Tensor, block_rows: int = PACK_BLOCK) -> torch.Tensor:
    """Pack a {0,1} matrix [ic, oc] into int32 words [ic//32, oc]."""
    ic, oc = bits.shape
    _check_rows(ic)
    bits = bits.to(torch.int64)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device).reshape(WORD_BITS, 1, 1)
    chunks, st = [], 0
    for r in block_sizes(ic, block_rows):
        g = r // WORD_BITS
        b3 = bits[st : st + r].reshape(WORD_BITS, g, oc)
        chunks.append(_to_int32_bits(torch.sum(b3 << shifts, dim=0)))
        st += r
    return torch.cat(chunks, dim=0)


def unpack_bits(words: torch.Tensor, ic: int, block_rows: int = PACK_BLOCK) -> torch.Tensor:
    """Inverse of :func:`pack_bits` → int32 {0,1} matrix [ic, oc]."""
    gtot, oc = words.shape
    if gtot * WORD_BITS != ic:
        raise ValueError(f"word rows {gtot} inconsistent with ic={ic}")
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device).reshape(WORD_BITS, 1, 1)
    chunks, st = [], 0
    for r in block_sizes(ic, block_rows):
        g = r // WORD_BITS
        rows = (words[st : st + g][None, :, :] >> shifts) & 1  # mask: shift is arithmetic
        chunks.append(rows.reshape(r, oc))
        st += g
    return torch.cat(chunks, dim=0)


def pack_nibbles(codes: torch.Tensor, block_rows: int = PACK_BLOCK) -> torch.Tensor:
    """Pack 4-bit codes [ic, oc] into uint8 [ic//2, oc]: within a block of r
    rows (h = r//2), nibble j (0=low, 1=high) of byte-row g holds row j*h+g."""
    ic, oc = codes.shape
    if ic % 2:
        raise ValueError("nibble packing requires even ic")
    codes = codes.to(torch.uint8)
    chunks, st = [], 0
    for r in block_sizes(ic, block_rows):
        h = r // 2
        blk = codes[st : st + r]
        chunks.append(blk[:h] | (blk[h:] << 4))
        st += r
    return torch.cat(chunks, dim=0)


def unpack_nibbles(bytes_arr: torch.Tensor, ic: int, block_rows: int = PACK_BLOCK) -> torch.Tensor:
    chunks, st = [], 0
    for r in block_sizes(ic, block_rows):
        h = r // 2
        blk = bytes_arr[st : st + h]
        chunks.append(torch.cat([blk & 0xF, (blk >> 4) & 0xF], dim=0))
        st += h
    return torch.cat(chunks, dim=0)
