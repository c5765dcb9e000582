"""Frozen copy of the port's bit-plane packing (`core/packing.py`):
block-local, bit-plane-major.  Rows are grouped into pack blocks of
``block_rows`` rows (the last may be shorter); within a block of ``r`` rows
(``g = r // 32`` words), bit ``b`` of ``words[gi, :]`` holds block row
``b * g + gi``.  Words live in int32 tensors with the uint32 bit pattern."""

from __future__ import annotations

import torch

WORD_BITS = 32


def block_sizes(ic: int, block_rows: int):
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


def pack_bits(bits: torch.Tensor, block_rows: int) -> torch.Tensor:
    """{0, 1} [ic, oc] → int32 words [ic // 32, oc]."""
    ic, oc = bits.shape
    if ic % WORD_BITS:
        raise ValueError(f"packing requires ic % 32 == 0, got ic={ic}")
    bits = bits.to(torch.int64)
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device).reshape(WORD_BITS, 1, 1)
    chunks, st = [], 0
    for r in block_sizes(ic, block_rows):
        g = r // WORD_BITS
        words = torch.sum(bits[st : st + r].reshape(WORD_BITS, g, oc) << shifts, dim=0)
        chunks.append(torch.where(words >= 2**31, words - 2**32, words).to(torch.int32))
        st += r
    return torch.cat(chunks, dim=0)


def pack_nibbles(codes: torch.Tensor, block_rows: int) -> torch.Tensor:
    """4-bit codes [ic, oc] → uint8 [ic // 2, oc]: within a block of r rows
    (h = r // 2), nibble j (0 low, 1 high) of byte row g holds row j·h + g."""
    codes = codes.to(torch.uint8)
    chunks, st = [], 0
    for r in block_sizes(codes.shape[0], block_rows):
        h = r // 2
        blk = codes[st : st + r]
        chunks.append(blk[:h] | (blk[h:] << 4))
        st += r
    return torch.cat(chunks, dim=0)
