"""f32 values as sums of bf16 terms, for the bf16 tensor-core arms of the
select matmul (`packed_matmul_v1`) and flash attention.

`split` makes the terms the kernels make (t0 = bf16(x), t1 = bf16(x − t0),
…: each the nearest-even rounding of what the earlier terms left, each
remainder exact in f32).  Three terms sum to x exactly for |x| ≥ 2^-100;
one is bf16(x), the plain versions' rounding for a bf16 dot.
"""

from __future__ import annotations

import torch


def split(x: torch.Tensor, n: int) -> torch.Tensor:
    """f32 x → bf16 [n, *x.shape]."""
    out, r = [], x.float()
    for _ in range(n):
        t = r.to(torch.bfloat16)
        out.append(t)
        r = r - t.float()
    return torch.stack(out)


def count(products) -> tuple:
    """(terms of the first operand, terms of the second) that a product
    list ((i, j), …) reads."""
    return (1 + max(i for i, _ in products), 1 + max(j for _, j in products))
