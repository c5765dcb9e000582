"""f32 reductions in the order the reference computes them, so calibration
states (means, scales, zero points) come out bit for bit equal.

The JAX package runs its quantizers through XLA on the CPU, which rewrites
every long reduction into a tree: windows of 32 elements summed left to
right, the operand zero-padded to a whole number of windows with the padding
split evenly before and after, repeated on the window sums until 32 or fewer
remain.  A mean is that sum times the f32 reciprocal of the count, a division by
a compile-time constant (the quantizers' maxq, the MSE grid) is a
multiplication by its f32 reciprocal, and a product followed by a sum is
one fused multiply-add (one rounding).  `torch.sum` adds in another
order and differs in the last bit on most rows.
"""

from __future__ import annotations

import numpy as np
import torch

WINDOW = 32


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right f32 sum over the last dim, from 0."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` in the reference's order (see the module docstring)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    while n > WINDOW:
        nb = -(-n // WINDOW)
        pad = nb * WINDOW - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = _sequential_sum(x.reshape(*x.shape[:-1], nb, WINDOW))
        n = nb
    return _sequential_sum(x)


def recip(c: float) -> torch.Tensor:
    """The f32 reciprocal of a constant, as a 0-d tensor."""
    return torch.tensor(np.float32(1.0 / c))


def tree_mean(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return tree_sum(x, dim) * recip(x.shape[dim]).to(x.device)


def fma(a, b, c) -> torch.Tensor:
    """a·b + c in f32 with one rounding: the f32 product is exact in f64,
    so only the f64 sum and the final f32 rounding round."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float64) for v in (a, b, c))
    return (a * b + c).float()
