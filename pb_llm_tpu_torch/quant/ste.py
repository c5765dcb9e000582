"""Straight-through estimators (port of `pb_llm_tpu/quant/ste.py`): each a
`torch.autograd.Function` whose backward is the JAX package's `custom_vjp`
bwd, formula for formula.

  ste_sign     fwd sign(x), bwd identity
  irnet_sign   fwd sign(x), bwd k·t·(1−tanh²(t·x))
  fda_sign     fwd sign(x), bwd 4ω/π·Σ_{i=0..n} cos((2i+1)ωx), ω = 0.1,
               zeroed outside [−1, 1]
  ste_round_clamp  fwd round+clamp, bwd identity

The gradient goes to x alone; sign(0) is 0, as `jnp.sign(0)`.
"""

from __future__ import annotations

import math

import torch


class _SteSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.sign(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _IrnetSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, t):
        ctx.save_for_backward(x)
        ctx.k, ctx.t = k, t
        return torch.sign(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return ctx.k * ctx.t * (1.0 - torch.tanh(x * ctx.t) ** 2) * g, None, None


class _FdaSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.save_for_backward(x)
        ctx.n = n
        return torch.sign(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        omega = 0.1
        series = sum(torch.cos((2 * i + 1) * omega * x) for i in range(ctx.n + 1))
        grad = 4 * omega / math.pi * series * g
        grad = torch.where((x > 1) | (x < -1), 0.0, grad)
        return grad, None


class _SteRoundClamp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        return torch.clamp(torch.round(x), lo, hi)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def ste_sign(x: torch.Tensor) -> torch.Tensor:
    return _SteSign.apply(x)


def irnet_sign(x: torch.Tensor, k: float = 10.0, t: float = 0.1) -> torch.Tensor:
    return _IrnetSign.apply(x, k, t)


def fda_sign(x: torch.Tensor, n: int = 10) -> torch.Tensor:
    return _FdaSign.apply(x, n)


def ste_round_clamp(x: torch.Tensor, lo, hi) -> torch.Tensor:
    return _SteRoundClamp.apply(x, lo, hi)
