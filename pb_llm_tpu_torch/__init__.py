"""PyTorch + CUDA port of `pb_llm_tpu` for NVIDIA Hopper (H100).

The JAX package is the reference; this package mirrors its layout
(`core/`, `ops/`, `models/`, `runtime/`, `cli/`, `data/`) so each module's
counterpart is found by name.  It imports torch, numpy and the standard
library only — never jax, never `pb_llm_tpu`.

Kernels are hand-written CUDA C++ under `csrc/`, built with nvcc at first
use (`ops._build`).  Every kernel wrapper runs its plain PyTorch version on
a CPU tensor and launches the kernel (or raises) on a CUDA tensor.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """Full-f32 matmuls on the card inside the block (TF32 keeps ~3 digits);
    the caller's setting comes back afterwards.  The parity paths (hybrid
    prefill, calibration) run under it, as the reference disables TF32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Without CUDA and without an explicit device this raises — the
    port never falls back to the CPU silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev
