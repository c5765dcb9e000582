"""Timing and roofline accounting for the packed kernels (port of
`pb_llm_tpu/utils/profiling.py`).

  * `sync_time` — wall time of a call, completed by a
    `torch.cuda.synchronize` when its result lies on the card;
  * `Roofline` / `pb_roofline` — the bytes / operations model of a PBW
    matmul, JAX's fields and formulas, so that a measured time reads as a
    share of its bound.  The defaults are the H100 SXM's (PERF.md §3):
    ``hbm_gbps`` 3350 GB/s of HBM3; the ``mxu_tflops`` slot (JAX: the TPU's
    matrix unit) holds the tensor cores' 989 TFLOP/s dense bf16; the
    ``vpu_tops`` slot (JAX: the vector unit) the CUDA cores' 67 TFLOP/s f32;
  * `trace` — a `torch.profiler` trace (CUDA activity where a card is
    present), written into ``logdir`` as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable

import torch

H100_HBM_GBPS = 3350.0
H100_BF16_TFLOPS = 989.0
H100_F32_TFLOPS = 67.0


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for v in out:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync_time(fn: Callable, *args) -> tuple[float, object]:
    """Wall time of fn(*args), synchronized on the card when its first
    tensor result lies there."""
    t0 = time.perf_counter()
    out = fn(*args)
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return time.perf_counter() - t0, out


@dataclasses.dataclass(frozen=True)
class Roofline:
    bytes_weights: float
    bytes_activations: float
    flops: float
    vpu_ops: float

    def time_bound_s(self, hbm_gbps: float = H100_HBM_GBPS, mxu_tflops: float = H100_BF16_TFLOPS,
                     vpu_tops: float = H100_F32_TFLOPS) -> float:
        return max(
            (self.bytes_weights + self.bytes_activations) / (hbm_gbps * 1e9),
            self.flops / (mxu_tflops * 1e12),
            self.vpu_ops / (vpu_tops * 1e12),
        )


def pb_roofline(m: int, ic: int, oc: int, sidecar_bits: int = 8, planes: int = 2,
                ops_per_elem: float = 7.0) -> Roofline:
    """Roofline model of the fused PB matmul (bp2 layout: sign + mask
    planes + dense uint8 sidecar), JAX's formulas."""
    n = ic * oc
    return Roofline(
        bytes_weights=n * (planes * 1 + sidecar_bits) / 8,
        bytes_activations=(m * ic + m * oc) * 4.0,
        flops=2.0 * m * n * (3 if planes == 2 else 1),  # planar decomposition: B', M, V dots
        vpu_ops=n * ops_per_elem,
    )


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with `torch.profiler` (CPU activity, and CUDA where
    a card is present); the Chrome trace is written to
    ``logdir/trace.json`` and the profiler is yielded (its
    ``key_averages()`` name the ops)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
