"""The kernel wrappers' launch counters, by name.

Each wrapper keeps its count as a plain integer in its own module (for
example `packed_matmul.launches`) and adds one where it launches its
kernel, and nowhere else.  This registry names them all, so that what reads
or restores them (`runtime.step_graph`, which replays launches without
running the wrappers, and the smoke run's launch checks) cannot drift from
the wrappers.

``KERNELS`` holds one counter per kernel or arm: a run's launches by kind.
``TOTALS`` holds the wrappers' sums over arms, kept for the tests.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

# name: (module under pb_llm_tpu_torch.ops, attribute)
KERNELS: Dict[str, Tuple[str, str]] = {
    "pb_int8_matmul": ("packed_matmul", "launches"),  # the dp4a arm
    "pb_int8_matmul_tc": ("packed_matmul", "tc_launches"),  # the tensor-core arm
    "pb_int8_matmul_split": ("packed_matmul", "split_launches"),  # tensor cores, K split (decode)
    "decode_attention": ("decode_attention", "launches"),  # both arms
    "decode_attention_split": ("decode_attention", "split_launches"),  # the split arm
    "pb_dequant_v2": ("prefill", "launches"),
    "pb_f32_matmul": ("packed_matmul", "f32_launches"),  # the CUDA-core arm
    "pb_f32_matmul_tc": ("packed_matmul", "f32_tc_launches"),  # the bf16 tensor-core arm
    "flash_attention": ("flash_attention", "launches"),  # the CUDA-core arm
    "flash_attention_tc": ("flash_attention", "tc_launches"),  # the bf16 tensor-core arm
    "paged_attention_decode": ("paged_attention", "decode_launches"),
    "paged_attention_multi": ("paged_attention", "multi_launches"),
    "pb_planar_v1": ("packed_matmul_v1", "planar_launches"),  # the CUDA-core arm
    "pb_planar_v1_tc": ("packed_matmul_v1", "planar_tc_launches"),  # the bf16 tensor-core arm
    "pb_select_v1": ("packed_matmul_v1", "select_launches"),  # the CUDA-core arm
    "pb_select_v1_tc": ("packed_matmul_v1", "select_tc_launches"),  # the bf16 tensor-core arm
    "pb_pair_v2": ("decode_arms", "pair_launches"),  # the mma.sync arm
    "pb_pair_v2_split": ("decode_arms", "pair_split_launches"),  # wgmma, K split over blocks
    "pb_pair_v2_tc": ("decode_arms", "pair_tc_launches"),  # wgmma
    "pb_dma_v2": ("decode_arms", "dma_launches"),  # the CUDA-core arm
    "pb_dma_v2_split": ("decode_arms", "dma_split_launches"),  # bf16 tensor cores, K split
    "pb_prep_dma": ("packed_matmul", "split_prep_launches"),  # dma / f32 "split"'s x preparation
    "pb_int8_matmul_stacked": ("packed_matmul", "stacked_launches"),  # dp4a
    "pb_int8_matmul_stacked_tc": ("packed_matmul", "stacked_tc_launches"),
    "pb_int8_matmul_stacked_split": ("packed_matmul", "stacked_split_launches"),
    "pb_f32_matmul_stacked": ("packed_matmul", "stacked_f32_launches"),
    "pb_f32_matmul_stacked_tc": ("packed_matmul", "stacked_f32_tc_launches"),
    "decode_attention_q8": ("decode_attention", "q8_launches"),
    "decode_attention_bf16": ("decode_attention", "bf16_launches"),
    "paged_attention_bf16": ("paged_attention", "bf16_launches"),
    "pb_prep_int8": ("packed_matmul", "prep_launches"),
    "paged_attention_window": ("paged_attention", "window_launches"),
    "paged_attention_split": ("paged_attention", "split_launches"),  # the decode arm "split"
    "paged_attention_cuda_cores": ("paged_attention", "cores_launches"),  # the CUDA-core arm
    "pb_f32_matmul_split": ("packed_matmul", "f32_split_launches"),  # dma's split device code
    "pb_f32_matmul_stacked_split": ("packed_matmul", "stacked_f32_split_launches"),
}
TOTALS: Dict[str, Tuple[str, str]] = {
    "paged_attention": ("paged_attention", "launches"),
}
_ALL = {**KERNELS, **TOTALS}


def _module(name: str):
    return importlib.import_module(f"{__package__}.{name}")


def read(totals: bool = False) -> Dict[str, int]:
    """Every kernel's count (and the totals, with ``totals``)."""
    reg = _ALL if totals else KERNELS
    return {k: getattr(_module(m), a) for k, (m, a) in reg.items()}


def zero() -> None:
    for m, a in _ALL.values():
        setattr(_module(m), a, 0)


def restore(snapshot: Dict[str, int]) -> None:
    """Set the counters named in ``snapshot`` to its values."""
    for k, v in snapshot.items():
        m, a = _ALL[k]
        setattr(_module(m), a, v)


def add(delta: Dict[str, int]) -> None:
    """Add ``delta``'s counts (a replayed graph's launches)."""
    for k, v in delta.items():
        if v:
            m, a = _ALL[k]
            mod = _module(m)
            setattr(mod, a, getattr(mod, a) + v)
