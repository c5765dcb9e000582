"""Slot-based strip KV cache (port of `pb_llm_tpu/runtime/kv_cache.py`):
[n_slots, max_seq, kv_heads, head_dim] per decoder layer; decode runs the
whole pool with inactive slots masked."""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from .. import resolve_device


def make_caches(cfg: Any, n_slots: int, max_seq: int, n_layers: int, kv_heads: int,
                head_dim: int, dtype=torch.float32, device=None) -> List[Dict[str, torch.Tensor]]:
    """dtype torch.int8 → absmax-quantized cache with per-(token, head) f32
    scales (see models.attention.cache_update); torch.bfloat16 or
    torch.float32 → unscaled strips, written with a cast.  ``device``: as every entry
    point, CUDA unless the caller names another (`resolve_device`)."""
    device = resolve_device(device)
    shape = (n_slots, max_seq, kv_heads, head_dim)
    if dtype == torch.int8:
        return [
            {
                "k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3] + (1,), dtype=torch.float32, device=device),
                "v_scale": torch.zeros(shape[:3] + (1,), dtype=torch.float32, device=device),
            }
            for _ in range(n_layers)
        ]
    return [
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(n_layers)
    ]


def cache_spec_for(cfg: Any, family_name: str):
    if family_name == "llama":
        return cfg.num_hidden_layers, cfg.kv_heads, cfg.head_dim
    if family_name == "opt":
        return cfg.num_hidden_layers, cfg.num_attention_heads, cfg.head_dim
    raise NotImplementedError(family_name)


def bytes_per_slot(cfg: Any, family_name: str, max_seq: int, dtype_bytes: int = 4) -> int:
    n_layers, kv_heads, head_dim = cache_spec_for(cfg, family_name)
    return 2 * n_layers * max_seq * kv_heads * head_dim * dtype_bytes
