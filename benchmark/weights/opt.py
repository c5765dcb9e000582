"""Random weights of an OPT model from the run's seed: every decoder linear
a PBW-v1 layer with a random bias (`pbw.random_v1`, element-wise salient
mask, whole-row scales), unit LayerNorms with zero bias, f32 token and
position embeddings N(0, 0.02), the lm_head tied to the token embedding.
Layer ``li`` comes from its own generator."""

from __future__ import annotations

import torch

from . import generator
from .pbw import random_v1

LINEARS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
POS_OFFSET = 2  # OPTLearnedPositionalEmbedding's offset


def head_dim(cfg: dict) -> int:
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def kv_heads(cfg: dict) -> int:
    return cfg["num_attention_heads"]


def shapes(cfg: dict) -> dict:
    h, ffn = cfg["hidden_size"], cfg["ffn_dim"]
    return {"q_proj": (h, h), "k_proj": (h, h), "v_proj": (h, h), "out_proj": (h, h),
            "fc1": (h, ffn), "fc2": (ffn, h)}


def _ln(h: int, device) -> dict:
    return {"w": torch.ones(h, device=device), "b": torch.zeros(h, device=device)}


def layer(cfg: dict, seed: int, li: int, device) -> dict:
    fmt = cfg["assumed"]["weights"]
    gen = generator(device, seed, "layer", li)
    h = cfg["hidden_size"]
    lp = {"self_attn_layer_norm": _ln(h, device), "final_layer_norm": _ln(h, device)}
    for name, (ic, oc) in shapes(cfg).items():
        lp[name] = random_v1(ic, oc, gen, low_frac=fmt["low_frac"], groupsize=fmt["groupsize"],
                             sidecar_bits=fmt["sidecar_bits"], bias=True)
    return lp


def outer(cfg: dict, seed: int, device) -> dict:
    if cfg.get("word_embed_proj_dim", cfg["hidden_size"]) != cfg["hidden_size"]:
        raise ValueError("word_embed_proj_dim must equal hidden_size (no project_in/out)")
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    gen = generator(device, seed, "outer")
    return {"embed_tokens": torch.randn(v, h, generator=gen, device=device) * 0.02,
            "embed_positions": torch.randn(cfg["max_position_embeddings"] + POS_OFFSET, h,
                                           generator=gen, device=device) * 0.02,
            "final_layer_norm": _ln(h, device)}
