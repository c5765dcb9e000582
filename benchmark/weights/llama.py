"""Random weights of a llama-family model (Llama, Mistral) from the run's
seed: every decoder linear a PBW-v2 layer (`pbw.random_v2`, global salient
selection), unit RMSNorm weights, f32 embeddings and lm_head N(0, 0.02).
Layer ``li`` comes from its own generator, so the plain reference can make
one layer again at a time."""

from __future__ import annotations

import torch

from . import generator
from .pbw import random_v2

LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def kv_heads(cfg: dict) -> int:
    return cfg.get("num_key_value_heads") or cfg["num_attention_heads"]


def shapes(cfg: dict) -> dict:
    """(ic, oc) of each decoder linear."""
    h, ffn = cfg["hidden_size"], cfg["intermediate_size"]
    qo, kv = cfg["num_attention_heads"] * head_dim(cfg), kv_heads(cfg) * head_dim(cfg)
    return {"q_proj": (h, qo), "k_proj": (h, kv), "v_proj": (h, kv), "o_proj": (qo, h),
            "gate_proj": (h, ffn), "up_proj": (h, ffn), "down_proj": (ffn, h)}


def layer(cfg: dict, seed: int, li: int, device) -> dict:
    fmt = cfg["assumed"]["weights"]
    gen = generator(device, seed, "layer", li)
    h = cfg["hidden_size"]
    lp = {"input_layernorm": torch.ones(h, device=device),
          "post_attention_layernorm": torch.ones(h, device=device)}
    for name, (ic, oc) in shapes(cfg).items():
        lp[name] = random_v2(ic, oc, gen, low_frac=fmt["low_frac"], col_tile=fmt["col_tile"],
                             side_bits=fmt["side_bits"])
    return lp


def outer(cfg: dict, seed: int, device) -> dict:
    """Everything outside the decoder layers."""
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    gen = generator(device, seed, "outer")
    return {"embed_tokens": torch.randn(v, h, generator=gen, device=device) * 0.02,
            "norm": torch.ones(h, device=device),
            "lm_head": torch.randn(h, v, generator=gen, device=device) * 0.02}
