"""The system under test for a llama-family configuration: the port's
llama forward (`pb_llm_tpu_torch.models.llama`, which Mistral rides) over
the benchmark's PBW-v2 planes, each wrapped as the port's `PackedLinearV2`."""

from __future__ import annotations

from pb_llm_tpu_torch.core.pbw import PackedLinearV2
from pb_llm_tpu_torch.models.llama import LlamaConfig
from pb_llm_tpu_torch.models.registry import FAMILIES

from ..weights import llama as W
from ..weights.pbw import is_layer

FAMILY = FAMILIES["llama"]


def program_config(cfg: dict) -> LlamaConfig:
    return LlamaConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"], num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg.get("num_key_value_heads"),
        max_position_embeddings=cfg["max_position_embeddings"],
        rms_norm_eps=cfg["rms_norm_eps"], rope_theta=cfg.get("rope_theta", 10000.0),
        sliding_window=cfg.get("sliding_window"),
        head_dim_override=(cfg.get("head_dim") if cfg.get("head_dim") not in
                           (None, cfg["hidden_size"] // cfg["num_attention_heads"]) else None))


def program_params(cfg: dict, seed: int, device) -> dict:
    layers = []
    for li in range(cfg["num_hidden_layers"]):
        lp = W.layer(cfg, seed, li, device)
        layers.append({k: PackedLinearV2(**v) if is_layer(v) else v for k, v in lp.items()})
    outer = W.outer(cfg, seed, device)
    return {"embed_tokens": outer["embed_tokens"], "layers": layers, "norm": outer["norm"],
            "lm_head": {"w": outer["lm_head"], "b": None}}
