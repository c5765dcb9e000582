"""The system under test for an OPT configuration: the port's OPT forward
(`pb_llm_tpu_torch.models.opt`) over the benchmark's PBW-v1 planes, each
wrapped as the port's `PackedLinear`."""

from __future__ import annotations

from pb_llm_tpu_torch.core.pbw import PackedLinear
from pb_llm_tpu_torch.models.opt import OPTConfig
from pb_llm_tpu_torch.models.registry import FAMILIES

from ..weights import opt as W
from ..weights.pbw import is_layer

FAMILY = FAMILIES["opt"]


def program_config(cfg: dict) -> OPTConfig:
    return OPTConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"], ffn_dim=cfg["ffn_dim"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        max_position_embeddings=cfg["max_position_embeddings"],
        word_embed_proj_dim=cfg.get("word_embed_proj_dim"),
        do_layer_norm_before=cfg.get("do_layer_norm_before", True))


def program_params(cfg: dict, seed: int, device) -> dict:
    layers = []
    for li in range(cfg["num_hidden_layers"]):
        lp = W.layer(cfg, seed, li, device)
        layers.append({k: PackedLinear(**v) if is_layer(v) else v for k, v in lp.items()})
    outer = W.outer(cfg, seed, device)
    return {"embed_tokens": outer["embed_tokens"], "embed_positions": outer["embed_positions"],
            "layers": layers, "final_layer_norm": outer["final_layer_norm"],
            "project_in": None, "project_out": None}
