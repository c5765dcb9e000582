"""OPT forward in plain PyTorch (port of `pb_llm_tpu/models/opt.py`).

HF `OPTForCausalLM` numerics: learned positional embeddings with the +2
offset, pre-LayerNorm blocks (statistics in float32), ReLU MLP, q-scaled
attention, optional project_in / project_out (word_embed_proj_dim ≠
hidden), the final LayerNorm, and an lm_head tied to ``embed_tokens``.
Params are a plain dict; every linear is a `models.linear` leaf (dense
dict, PackedLinear or PackedLinearV2).  Layers run unrolled (``layers``)
or as a loop over stacked layers (``layers_stacked``, `models.stacking`); a
layer may carry the fused ``qkv_proj`` linear (`models.fusion`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from .attention import cache_update, cached_attention, full_causal_attention
from . import stacking
from .linear import apply_linear


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    word_embed_proj_dim: Optional[int] = None
    do_layer_norm_before: bool = True
    layer_norm_eps: float = 1e-5
    head_dim_override: Optional[int] = None

    @property
    def embed_dim(self) -> int:
        return self.word_embed_proj_dim or self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.hidden_size // self.num_attention_heads

    @property
    def seqlen(self) -> int:
        return self.max_position_embeddings

    @classmethod
    def from_hf(cls, hf) -> "OPTConfig":
        """From an HF config: a `transformers` config object, or a namespace
        made from ``config.json`` with its class defaults filled in
        (`models.hf_import.hf_config`)."""
        return cls(
            vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            ffn_dim=hf.ffn_dim,
            num_hidden_layers=hf.num_hidden_layers,
            num_attention_heads=hf.num_attention_heads,
            max_position_embeddings=hf.max_position_embeddings,
            word_embed_proj_dim=getattr(hf, "word_embed_proj_dim", None),
            do_layer_norm_before=hf.do_layer_norm_before,
        )


LINEAR_NAMES = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
POS_OFFSET = 2  # OPTLearnedPositionalEmbedding offset


def init_params(cfg: OPTConfig, generator: torch.Generator, device=None,
                dtype=torch.float32) -> Dict[str, Any]:
    """Random-init dense params (shapes mirror HF): N(0, 0.02) weights and
    embeddings, zero biases, unit LayerNorms, drawn on the generator's
    device and placed on ``device`` (default: CUDA)."""
    device = resolve_device(device)

    def normal(*shape):
        return (torch.randn(*shape, generator=generator, dtype=dtype,
                            device=generator.device) * 0.02).to(device)

    def lin(ic, oc, bias=True):
        return {"w": normal(ic, oc),
                "b": torch.zeros(oc, dtype=dtype, device=device) if bias else None}

    def ln(dim):
        return {"w": torch.ones(dim, dtype=dtype, device=device),
                "b": torch.zeros(dim, dtype=dtype, device=device)}

    h, ffn = cfg.hidden_size, cfg.ffn_dim
    layers = [{"self_attn_layer_norm": ln(h), "q_proj": lin(h, h), "k_proj": lin(h, h),
               "v_proj": lin(h, h), "out_proj": lin(h, h), "final_layer_norm": ln(h),
               "fc1": lin(h, ffn), "fc2": lin(ffn, h)}
              for _ in range(cfg.num_hidden_layers)]
    params = {
        "embed_tokens": normal(cfg.vocab_size, cfg.embed_dim),
        "embed_positions": normal(cfg.max_position_embeddings + POS_OFFSET, h),
        "layers": layers,
        "final_layer_norm": ln(h) if cfg.do_layer_norm_before else None,
        "project_in": None,
        "project_out": None,
    }
    if cfg.embed_dim != h:
        params["project_in"] = lin(cfg.embed_dim, h, bias=False)
        params["project_out"] = lin(h, cfg.embed_dim, bias=False)
    return params


def layer_norm(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p["w"].to(x.dtype) + p["b"].to(x.dtype)


def attention_scale(head_dim: int) -> float:
    """head_dim^-0.5 rounded to f32, as the JAX package casts it."""
    return float(np.float32(head_dim ** -0.5))


def decoder_layer(lp: Dict[str, Any], x: torch.Tensor, cfg: OPTConfig,
                  kv_cache: Optional[Dict[str, torch.Tensor]] = None, pos=0,
                  linear_fn: Optional[Callable] = None):
    """One decoder block.  Returns (hidden, kv_cache updated in place).
    ``linear_fn(name, lin, x)`` replaces `apply_linear` (calibration uses it
    to see each linear's input)."""
    lf = linear_fn or (lambda name, lin, h: apply_linear(lin, h))
    b, t, _ = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    eps = cfg.layer_norm_eps

    residual = x
    h = layer_norm(x, lp["self_attn_layer_norm"], eps) if cfg.do_layer_norm_before else x
    if "qkv_proj" in lp:  # fused serving layout (models.fusion)
        w = nh * hd
        qkv = lf("qkv_proj", lp["qkv_proj"], h)
        q = qkv[..., :w].reshape(b, t, nh, hd)
        k = qkv[..., w : 2 * w].reshape(b, t, nh, hd)
        v = qkv[..., 2 * w :].reshape(b, t, nh, hd)
    else:
        q = lf("q_proj", lp["q_proj"], h).reshape(b, t, nh, hd)
        k = lf("k_proj", lp["k_proj"], h).reshape(b, t, nh, hd)
        v = lf("v_proj", lp["v_proj"], h).reshape(b, t, nh, hd)
    scale = attention_scale(hd)
    if kv_cache is not None:
        kv_cache = cache_update(kv_cache, k, v, pos)
        attn = cached_attention(kv_cache, q, k, v, pos, scale)
    else:
        attn = full_causal_attention(q, k, v, scale)
    x = residual + lf("out_proj", lp["out_proj"], attn.reshape(b, t, nh * hd))
    if not cfg.do_layer_norm_before:
        x = layer_norm(x, lp["self_attn_layer_norm"], eps)

    residual = x
    h = layer_norm(x, lp["final_layer_norm"], eps) if cfg.do_layer_norm_before else x
    x = residual + lf("fc2", lp["fc2"], torch.relu(lf("fc1", lp["fc1"], h)))
    if not cfg.do_layer_norm_before:
        x = layer_norm(x, lp["final_layer_norm"], eps)
    return x, kv_cache


def embed(params: Dict[str, Any], input_ids: torch.Tensor, cfg: OPTConfig, pos=0) -> torch.Tensor:
    """Token + positional embedding (+ project_in): layer 0's input.
    ``pos``: an int, or a [B] tensor of per-slot positions."""
    x = params["embed_tokens"][input_ids]
    if params.get("project_in") is not None:
        x = apply_linear(params["project_in"], x)
    ar = torch.arange(input_ids.shape[1], device=x.device) + POS_OFFSET
    if isinstance(pos, torch.Tensor) and pos.dim():
        positions = pos.to(x.device)[:, None] + ar
    else:
        positions = int(pos) + ar
    return x + params["embed_positions"][positions]


def head(params: Dict[str, Any], x: torch.Tensor, cfg: OPTConfig) -> torch.Tensor:
    """final_layer_norm → project_out → tied lm_head."""
    if params.get("final_layer_norm") is not None:
        x = layer_norm(x, params["final_layer_norm"], cfg.layer_norm_eps)
    if params.get("project_out") is not None:
        x = apply_linear(params["project_out"], x)
    return x @ params["embed_tokens"].to(x.dtype).T


def forward(params: Dict[str, Any], input_ids: torch.Tensor, cfg: OPTConfig,
            kv_caches=None, pos=0, linear_fn: Optional[Callable] = None):
    """input_ids [B, T] → logits [B, T, V] (and the caches, updated in place).
    ``pos``: an int (prefill) or a [B] tensor of per-slot positions.
    ``kv_caches``: per-layer dicts, or one dict with a leading [L] axis
    under ``layers_stacked``."""
    x = embed(params, input_ids, cfg, pos)
    if stacking.is_stacked(params):
        x = stacking.run_layers(
            params, x, lambda lp, h, c: decoder_layer(lp, h, cfg, c, pos, linear_fn),
            kv_caches, linear_fn)
    else:
        for i, lp in enumerate(params["layers"]):
            x, _ = decoder_layer(lp, x, cfg, kv_caches[i] if kv_caches is not None else None,
                                 pos, linear_fn)
    return head(params, x, cfg), kv_caches
