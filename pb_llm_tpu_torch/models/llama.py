"""LLaMA forward in plain PyTorch (port of `pb_llm_tpu/models/llama.py`).

HF `LlamaForCausalLM` numerics: RMSNorm in float32, rotary embeddings with
the rotate-half convention, GQA, SwiGLU MLP, untied lm_head, optional
sliding window (Mistral).  Params are a plain dict; every linear is a
`models.linear` leaf (dense dict or PackedLinearV2).  Layers run unrolled
(``layers``) or as a loop over stacked layers (``layers_stacked``,
`models.stacking`); a layer may carry the fused ``qkv_proj`` /
``gateup_proj`` linears (`models.fusion`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import resolve_device
from .attention import cache_update, cached_attention, full_causal_attention
from . import stacking
from .linear import apply_linear


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    seqlen: int = 2048
    head_dim_override: Optional[int] = None

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf(cls, hf) -> "LlamaConfig":
        """From an HF config: a `transformers` config object, or a namespace
        made from ``config.json`` with its class defaults filled in
        (`models.hf_import.hf_config`).  Mistral rides this config: its one
        architectural delta, the sliding window, comes with it."""
        head_dim = getattr(hf, "head_dim", None)
        return cls(
            vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            intermediate_size=hf.intermediate_size,
            num_hidden_layers=hf.num_hidden_layers,
            num_attention_heads=hf.num_attention_heads,
            num_key_value_heads=getattr(hf, "num_key_value_heads", None),
            max_position_embeddings=hf.max_position_embeddings,
            rms_norm_eps=hf.rms_norm_eps,
            rope_theta=getattr(hf, "rope_theta", 10000.0),
            sliding_window=getattr(hf, "sliding_window", None),
            # an explicit head_dim (mistral v0.3+, llama3) is kept where it
            # differs from hidden / heads
            head_dim_override=(head_dim if head_dim not in
                               (None, hf.hidden_size // hf.num_attention_heads) else None),
        )


LINEAR_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def init_params(cfg: LlamaConfig, generator: torch.Generator, device=None,
                dtype=torch.float32) -> Dict[str, Any]:
    """Random-init dense params (shapes mirror HF), N(0, 0.02) weights, drawn
    on the generator's device and placed on ``device`` (default: CUDA)."""
    device = resolve_device(device)

    def normal(*shape):
        return (torch.randn(*shape, generator=generator, dtype=dtype,
                            device=generator.device) * 0.02).to(device)

    def lin(ic, oc):
        return {"w": normal(ic, oc), "b": None}

    h, ffn, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    layers = []
    for _ in range(cfg.num_hidden_layers):
        layers.append({
            "input_layernorm": torch.ones(h, dtype=dtype, device=device),
            "post_attention_layernorm": torch.ones(h, dtype=dtype, device=device),
            "q_proj": lin(h, cfg.num_attention_heads * hd),
            "k_proj": lin(h, cfg.kv_heads * hd),
            "v_proj": lin(h, cfg.kv_heads * hd),
            "o_proj": lin(cfg.num_attention_heads * hd, h),
            "gate_proj": lin(h, ffn),
            "up_proj": lin(h, ffn),
            "down_proj": lin(ffn, h),
        })
    return {
        "embed_tokens": normal(cfg.vocab_size, h),
        "layers": layers,
        "norm": torch.ones(h, dtype=dtype, device=device),
        "lm_head": lin(h, cfg.vocab_size),
    }


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def rope_tables(cfg: LlamaConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [*, head_dim] at the given positions (HF half-rotation)."""
    d = cfg.head_dim
    dev = positions.device
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=dev) / d))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, heads, d]; cos/sin [T, d] or [B, T, d]."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[..., None, :] + rotated * sin[..., None, :]


def softmax_scale(head_dim: int) -> float:
    """1/sqrt(head_dim) rounded as the JAX package computes it (in f32)."""
    return float(1.0 / torch.sqrt(torch.tensor(float(head_dim), dtype=torch.float32)))


def decoder_layer(lp: Dict[str, Any], x: torch.Tensor, cfg: LlamaConfig, cos, sin,
                  kv_cache: Optional[Dict[str, torch.Tensor]] = None, pos=0,
                  linear_fn: Optional[Callable] = None):
    """One decoder block.  Returns (hidden, kv_cache updated in place).
    ``linear_fn(name, lin, x)`` replaces `apply_linear` (calibration uses it
    to see each linear's input)."""
    lf = linear_fn or (lambda name, lin, h: apply_linear(lin, h))
    b, t, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, lp["input_layernorm"], cfg.rms_norm_eps)
    if "qkv_proj" in lp:  # fused serving layout (models.fusion)
        wq, wkv = cfg.num_attention_heads * hd, cfg.kv_heads * hd
        qkv = lf("qkv_proj", lp["qkv_proj"], h)
        q = qkv[..., :wq].reshape(b, t, cfg.num_attention_heads, hd)
        k = qkv[..., wq : wq + wkv].reshape(b, t, cfg.kv_heads, hd)
        v = qkv[..., wq + wkv :].reshape(b, t, cfg.kv_heads, hd)
    else:
        q = lf("q_proj", lp["q_proj"], h).reshape(b, t, cfg.num_attention_heads, hd)
        k = lf("k_proj", lp["k_proj"], h).reshape(b, t, cfg.kv_heads, hd)
        v = lf("v_proj", lp["v_proj"], h).reshape(b, t, cfg.kv_heads, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    scale = softmax_scale(hd)
    win = cfg.sliding_window
    if kv_cache is not None:
        kv_cache = cache_update(kv_cache, k, v, pos)
        attn = cached_attention(kv_cache, q, k, v, pos, scale, window=win)
    else:
        attn = full_causal_attention(q, k, v, scale, window=win)
    x = x + lf("o_proj", lp["o_proj"], attn.reshape(b, t, cfg.num_attention_heads * hd))
    h = rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    if "gateup_proj" in lp:  # fused serving layout (models.fusion)
        gu = lf("gateup_proj", lp["gateup_proj"], h)
        gate, up = gu[..., : gu.shape[-1] // 2], gu[..., gu.shape[-1] // 2 :]
    else:
        gate = lf("gate_proj", lp["gate_proj"], h)
        up = lf("up_proj", lp["up_proj"], h)
    x = x + lf("down_proj", lp["down_proj"], torch.nn.functional.silu(gate) * up)
    return x, kv_cache


def forward(params: Dict[str, Any], input_ids: torch.Tensor, cfg: LlamaConfig,
            kv_caches=None, pos=0, linear_fn: Optional[Callable] = None):
    """input_ids [B, T] → logits [B, T, V] (and the caches, updated in place).
    ``pos``: an int (prefill) or a [B] tensor of per-slot positions.
    ``kv_caches``: per-layer dicts, or one dict with a leading [L] axis
    under ``layers_stacked``."""
    x = params["embed_tokens"][input_ids]
    cos, sin = layer_rope(cfg, x, pos)
    if stacking.is_stacked(params):
        x = stacking.run_layers(
            params, x, lambda lp, h, c: decoder_layer(lp, h, cfg, cos, sin, c, pos, linear_fn),
            kv_caches, linear_fn)
    else:
        for i, lp in enumerate(params["layers"]):
            cache_i = kv_caches[i] if kv_caches is not None else None
            x, _ = decoder_layer(lp, x, cfg, cos, sin, cache_i, pos, linear_fn)
    return final_logits(params, x, cfg), kv_caches


def hidden_states_prefix(params: Dict[str, Any], input_ids: torch.Tensor,
                         cfg: LlamaConfig) -> torch.Tensor:
    """Embedding output: layer 0's input, the calibration entry point (the
    functional analogue of the reference's Catcher, `gptq_pb/run.py:72-89`)."""
    return params["embed_tokens"][input_ids]


def final_logits(params: Dict[str, Any], x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Final norm + lm_head: the family's head (`models.registry`)."""
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    return apply_linear(params["lm_head"], x)


def layer_rope(cfg: LlamaConfig, x: torch.Tensor, pos=0):
    """cos/sin in x's dtype for the rows of x [B, T, ...] at ``pos``."""
    ar = torch.arange(x.shape[1], device=x.device)
    positions = pos[:, None] + ar if isinstance(pos, torch.Tensor) and pos.dim() else pos + ar
    cos, sin = rope_tables(cfg, positions)
    return cos.to(x.dtype), sin.to(x.dtype)
