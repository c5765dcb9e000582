"""Plain f32 forward of a llama-family model (HF `LlamaForCausalLM` /
`MistralForCausalLM`): RMSNorm, rotate-half RoPE, causal GQA softmax
attention (with the sliding window when the config has one), SwiGLU MLP,
final RMSNorm, untied f32 lm_head.  No cache, no batching: one whole
sequence at a time, one layer at a time (`reference.forward_gaps`).

``quant`` (`reference.Precision`) rounds the inputs of the decoder
linears, the K/V rows and the rest (`Precision.hid`) as the configuration
states (the reference), one of them a step lower (a control), or nowhere
(the f32 witness).
"""

from __future__ import annotations

import torch

from ..weights import llama as W


def embed(cfg: dict, outer: dict, ids: torch.Tensor) -> torch.Tensor:
    return outer["embed_tokens"][ids]


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, H, d] at positions 0..T-1."""
    t, _, d = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).repeat(1, 2)[:, None], torch.sin(ang).repeat(1, 2)[:, None]
    rot = torch.cat([-x[..., d // 2 :], x[..., : d // 2]], dim=-1)
    return x * cos + rot * sin


def block(cfg: dict, lp: dict, x: torch.Tensor, quant) -> torch.Tensor:
    """One decoder layer over x [T, h]; ``lp`` holds `dequant.dense` layers."""
    t = x.shape[0]
    hq, hkv, d = cfg["num_attention_heads"], W.kv_heads(cfg), W.head_dim(cfg)
    eps = cfg["rms_norm_eps"]

    def lin(name, a):
        return quant.linear(a, lp[name])

    h = _rms(x, lp["input_layernorm"], eps)
    q = quant.hid(_rope(lin("q_proj", h).reshape(t, hq, d), cfg["rope_theta"]))
    k = quant.kv(_rope(lin("k_proj", h).reshape(t, hkv, d), cfg["rope_theta"]))
    v = quant.kv(lin("v_proj", h).reshape(t, hkv, d))
    k, v = (a.repeat_interleave(hq // hkv, dim=1) for a in (k, v))
    scores = torch.einsum("thd,shd->hts", q, k) / float(d) ** 0.5
    pos = torch.arange(t, device=x.device)
    allowed = pos[None, :] <= pos[:, None]
    if cfg.get("sliding_window"):
        allowed &= pos[None, :] > pos[:, None] - cfg["sliding_window"]
    probs = quant.hid(torch.softmax(scores.masked_fill(~allowed, -torch.inf), dim=-1))
    x = quant.hid(x + lin("o_proj", torch.einsum("hts,shd->thd", probs, v).reshape(t, hq * d)))
    h = _rms(x, lp["post_attention_layernorm"], eps)
    return quant.hid(x + lin("down_proj",
                             torch.nn.functional.silu(lin("gate_proj", h)) * lin("up_proj", h)))


def head(cfg: dict, outer: dict, x: torch.Tensor, quant) -> torch.Tensor:
    return quant.hid(_rms(x, outer["norm"], cfg["rms_norm_eps"])) @ quant.hid(outer["lm_head"])
