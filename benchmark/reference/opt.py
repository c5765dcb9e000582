"""Plain f32 forward of an OPT model (HF `OPTForCausalLM`, pre-LayerNorm):
learned positions with the +2 offset, q scaled by head_dim^-0.5, causal
softmax attention, ReLU MLP, final LayerNorm, lm_head tied to the token
embedding.  One whole sequence at a time, one layer at a time
(`reference.forward_gaps`); ``quant`` (`reference.Precision`) rounds as
in `llama.py`."""

from __future__ import annotations

import torch

from ..weights import opt as W


def embed(cfg: dict, outer: dict, ids: torch.Tensor) -> torch.Tensor:
    pos = torch.arange(ids.shape[0], device=ids.device) + W.POS_OFFSET
    return outer["embed_tokens"][ids] + outer["embed_positions"][pos]


def _ln(x: torch.Tensor, p: dict) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * p["w"] + p["b"]


def block(cfg: dict, lp: dict, x: torch.Tensor, quant) -> torch.Tensor:
    t = x.shape[0]
    hq, d = cfg["num_attention_heads"], W.head_dim(cfg)

    def lin(name, a):
        return quant.linear(a, lp[name])

    h = _ln(x, lp["self_attn_layer_norm"])
    q = quant.hid(lin("q_proj", h).reshape(t, hq, d) * float(d) ** -0.5)
    k = quant.kv(lin("k_proj", h).reshape(t, hq, d))
    v = quant.kv(lin("v_proj", h).reshape(t, hq, d))
    scores = torch.einsum("thd,shd->hts", q, k)
    pos = torch.arange(t, device=x.device)
    probs = quant.hid(torch.softmax(scores.masked_fill(pos[None, :] > pos[:, None], -torch.inf),
                                    dim=-1))
    x = quant.hid(x + lin("out_proj", torch.einsum("hts,shd->thd", probs, v).reshape(t, hq * d)))
    h = _ln(x, lp["final_layer_norm"])
    return quant.hid(x + lin("fc2", torch.relu(lin("fc1", h))))


def head(cfg: dict, outer: dict, x: torch.Tensor, quant) -> torch.Tensor:
    return quant.hid(_ln(x, outer["final_layer_norm"])) @ quant.hid(outer["embed_tokens"]).T
