"""The port's parameter trees → HF checkpoints (port of
`pb_llm_tpu/models/hf_export.py`), the inverse of `models.hf_import`.

Packed leaves (PBW v1 and v2) are materialized to dense ``[ic, oc]``
weights through `core.pbw.dequantize` / `dequantize_v2`, QAT leaves through
`quant.qat.to_dense`, transposed back to
torch's ``[oc, ic]``, and written as HF state-dict keys.  The
``*_to_state_dict`` functions need torch alone; `to_hf_config`,
`to_torch_model` and `save_pretrained` instantiate `transformers` classes and
so need `transformers`.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

from .llama import LlamaConfig
from .opt import OPTConfig


def _dense_leaf(lin) -> Dict[str, Any]:
    """Any linear leaf (dense dict / PackedLinear / PackedLinearV2 /
    QATLinear) as {"w": [ic, oc], "b": [oc] | None}: a QAT leaf as its
    fake-quant weight (`quant.qat.to_dense`)."""
    from ..core.pbw import PackedLinear, PackedLinearV2, dequantize, dequantize_v2
    from ..quant.qat import QATLinear, to_dense

    if isinstance(lin, PackedLinearV2):
        return {"w": dequantize_v2(lin), "b": lin.bias}
    if isinstance(lin, PackedLinear):
        return {"w": dequantize(lin), "b": lin.bias}
    if isinstance(lin, QATLinear):
        return to_dense(lin)
    return lin


def _t(x: torch.Tensor, torch_dtype) -> torch.Tensor:
    """A host copy in f32, then cast to ``torch_dtype``, contiguous."""
    return x.detach().to("cpu", torch.float32).to(torch_dtype).contiguous()


def _put_lin(sd: Dict[str, Any], prefix: str, lin, dtype) -> None:
    lin = _dense_leaf(lin)
    sd[prefix + ".weight"] = _t(lin["w"].T, dtype)
    b = lin.get("b")
    if b is not None:
        sd[prefix + ".bias"] = _t(b, dtype)


def _put_ln(sd: Dict[str, Any], prefix: str, ln, dtype) -> None:
    sd[prefix + ".weight"] = _t(ln["w"], dtype)
    sd[prefix + ".bias"] = _t(ln["b"], dtype)


def llama_to_state_dict(params: Dict[str, Any], cfg: LlamaConfig, dtype) -> Dict[str, Any]:
    sd: Dict[str, Any] = {
        "model.embed_tokens.weight": _t(params["embed_tokens"], dtype),
        "model.norm.weight": _t(params["norm"], dtype),
    }
    _put_lin(sd, "lm_head", params["lm_head"], dtype)
    for i, lp in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = _t(lp["input_layernorm"], dtype)
        sd[p + "post_attention_layernorm.weight"] = _t(lp["post_attention_layernorm"], dtype)
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _put_lin(sd, p + "self_attn." + n, lp[n], dtype)
        for n in ("gate_proj", "up_proj", "down_proj"):
            _put_lin(sd, p + "mlp." + n, lp[n], dtype)
    return sd


def opt_to_state_dict(params: Dict[str, Any], cfg: OPTConfig, dtype) -> Dict[str, Any]:
    dec = "model.decoder."
    sd: Dict[str, Any] = {
        dec + "embed_tokens.weight": _t(params["embed_tokens"], dtype),
        dec + "embed_positions.weight": _t(params["embed_positions"], dtype),
    }
    if params.get("final_layer_norm") is not None:
        _put_ln(sd, dec + "final_layer_norm", params["final_layer_norm"], dtype)
    if params.get("project_in") is not None:
        _put_lin(sd, dec + "project_in", params["project_in"], dtype)
    if params.get("project_out") is not None:
        _put_lin(sd, dec + "project_out", params["project_out"], dtype)
    for i, lp in enumerate(params["layers"]):
        p = f"{dec}layers.{i}."
        _put_ln(sd, p + "self_attn_layer_norm", lp["self_attn_layer_norm"], dtype)
        _put_ln(sd, p + "final_layer_norm", lp["final_layer_norm"], dtype)
        _put_lin(sd, p + "fc1", lp["fc1"], dtype)
        _put_lin(sd, p + "fc2", lp["fc2"], dtype)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _put_lin(sd, p + "self_attn." + n, lp[n], dtype)
    return sd


def hf_config_dict(cfg, family: str) -> Dict[str, Any]:
    """The fields of the HF config that `to_hf_config` builds, with its
    ``model_type``: what a ``config.json`` of the export holds for them."""
    if family == "llama":
        return dict(
            model_type="llama",
            vocab_size=cfg.vocab_size,
            hidden_size=cfg.hidden_size,
            intermediate_size=cfg.intermediate_size,
            num_hidden_layers=cfg.num_hidden_layers,
            num_attention_heads=cfg.num_attention_heads,
            num_key_value_heads=cfg.kv_heads,
            max_position_embeddings=cfg.max_position_embeddings,
            rms_norm_eps=cfg.rms_norm_eps,
            rope_theta=cfg.rope_theta,
            tie_word_embeddings=False,
        )
    if family == "opt":
        return dict(
            model_type="opt",
            vocab_size=cfg.vocab_size,
            hidden_size=cfg.hidden_size,
            ffn_dim=cfg.ffn_dim,
            num_hidden_layers=cfg.num_hidden_layers,
            num_attention_heads=cfg.num_attention_heads,
            max_position_embeddings=cfg.max_position_embeddings,
            word_embed_proj_dim=cfg.word_embed_proj_dim or cfg.hidden_size,
            do_layer_norm_before=cfg.do_layer_norm_before,
        )
    raise NotImplementedError(family)


def to_hf_config(cfg, family: str):
    import transformers

    kw = hf_config_dict(cfg, family)
    cls = {"llama": transformers.LlamaConfig, "opt": transformers.OPTConfig}[kw.pop("model_type")]
    return cls(**kw)


def to_torch_model(params: Dict[str, Any], cfg, family: str, torch_dtype=None):
    """Instantiate the HF model class and load the converted weights.

    `strict=False` because HF models register non-persistent buffers (rotary
    inv_freq) and tied heads; there must be no unexpected keys, and every
    missing key must be a buffer or a tied head."""
    import transformers

    dtype = torch_dtype or torch.float32
    hf_cfg = to_hf_config(cfg, family)
    if family == "llama":
        model = transformers.LlamaForCausalLM(hf_cfg)
        sd = llama_to_state_dict(params, cfg, dtype)
    else:
        model = transformers.OPTForCausalLM(hf_cfg)
        sd = opt_to_state_dict(params, cfg, dtype)
    model = model.to(dtype)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected:
        raise ValueError(f"unexpected keys in export: {unexpected}")
    allowed = ("rotary_emb", "lm_head.weight")  # buffers / tied embeddings
    bad = [k for k in missing if not any(a in k for a in allowed)]
    if bad:
        raise ValueError(f"export left keys uninitialized: {bad}")
    if family == "opt":
        model.tie_weights()  # lm_head ← embed_tokens (HF OPT ties by default)
    return model


def save_pretrained(params: Dict[str, Any], cfg, family: str, out_dir: str,
                    tokenizer=None, torch_dtype=None) -> str:
    """`model.save_pretrained`-compatible export (`gptq_pb/run.py:315-319`,
    `qat/run_qat.py:140-148`: the QAT path also saves the tokenizer)."""
    model = to_torch_model(params, cfg, family, torch_dtype)
    os.makedirs(out_dir, exist_ok=True)
    model.save_pretrained(out_dir)
    if tokenizer is not None:
        tokenizer.save_pretrained(out_dir)
    return out_dir
