"""HF checkpoint import → the port's parameter trees (port of
`pb_llm_tpu/models/hf_import.py`).

Weights come from a torch state dict, are widened to f32 on the host,
transposed to the ``[ic, oc]`` kernel convention and assembled into the
dicts that `models.llama` / `models.opt` consume.

`from_pretrained` of a local directory reads it with torch alone
(`config.json` with the config classes' defaults filled in, the weights
through `models.hf_stream`'s file layer), so that a machine without
`transformers` or `safetensors` imports the same checkpoints; it gives what
the JAX package's `from_pretrained` gets through `transformers` for the same
directory.  Any other path (a hub id) goes through `transformers`.
"""

from __future__ import annotations

import json
import os
import types
from typing import Any, Dict, Tuple

import torch

from .hf_stream import read_state_dict
from .llama import LlamaConfig
from .opt import OPTConfig


def _f32(t) -> torch.Tensor:
    """A weight widened to f32 on the host (every value kept)."""
    return torch.as_tensor(t).detach().to("cpu").float()


def _lin(sd: Dict[str, Any], prefix: str, dtype) -> Dict[str, Any]:
    w = _f32(sd[prefix + ".weight"]).T.contiguous().to(dtype)  # [oc, ic] -> [ic, oc]
    b = sd.get(prefix + ".bias")
    return {"w": w, "b": None if b is None else _f32(b).to(dtype)}


def _ln(sd: Dict[str, Any], prefix: str, dtype) -> Dict[str, Any]:
    return {"w": _f32(sd[prefix + ".weight"]).to(dtype), "b": _f32(sd[prefix + ".bias"]).to(dtype)}


def llama_layer_from_sd(sd: Dict[str, Any], i: int, dtype=torch.float32) -> Dict[str, Any]:
    """One decoder layer's params from (a subset of) a state dict — the
    streamed calibration path loads exactly this slice at a time."""
    p = f"model.layers.{i}."
    lp = {
        "input_layernorm": _f32(sd[p + "input_layernorm.weight"]).to(dtype),
        "post_attention_layernorm": _f32(sd[p + "post_attention_layernorm.weight"]).to(dtype),
    }
    for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
        lp[n] = _lin(sd, p + "self_attn." + n, dtype)
    for n in ("gate_proj", "up_proj", "down_proj"):
        lp[n] = _lin(sd, p + "mlp." + n, dtype)
    return lp


def llama_nonlayer_from_sd(sd: Dict[str, Any], cfg: LlamaConfig, dtype=torch.float32) -> Dict[str, Any]:
    embed = _f32(sd["model.embed_tokens.weight"]).to(dtype)
    return {
        "embed_tokens": embed,
        "norm": _f32(sd["model.norm.weight"]).to(dtype),
        # a tied head is stored once, as the embedding
        "lm_head": (_lin(sd, "lm_head", dtype) if "lm_head.weight" in sd
                    else {"w": embed.T.contiguous(), "b": None}),
    }


def llama_from_state_dict(sd: Dict[str, Any], cfg: LlamaConfig, dtype=torch.float32) -> Dict[str, Any]:
    out = llama_nonlayer_from_sd(sd, cfg, dtype)
    out["layers"] = [llama_layer_from_sd(sd, i, dtype) for i in range(cfg.num_hidden_layers)]
    return out


def opt_layer_from_sd(sd: Dict[str, Any], i: int, dtype=torch.float32) -> Dict[str, Any]:
    p = f"model.decoder.layers.{i}."
    lp = {
        "self_attn_layer_norm": _ln(sd, p + "self_attn_layer_norm", dtype),
        "final_layer_norm": _ln(sd, p + "final_layer_norm", dtype),
        "fc1": _lin(sd, p + "fc1", dtype),
        "fc2": _lin(sd, p + "fc2", dtype),
    }
    for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
        lp[n] = _lin(sd, p + "self_attn." + n, dtype)
    return lp


def opt_nonlayer_from_sd(sd: Dict[str, Any], cfg: OPTConfig, dtype=torch.float32) -> Dict[str, Any]:
    dec = "model.decoder."
    return {
        "embed_tokens": _f32(sd[dec + "embed_tokens.weight"]).to(dtype),
        "embed_positions": _f32(sd[dec + "embed_positions.weight"]).to(dtype),
        "final_layer_norm": (_ln(sd, dec + "final_layer_norm", dtype)
                             if dec + "final_layer_norm.weight" in sd else None),
        "project_in": _lin(sd, dec + "project_in", dtype) if dec + "project_in.weight" in sd else None,
        "project_out": (_lin(sd, dec + "project_out", dtype)
                        if dec + "project_out.weight" in sd else None),
    }


def opt_from_state_dict(sd: Dict[str, Any], cfg: OPTConfig, dtype=torch.float32) -> Dict[str, Any]:
    params = opt_nonlayer_from_sd(sd, cfg, dtype)
    params["layers"] = [opt_layer_from_sd(sd, i, dtype) for i in range(cfg.num_hidden_layers)]
    return params


def from_torch_model(model, dtype=torch.float32) -> Tuple[Dict[str, Any], Any, str]:
    """(params, config, family) from an instantiated HF torch model."""
    sd = model.state_dict()
    name = type(model).__name__.lower()
    if "llama" in name or "mistral" in name:
        # Mistral rides the llama family: the same state-dict layout, GQA,
        # RoPE, SiLU MLP; its sliding window arrives via
        # LlamaConfig.sliding_window
        cfg = LlamaConfig.from_hf(model.config)
        return llama_from_state_dict(sd, cfg, dtype), cfg, "llama"
    if "opt" in name:
        cfg = OPTConfig.from_hf(model.config)
        return opt_from_state_dict(sd, cfg, dtype), cfg, "opt"
    raise NotImplementedError(f"unsupported model class {type(model).__name__}")


# What `transformers`' config classes fill in for every key `from_hf`
# reads (and tie_word_embeddings) when config.json omits it; None where
# the class derives the value (below).
_HF_DEFAULTS = {
    "llama": dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                  num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=None,
                  max_position_embeddings=2048, rms_norm_eps=1e-6, rope_theta=10000.0,
                  head_dim=None, tie_word_embeddings=False),
    "mistral": dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                    max_position_embeddings=4096 * 32, rms_norm_eps=1e-6, rope_theta=10000.0,
                    sliding_window=4096, head_dim=None, tie_word_embeddings=False),
    "opt": dict(vocab_size=50272, hidden_size=768, num_hidden_layers=12, ffn_dim=3072,
                max_position_embeddings=2048, do_layer_norm_before=True,
                word_embed_proj_dim=None, num_attention_heads=12, tie_word_embeddings=True),
}


def hf_config(raw: Dict[str, Any], model_type: str) -> types.SimpleNamespace:
    """A config namespace from a ``config.json`` dict, with the defaults
    and derived values of the `transformers` class for ``model_type``
    (llama, mistral or opt; any other takes llama's): what `from_hf`
    reads off a `transformers` config of the same file."""
    defaults = _HF_DEFAULTS.get(model_type, _HF_DEFAULTS["llama"])
    ns = types.SimpleNamespace(**{**defaults, **raw})
    if "num_key_value_heads" in defaults and ns.num_key_value_heads is None:
        ns.num_key_value_heads = ns.num_attention_heads
    if model_type == "opt" and ns.word_embed_proj_dim is None:
        ns.word_embed_proj_dim = ns.hidden_size
    if model_type not in ("opt", "mistral") and ns.head_dim is None:
        ns.head_dim = ns.hidden_size // ns.num_attention_heads
    return ns


def _auto_dtype(raw: Dict[str, Any], sd: Dict[str, torch.Tensor]):
    """The dtype `from_pretrained(..., torch_dtype="auto")` builds the model
    in: config.json's ``torch_dtype`` (or ``dtype``), else the first
    floating-point weight's."""
    name = raw.get("torch_dtype") or raw.get("dtype")
    if isinstance(name, str) and isinstance(getattr(torch, name, None), torch.dtype):
        return getattr(torch, name)
    return next((t.dtype for t in sd.values() if t.is_floating_point()), torch.float32)


def _read_config(path: str):
    """(config.json's dict, model_type, `hf_config` namespace) of a local
    checkpoint directory."""
    with open(os.path.join(path, "config.json")) as fh:
        raw = json.load(fh)
    # the checkpoint's own model_type; the reference's name rule without one
    model_type = raw.get("model_type") or ("opt" if "opt" in path.lower() else "llama")
    return raw, model_type, hf_config(raw, model_type)


def config_from_dir(path: str) -> Tuple[Any, str]:
    """(LlamaConfig or OPTConfig, family) of a local checkpoint directory,
    from its config.json alone."""
    _, model_type, hf = _read_config(path)
    if model_type == "opt":
        return OPTConfig.from_hf(hf), "opt"
    return LlamaConfig.from_hf(hf), "llama"


def _load_local(path: str, dtype) -> Tuple[Dict[str, Any], Any, str]:
    raw, _, hf = _read_config(path)
    cfg, family = config_from_dir(path)
    sd = read_state_dict(path)  # stored dtypes, bins memory-mapped
    base = "model."
    if not any(k.startswith(base) for k in sd):
        # saved from the bare base model (OPTModel, LlamaModel): the causal
        # LM class stores it under "model." and reads it so
        sd = {base + k: v for k, v in sd.items()}
    load_dtype = _auto_dtype(raw, sd)
    # the model is built in load_dtype; every floating weight passes through it
    sd = {k: (t.to(load_dtype) if t.is_floating_point() else t) for k, t in sd.items()}
    if family == "opt":
        params = opt_from_state_dict(sd, cfg, dtype)
    else:
        if hf.tie_word_embeddings:
            sd.pop("lm_head.weight", None)  # the head is the embedding
        params = llama_from_state_dict(sd, cfg, dtype)
    del sd  # the state dict goes as soon as the params are built
    return params, cfg, family


def from_pretrained(path_or_repo: str, dtype=torch.float32) -> Tuple[Dict[str, Any], Any, str]:
    """(params, config, family) of an HF checkpoint; params on the CPU.

    A local directory is read with torch alone (no `transformers`); any
    other path goes through `transformers`, as the JAX package does, and
    raises where `transformers` is missing or the hub is out of reach.
    Dispatch mirrors `gptq_pb/run.py:12-31`: OPT → the OPT family,
    otherwise LLaMA (Mistral included)."""
    if os.path.isdir(path_or_repo):
        return _load_local(path_or_repo, dtype)
    try:
        import transformers
    except ImportError as e:
        raise RuntimeError(f"{path_or_repo!r} is not a local checkpoint directory, and reading "
                           "it from the hub needs transformers, which is not installed") from e

    try:
        model_type = transformers.AutoConfig.from_pretrained(path_or_repo).model_type
    except (OSError, ValueError):  # offline or no config: the name rule
        model_type = None
    if model_type is None:
        model_type = "opt" if "opt" in path_or_repo.lower() else "llama"
    cls = {"opt": transformers.OPTForCausalLM,
           "mistral": transformers.MistralForCausalLM}.get(model_type,
                                                           transformers.LlamaForCausalLM)
    model = cls.from_pretrained(path_or_repo, torch_dtype="auto")
    return from_torch_model(model, dtype)
