"""Model-family registry (port of `pb_llm_tpu/models/registry.py`): the
llama family (mistral rides it) and the OPT family."""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

from . import llama as _llama
from . import opt as _opt


@dataclasses.dataclass(frozen=True)
class Family:
    name: str
    forward: Callable  # (params, ids, cfg, kv_caches=None, pos=0) -> (logits, caches)
    embed: Callable    # (params, ids, cfg) -> layer-0 input hidden states
    decoder_layer: Callable  # (lp, x, cfg, linear_fn=None) -> (hidden, None)
    head: Callable     # (params, hidden, cfg) -> logits
    linear_names: Tuple[str, ...]
    config_cls: type


def _llama_layer(lp, x, cfg, linear_fn=None):
    cos, sin = _llama.layer_rope(cfg, x)
    return _llama.decoder_layer(lp, x, cfg, cos, sin, linear_fn=linear_fn)


FAMILIES = {
    "llama": Family(
        name="llama",
        forward=_llama.forward,
        embed=_llama.hidden_states_prefix,
        decoder_layer=_llama_layer,
        head=_llama.final_logits,
        linear_names=_llama.LINEAR_NAMES,
        config_cls=_llama.LlamaConfig,
    ),
    "opt": Family(
        name="opt",
        forward=_opt.forward,
        embed=_opt.embed,
        decoder_layer=lambda lp, x, cfg, linear_fn=None: _opt.decoder_layer(
            lp, x, cfg, linear_fn=linear_fn),
        head=_opt.head,
        linear_names=_opt.LINEAR_NAMES,
        config_cls=_opt.OPTConfig,
    ),
}


def family_for(model_name: str) -> Family:
    """Substring dispatch, as in the JAX package."""
    lowered = model_name.lower()
    if "opt" in lowered:
        return FAMILIES["opt"]
    if "llama" in lowered or "mistral" in lowered:
        return FAMILIES["llama"]
    raise NotImplementedError(f"unknown model family for {model_name!r}")
