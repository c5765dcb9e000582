"""Shared set-up of the serving parity tests (`tests/test_torch_{paged,
prefix_cache,chunked_prefill,spec_decode}.py`): one tiny llama drawn by the
JAX package's `init_params` from a seed, carried into the port with
`interop.from_jax_params`, and engines of either package over it.

The JAX engines run on the CPU, where the paged pool reaches the Pallas
paged-attention kernel in interpret mode; the port's engines run on the
CPU, where every kernel wrapper takes its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pb_llm_tpu.models import llama as jllama
from pb_llm_tpu.models.registry import family_for as jfamily_for
from pb_llm_tpu.runtime import batching as jbatching
from pb_llm_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
from pb_llm_tpu_torch.interop import from_jax_params
from pb_llm_tpu_torch.models import llama as tllama
from pb_llm_tpu_torch.models.registry import family_for
from pb_llm_tpu_torch.runtime import batching as tbatching
from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

torch.set_num_threads(2)

_JDTYPE = {"f32": jnp.float32, "int8": jnp.int8, "bf16": jnp.bfloat16}
_TDTYPE = {"f32": torch.float32, "int8": torch.int8, "bf16": torch.bfloat16}


class TinyLlama:
    """A 2-layer llama (hidden 64, 8 heads, ``kv_heads`` kv heads) in both
    packages; ``cache_dtype`` is given as "f32", "bf16" or "int8" to
    either side."""

    def __init__(self, kv_heads: int = 4, seed: int = 0, layers: int = 2, hidden: int = 64,
                 family: str = "llama", **cfg_kw):
        self.jcfg = jllama.LlamaConfig(
            vocab_size=128, hidden_size=hidden, intermediate_size=2 * hidden,
            num_hidden_layers=layers, num_attention_heads=8, num_key_value_heads=kv_heads,
            max_position_embeddings=256, **cfg_kw)
        self.jparams = jllama.init_params(self.jcfg, jax.random.PRNGKey(seed))
        self.tcfg = tllama.LlamaConfig(**{f: getattr(self.jcfg, f) for f in (
            "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
            "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
            "rms_norm_eps", "rope_theta", "sliding_window")})
        self.tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, self.jparams))
        self.family = family

    def jax_engine(self, cache_dtype: str = "f32", **ekw) -> JEngine:
        return JEngine(self.jparams, self.jcfg, jfamily_for(self.family),
                       JEngineConfig(cache_dtype=_JDTYPE[cache_dtype], **ekw))

    def port_engine(self, cache_dtype: str = "f32", **ekw) -> Engine:
        return Engine(self.tparams, self.tcfg, family_for(self.family),
                      EngineConfig(cache_dtype=_TDTYPE[cache_dtype], **ekw), device="cpu")


def requests(mod, prompts, steps):
    """Requests of the package ``mod`` (`batching` of JAX or of the port)."""
    return [mod.Request(request_id=i, prompt_ids=list(p), max_new_tokens=steps)
            for i, p in enumerate(prompts)]


def serve(eng, prompts, steps, draft_source=None):
    """(streams, batcher) of ``prompts`` through either package's batcher."""
    mod = tbatching if isinstance(eng, Engine) else jbatching
    b = mod.ContinuousBatcher(eng, draft_source=draft_source)
    reqs = requests(mod, prompts, steps)
    b.run(reqs)
    assert all(r.done for r in reqs)
    return [r.output_ids for r in reqs], b


def greedy(eng, prompt, steps, slot=0):
    """Prefill ``prompt`` into ``slot``, decode ``steps - 1`` more tokens,
    release the slot; returns the tokens and the prefill logits."""
    toks = [eng.prefill(slot, prompt)]
    logits = np.asarray(eng._prefill_logits[slot])
    for _ in range(steps - 1):
        toks.append(eng.decode_step()[slot])
    eng.release(slot)
    return toks, logits


def random_prompts(seed, lengths, vocab=128):
    r = np.random.default_rng(seed)
    return [r.integers(1, vocab, size=n).tolist() for n in lengths]
