"""Shared set-up of the tensor-parallel tests (`tests/test_torch_sharding.py`,
`tests/test_torch_tp_engine.py`): tiny models drawn by the JAX package's
`init_params` from a seed, whose linears are fake-quantized from a seed
(salient by magnitude: element-wise for PBW v1, column-structured for v2;
no GPTQ solve, the layouts are what these tests are about) and packed by
the port's `core.pbw.pack_linear` / `pack_linear_v2`, the bit-for-bit
counterparts of the JAX packers (tests/test_torch_pbw_v1.py,
tests/test_torch_packed_matmul.py).  The packed bits then go into the JAX
package's own PackedLinear / PackedLinearV2 (`to_jax_layer`), so both
packages hold the same tree; packing in torch spares the JAX packers' ~30 s
of first-call compiles a tree.

The shapes tile tp = 4: hidden 128 with 8 q and kv heads, ffn 256, vocab
128; pack_block 32 divides every ic/tp; a PBW-v2 tree's linears carry
shard-major sidecars for ic_shards = 4 (JAX's tests/test_tp_engine.py
fixtures).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pb_llm_tpu.core import pbw as jpbw
from pb_llm_tpu.models import llama as jllama
from pb_llm_tpu.models import opt as jopt
from pb_llm_tpu.models.registry import family_for as jfamily_for
from pb_llm_tpu_torch.core import pbw as tpbw
from pb_llm_tpu_torch.interop import from_jax_params
from pb_llm_tpu_torch.models import llama as tllama
from pb_llm_tpu_torch.models import opt as topt
from pb_llm_tpu_torch.models.registry import family_for
from pb_llm_tpu_torch.quant.high_quant import high_calibrate, high_quantize
from pb_llm_tpu_torch.quant.low_quant import low_calibrate, low_quantize

TP = 4
LOW_FRAC = 0.8


def llama_cfgs(vocab: int = 128, hidden: int = 128, heads: int = 8, kv_heads: int = 8,
               layers: int = 2):
    jcfg = jllama.LlamaConfig(vocab_size=vocab, hidden_size=hidden, intermediate_size=2 * hidden,
                              num_hidden_layers=layers, num_attention_heads=heads,
                              num_key_value_heads=kv_heads, max_position_embeddings=320)
    tcfg = tllama.LlamaConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
        "rms_norm_eps", "rope_theta")})
    return jcfg, tcfg


def opt_cfgs(vocab: int = 128, hidden: int = 32, heads: int = 4):
    kw = dict(vocab_size=vocab, hidden_size=hidden, ffn_dim=2 * hidden, num_hidden_layers=2,
              num_attention_heads=heads, max_position_embeddings=64)
    return jopt.OPTConfig(**kw), topt.OPTConfig(**kw)


def to_jax_layer(p):
    """The JAX package's PackedLinear / PackedLinearV2 holding the port
    layer ``p``'s bits."""
    v2 = isinstance(p, tpbw.PackedLinearV2)
    fields, static = (tpbw._FIELDS_V2, tpbw.STATIC_V2) if v2 else (tpbw._FIELDS, tpbw.STATIC)
    cls = jpbw.PackedLinearV2 if v2 else jpbw.PackedLinear
    # copies: a JAX array on the CPU may alias the numpy buffer, and torch
    # may move a tensor's storage (to shared memory, for a rank process)
    return cls(**{f: None if getattr(p, f) is None else
                  jnp.asarray(np.array(tpbw._to_numpy(f, getattr(p, f)), copy=True))
                  for f in fields}, **{f: getattr(p, f) for f in static})


def pack_one(w, method: str, fmt: str, seed: int, bias=None, groupsize: int = -1,
             col_tile: int = 0, ic_shards: int = 1, pack_block: int = 32):
    """A port packed layer from the dense weight ``w`` [ic, oc] (numpy):
    salient by magnitude, the low and high quantizers calibrated on it."""
    wt = torch.from_numpy(np.array(w, dtype=np.float32).T.copy())  # [oc, ic], the solver's
    wt = wt + torch.from_numpy(np.random.default_rng(seed).standard_normal(
        tuple(wt.shape)).astype(np.float32)) * 1e-3
    if fmt == "v2":
        mask = tpbw.column_structured_mask(wt.abs(), LOW_FRAC, col_tile, ic_shards)
    else:
        a = wt.abs()
        mask = a <= torch.quantile(a.flatten(), LOW_FRAC)
    low = low_calibrate(wt * mask, method, groupsize)
    high = high_calibrate(wt, bits=8)
    w_q = torch.where(mask, low_quantize(wt, low, method, groupsize), high_quantize(wt, high))
    b = None if bias is None else torch.from_numpy(np.array(bias, dtype=np.float32))
    if fmt == "v2":
        p, _ = tpbw.pack_linear_v2(w_q, mask, low, high, method, col_tile=col_tile, bias=b,
                                   pack_block=pack_block, ic_shards=ic_shards)
    else:
        p, _ = tpbw.pack_linear(w_q, mask, low, high, method, groupsize=groupsize, bias=b,
                                pack_block=pack_block)
    return p


def pack_tree(params, fam_name: str, fmt: str, method: str = "xnor", **kw):
    """(JAX tree, port tree): ``params`` with every decoder linear packed
    (`pack_one`), the rest converted."""
    names = (jllama.LINEAR_NAMES if fam_name == "llama" else jopt.LINEAR_NAMES)
    port = to_port({k: v for k, v in params.items() if k != "layers"})
    jax_tree = dict(params, layers=[])
    port["layers"] = []
    for i, lp in enumerate(params["layers"]):
        jl, tl = dict(lp), to_port({n: v for n, v in lp.items() if n not in names})
        for j, n in enumerate(names):
            tl[n] = pack_one(lp[n]["w"], method, fmt, seed=100 * i + j, bias=lp[n].get("b"), **kw)
            jl[n] = to_jax_layer(tl[n])
        jax_tree["layers"].append(jl)
        port["layers"].append(tl)
    return jax_tree, port


def to_port(jparams):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, jparams))


def llama_model(fmt: str = "dense", seed: int = 0, **kw):
    """(JAX params, JAX cfg, port params, port cfg) of the tiny llama,
    dense or packed (fmt "v1" / "v2", `pack_tree` options)."""
    jcfg, tcfg = llama_cfgs(**{k: kw.pop(k) for k in ("vocab", "layers") if k in kw})
    params = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    jtree, ttree = (params, to_port(params)) if fmt == "dense" else \
        pack_tree(params, "llama", fmt, **kw)
    return jtree, jcfg, ttree, tcfg


def opt_model(fmt: str = "dense", seed: int = 0, **kw):
    """The same for the tiny OPT (hidden 32 and 4 heads unless given)."""
    jcfg, tcfg = opt_cfgs(**{k: kw.pop(k) for k in ("vocab", "hidden", "heads") if k in kw})
    params = jopt.init_params(jcfg, jax.random.PRNGKey(seed))
    jtree, ttree = (params, to_port(params)) if fmt == "dense" else \
        pack_tree(params, "opt", fmt, **kw)
    return jtree, jcfg, ttree, tcfg


def families(name: str):
    return jfamily_for(name), family_for(name)
