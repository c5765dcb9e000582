"""Port parity for the OPT family (`pb_llm_tpu_torch.models.opt`): the
forward against JAX `opt.forward`, with and without project_in/out
(word_embed_proj_dim ≠ hidden), the embedding at per-slot positions, and
the engine's greedy streams on a PBW-v1-packed OPT against the JAX engine,
on strips and on a paged pool (the mirror of tests/test_engine.py:41-133).

Models come from the JAX package's `init_params` (biases and LayerNorms
perturbed from a numpy seed, so that they count) and its own
`quantize_model_ptq(fmt="packed")`, carried over by
`interop.from_jax_params`.  Logits: rtol 1e-4 / atol 1e-5, f32 sums (the
LayerNorm statistics and the matmuls) in another order than XLA's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.calib.pipeline import quantize_model_ptq
from pb_llm_tpu.calib.solver import SolverConfig
from pb_llm_tpu.models import opt as jopt
from pb_llm_tpu.models.registry import family_for as jfamily_for
from pb_llm_tpu.ops import binary_matmul as _jbm  # noqa: F401  (registers the JAX dispatch)
from pb_llm_tpu.runtime import batching as jbatching
from pb_llm_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
from pb_llm_tpu_torch.core.pbw import PackedLinear
from pb_llm_tpu_torch.interop import from_jax_params
from pb_llm_tpu_torch.models import opt as topt
from pb_llm_tpu_torch.models.registry import family_for
from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1
from pb_llm_tpu_torch.ops.kernel_config import KernelConfig
from pb_llm_tpu_torch.runtime import batching as tbatching
from pb_llm_tpu_torch.runtime import kv_cache
from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

torch.set_num_threads(2)

_FIELDS = ("vocab_size", "hidden_size", "ffn_dim", "num_hidden_layers", "num_attention_heads",
           "max_position_embeddings", "word_embed_proj_dim", "do_layer_norm_before",
           "layer_norm_eps")


def _tcfg(jcfg):
    return topt.OPTConfig(**{f: getattr(jcfg, f) for f in _FIELDS})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_opt(seed=0, **kw):
    """JAX OPT params with random biases and LayerNorm affines."""
    cfg = jopt.OPTConfig(**{**dict(vocab_size=128, hidden_size=64, ffn_dim=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   max_position_embeddings=128), **kw})
    params = jopt.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def jitter(d, key, scale, base=0.0):
        if d is not None and d.get(key) is not None:
            d[key] = jnp.asarray(base + scale * rng.standard_normal(d[key].shape).astype(np.float32))

    for lp in params["layers"]:
        for name in jopt.LINEAR_NAMES:
            jitter(lp[name], "b", 0.02)
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            jitter(lp[name], "w", 0.1, 1.0)
            jitter(lp[name], "b", 0.05)
    jitter(params["final_layer_norm"], "w", 0.1, 1.0)
    jitter(params["final_layer_norm"], "b", 0.05)
    return cfg, params


@pytest.mark.parametrize("proj", [None, 32])
def test_forward_matches_jax(proj):
    jcfg, jparams = _jax_opt(word_embed_proj_dim=proj)
    tparams = from_jax_params(_np(jparams))
    assert (tparams["project_in"] is None) == (proj is None)
    ids = np.random.default_rng(1).integers(0, 128, size=(2, 24))
    want = np.asarray(jopt.forward(jparams, jnp.asarray(ids), jcfg)[0])
    got = topt.forward(tparams, torch.as_tensor(ids), _tcfg(jcfg))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_embed_at_per_slot_positions():
    jcfg, jparams = _jax_opt()
    tparams = from_jax_params(_np(jparams))
    ids = np.array([[3], [9], [100]])
    pos = np.array([0, 17, 40])
    want = np.asarray(jopt.embed(jparams, jnp.asarray(ids), jcfg, jnp.asarray(pos)))
    got = topt.embed(tparams, torch.as_tensor(ids), _tcfg(jcfg), torch.as_tensor(pos)).numpy()
    np.testing.assert_array_equal(got, want)
    got_int = topt.embed(tparams, torch.as_tensor(ids.T), _tcfg(jcfg), 5).numpy()
    np.testing.assert_array_equal(got_int, np.asarray(jopt.embed(jparams, jnp.asarray(ids.T), jcfg, 5)))


def test_registry_and_cache_spec():
    fam = family_for("facebook/opt-1.3b")
    assert fam.name == "opt" and fam.linear_names == jopt.LINEAR_NAMES
    cfg = topt.OPTConfig(hidden_size=2048, num_attention_heads=32, num_hidden_layers=24)
    assert kv_cache.cache_spec_for(cfg, "opt") == (24, 32, 64)


def test_init_params_shapes_follow_jax():
    jcfg, jparams = _jax_opt(word_embed_proj_dim=32)
    tparams = topt.init_params(_tcfg(jcfg), torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), _np(jparams))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tparams) == shapes


# ---------------------------------------------------------------------------
# serving a PBW-v1-packed OPT
# ---------------------------------------------------------------------------

MAX_SEQ = 64
BUCKETS = (16, 32)
PROMPTS = [[5, 17, 99, 3], [42, 7, 11, 23, 60, 2, 19], [9] * 12, list(range(20, 40)),
           [1, 2, 3]]


@pytest.fixture(scope="module")
def packed_opt():
    """hidden 128 (oc a multiple of 128: the kernels' plain versions take
    the layers), GPTQ-PB with element masks and groups of 64."""
    jcfg, jparams = _jax_opt(hidden_size=128, ffn_dim=256, num_attention_heads=4)
    calib = np.random.default_rng(0).integers(0, 128, size=(2, 16))
    packed, _ = quantize_model_ptq(copy.deepcopy(jparams), jcfg, jfamily_for("opt"), calib,
                                   SolverConfig(low_frac=0.8, blocksize=32, groupsize=64),
                                   fmt="packed", log=None)
    return jcfg, packed


def _streams(eng, mod):
    reqs = [mod.Request(request_id=i, prompt_ids=list(p), max_new_tokens=6)
            for i, p in enumerate(PROMPTS)]
    mod.ContinuousBatcher(eng).run(reqs)
    assert all(r.done for r in reqs)
    return [r.output_ids for r in reqs]


@pytest.fixture(scope="module")
def jax_streams(packed_opt):
    """The JAX engine's greedy streams (CPU auto arms) on strips and on a
    paged pool of 8-token pages, and its prefill logits."""
    jcfg, packed = packed_opt
    out = {}
    for page_size in (0, 8):
        eng = JEngine(packed, jcfg, jfamily_for("opt"),
                      JEngineConfig(n_slots=2, max_seq=MAX_SEQ, prefill_buckets=BUCKETS,
                                    page_size=page_size, cache_dtype=jnp.float32))
        eng.prefill(0, PROMPTS[1])
        logits = np.asarray(eng._prefill_logits[0])
        eng.release(0)
        out[page_size] = (logits, _streams(eng, jbatching))
    return out


def _port_engine(packed_opt, **kw):
    jcfg, packed = packed_opt
    params = from_jax_params(_np(packed))
    assert all(isinstance(lp[n], PackedLinear) for lp in params["layers"] for n in topt.LINEAR_NAMES)
    return Engine(params, _tcfg(jcfg), family_for("opt"),
                  EngineConfig(n_slots=2, max_seq=MAX_SEQ, prefill_buckets=BUCKETS,
                               cache_dtype=torch.float32, **kw), device="cpu")


@pytest.mark.parametrize("page_size", [0, 8])
@pytest.mark.parametrize("arms", ["auto", "kernels"])
def test_engine_streams_match_jax(packed_opt, jax_streams, page_size, arms):
    """"auto": the reference matmul on the CPU, as JAX's; "kernels": the
    planar and select plain versions (and the paged-attention plain version
    on the pool), which the card replaces by the CUDA kernels."""
    want_logits, want = jax_streams[page_size]
    kernels = None if arms == "auto" else KernelConfig(backend="pallas_interpret",
                                                       decode_attention="pallas_interpret")
    eng = _port_engine(packed_opt, page_size=page_size, kernels=kernels)
    eng.prefill(0, PROMPTS[1])
    np.testing.assert_allclose(eng._prefill_logits[0].numpy(), want_logits, rtol=1e-4, atol=1e-5)
    eng.release(0)
    assert _streams(eng, tbatching) == want


def test_engine_greedy_matches_full_forward(packed_opt):
    """Slots at different lengths decode together and match greedy decoding
    by full uncached forwards (test_engine.py:41-70)."""
    jcfg, packed = packed_opt
    params, cfg = from_jax_params(_np(packed)), _tcfg(jcfg)
    eng = _port_engine(packed_opt)

    def reference(prompt, steps):
        ids = list(prompt)
        for _ in range(steps):
            ids.append(int(topt.forward(params, torch.as_tensor([ids]), cfg)[0][0, -1].argmax()))
        return ids[len(prompt):]

    p0, p1 = PROMPTS[0], PROMPTS[1]
    g0 = [eng.prefill(0, p0), eng.decode_step()[0]]
    g1 = [eng.prefill(1, p1)]
    for _ in range(3):
        out = eng.decode_step()
        g0.append(out[0])
        g1.append(out[1])
    assert g0 == reference(p0, 5) and g1 == reference(p1, 4)


def test_eos_retires_early(packed_opt):
    eng = _port_engine(packed_opt)
    first = eng.prefill(0, [9, 9, 9])
    eng.release(0)
    req = tbatching.Request(request_id=0, prompt_ids=[9, 9, 9], max_new_tokens=10,
                            eos_token_id=first)
    tbatching.ContinuousBatcher(eng).run([req])
    assert req.done and req.output_ids == [first]


def test_decode_runs_the_planar_arm_and_prefill_the_select_arm(packed_opt, monkeypatch):
    """Through the kernels' arms a batched prefill of 4 prompts in bucket
    64 (m = 256) takes the select path, and a decode step (m = 4 slots) the
    planar path, once per linear of each layer."""
    calls = []
    for name in ("pb_planar_v1_plain", "pb_select_v1_plain"):
        fn = getattr(v1, name)
        monkeypatch.setattr(v1, name, lambda *a, _fn=fn, _n=name, **k: calls.append(
            (_n, a[0].shape[0])) or _fn(*a, **k))
    jcfg, packed = packed_opt
    eng = Engine(from_jax_params(_np(packed)), _tcfg(jcfg), family_for("opt"),
                 EngineConfig(n_slots=4, max_seq=128, prefill_buckets=(64,),
                              cache_dtype=torch.float32,
                              kernels=KernelConfig(backend="pallas_interpret")), device="cpu")
    eng.prefill_batch([(s, [s + 1] * 40) for s in range(4)])
    eng.decode_step()
    kinds = {(n, m) for n, m in calls}
    assert kinds == {("pb_select_v1_plain", 256), ("pb_planar_v1_plain", 4)}, kinds
    assert len(calls) == 2 * 6 * 2
