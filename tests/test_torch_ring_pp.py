"""Port parity of inference across ranks on the sequence and the layers
(`pb_llm_tpu_torch.parallel.ring_attention`, `eval.ppl.perplexity_sp`,
`models.attention.sequence_parallel`, `parallel.pipeline`, `run_eval --sp`),
against the JAX package (tests/test_ring_pp.py) on the CPU.

One module fixture spawns a world of 4 gloo ranks once (`run_ranks`; the
ranks run `tests/_torch_ring_pp_worker.py`, which imports no JAX), with sp
and pp meshes of 2 and 4 ranks; JAX's ring, pipeline and `perplexity_sp`
run meanwhile in this process on its 8 host devices.  Bounds are JAX's own:
2e-5 for the masked-softmax ring, the pipeline and perplexity, 2e-4 for the
flash inner and the GQA forward.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tp import llama_cfgs, pack_tree, to_port
from _torch_ring_pp_worker import run_all
from pb_llm_tpu.eval.ppl import perplexity_sp as jperplexity_sp
from pb_llm_tpu.models import llama as jllama
from pb_llm_tpu.models.registry import family_for as jfamily_for
from pb_llm_tpu.models.stacking import stack_layers as jstack_layers
from pb_llm_tpu.parallel.pipeline import make_pp_mesh, pipeline_forward as jpipeline_forward
from pb_llm_tpu.parallel.ring_attention import make_sp_mesh, ring_attention as jring_attention
from pb_llm_tpu_torch.eval.ppl import cross_entropy_shifted, perplexity
from pb_llm_tpu_torch.models import llama as tllama
from pb_llm_tpu_torch.models.attention import causal_allowed, masked_softmax_attention
from pb_llm_tpu_torch.models.registry import family_for
from pb_llm_tpu_torch.parallel.mesh import run_ranks

torch.set_num_threads(2)

RING = (2, 256, 4, 32)  # B, T, H, D (JAX's test_ring_attention_matches_full)
PPL_SEQLEN = 32
# JAX's side runs each function once (its compiles are most of the time):
# the port's results at every sp / pp are held to that one output, the same
# function of the same inputs
JAX_RINGS = ((4, "xla"), (2, "flash_interpret"))
JAX_PIPELINES = {"dense": (4, 2), "v2": (2, 4)}
JAX_PPL_SP = 4
RUN_EVAL = ["--model_id", "llama", "--synthetic", "--device", "cpu", "--eval_ppl", "wikitext2",
            "--seqlen", "64", "--ppl_limit", "3"]


def _cfg_pair(**kw):
    jcfg = jllama.LlamaConfig(**kw)
    tcfg = tllama.LlamaConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
        "rms_norm_eps", "rope_theta", "sliding_window")})
    return jcfg, tcfg


def _jax_side(spec, j):
    """JAX's results for every case the ranks run."""
    q, k, v = (jnp.asarray(a) for a in spec["qkv"])
    out = {}
    for sp, inner in JAX_RINGS:
        out[("ring", inner)] = np.asarray(
            jring_attention(q, k, v, spec["scale"], make_sp_mesh(sp), inner=inner))
    fam = jfamily_for("llama")
    out["ppl_sp"] = jperplexity_sp(j["ppl_params"], j["ppl_cfg"], fam.forward, spec["ppl_ids"],
                                   make_sp_mesh(JAX_PPL_SP), seqlen=PPL_SEQLEN)
    ids = jnp.asarray(spec["pp_ids"])
    with jax.default_matmul_precision("float32"):
        for name, (pp, n_micro) in JAX_PIPELINES.items():
            out[("pp", name)] = np.asarray(jpipeline_forward(
                jstack_layers(j["pp_trees"][name]), ids, j["pp_cfg"], make_pp_mesh(pp), n_micro))
    bad = jstack_layers(j["pp_two_layers"])
    for key, fn in (("pp_indivisible_layers",
                     lambda: jpipeline_forward(bad, ids, j["pp_cfg"], make_pp_mesh(4), 2)),
                    ("pp_unstacked", lambda: jpipeline_forward(
                        j["pp_trees"]["dense"], ids, j["pp_cfg"], make_pp_mesh(4), 2)),
                    ("ring_indivisible", lambda: jring_attention(
                        jnp.zeros((1, 34, 2, 16)), jnp.zeros((1, 34, 2, 16)),
                        jnp.zeros((1, 34, 2, 16)), 0.25, make_sp_mesh(4)))):
        try:
            fn()
            out[key] = ""
        except Exception as e:
            out[key] = type(e).__name__
    return out


@pytest.fixture(scope="module")
def worlds():
    """(every rank's results, JAX's results, the spec)."""
    rng = np.random.default_rng(0)
    qkv = tuple(rng.standard_normal(RING).astype(np.float32) for _ in range(3))
    jgqa_cfg, tgqa_cfg = _cfg_pair(vocab_size=64, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=8,
                                   num_key_value_heads=2, max_position_embeddings=128)
    _, twin_cfg = _cfg_pair(vocab_size=64, hidden_size=64, intermediate_size=128,
                            num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=2,
                            max_position_embeddings=128, sliding_window=8)
    jgqa = jllama.init_params(jgqa_cfg, jax.random.PRNGKey(3))
    jpp_cfg, tpp_cfg = llama_cfgs(vocab=128, hidden=128, heads=8, kv_heads=8, layers=4)
    jdense = jllama.init_params(jpp_cfg, jax.random.PRNGKey(0))
    jv2, tv2 = pack_tree(jdense, "llama", "v2")
    jtwo = dict(jdense, layers=jdense["layers"][:2])  # 2 layers: pp = 4 does not divide them
    spec = {
        "qkv": qkv, "scale": float(1.0 / np.sqrt(RING[3])),
        "ppl_params": to_port(jgqa), "ppl_cfg": tgqa_cfg,  # perplexity on the GQA model
        "ppl_ids": np.random.default_rng(7).integers(0, 64, size=(3 * PPL_SEQLEN,)),
        "ppl_seqlen": PPL_SEQLEN,
        "gqa_params": to_port(jgqa), "gqa_cfg": tgqa_cfg, "window_cfg": twin_cfg,
        "gqa_ids": np.random.default_rng(8).integers(0, 64, size=(2, 32)),
        "pp_trees": {"dense": to_port(jdense), "v2": tv2}, "pp_cfg": tpp_cfg,
        "pp_two_layers": to_port(jtwo),
        "pp_ids": np.random.default_rng(3).integers(0, 128, size=(4, 16)),
        "run_eval_argv": RUN_EVAL + ["--sp", "2"],
    }
    j = {"ppl_params": jgqa, "ppl_cfg": jgqa_cfg, "pp_trees": {"dense": jdense, "v2": jv2},
         "pp_cfg": jpp_cfg, "pp_two_layers": jtwo}
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_ranks, run_all, 4, (spec,), "cpu", 600)
        jax_out = _jax_side(spec, j)
        return ranks.result(), jax_out, spec


def _full_attention(spec):
    q, k, v = (torch.from_numpy(a) for a in spec["qkv"])
    t = q.shape[1]
    return masked_softmax_attention(q, k, v, causal_allowed(0, t, t, None), spec["scale"]).numpy()


@pytest.mark.parametrize("inner,tol", [("xla", 2e-5), ("flash_interpret", 2e-4)])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_matches_jax_and_full(worlds, sp, inner, tol):
    ranks, jax_out, spec = worlds
    full = _full_attention(spec)
    for r in ranks:  # every rank holds the whole gathered output
        got = r[("ring", sp, inner)]
        np.testing.assert_allclose(got, jax_out[("ring", inner)], rtol=tol, atol=tol)
        np.testing.assert_allclose(got, full, rtol=tol, atol=tol)


def test_ring_attention_rejects_indivisible(worlds):
    ranks, jax_out, _ = worlds
    assert jax_out["ring_indivisible"] == "ValueError"
    assert all(r["ring_indivisible"] == "ValueError" for r in ranks)


@pytest.mark.parametrize("sp", [2, 4])
def test_perplexity_sp_matches_jax_and_single_device(worlds, sp):
    ranks, jax_out, spec = worlds
    want = perplexity(spec["ppl_params"], spec["ppl_cfg"], family_for("llama").forward,
                      spec["ppl_ids"], seqlen=PPL_SEQLEN)
    for r in ranks:
        np.testing.assert_allclose(r[("ppl_sp", sp)], jax_out["ppl_sp"], rtol=2e-5)
        np.testing.assert_allclose(r[("ppl_sp", sp)], want, rtol=2e-5)


def test_sp_forward_gqa_matches_and_window_raises(worlds):
    ranks, _, spec = worlds
    with torch.inference_mode():
        ref, _ = family_for("llama").forward(spec["gqa_params"], torch.from_numpy(
            spec["gqa_ids"]), spec["gqa_cfg"])
    for r in ranks:
        np.testing.assert_allclose(r["gqa_sp"], ref.numpy(), rtol=2e-4, atol=2e-4)
        assert r["window_raises"] == "NotImplementedError"


@pytest.mark.parametrize("tree", ["dense", "v2"])
@pytest.mark.parametrize("pp", [2, 4])
def test_pipeline_forward_matches_jax_and_single_device(worlds, pp, tree):
    ranks, jax_out, spec = worlds
    params = spec["pp_trees"][tree]
    with torch.inference_mode():
        ref, _ = family_for("llama").forward(params, torch.from_numpy(spec["pp_ids"]),
                                             spec["pp_cfg"])
    for r in ranks:  # the logits replicated on every stage
        got = r[("pp", tree, pp)]
        np.testing.assert_allclose(got, jax_out[("pp", tree)], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, ref.numpy(), rtol=2e-5, atol=2e-5)


def test_pipeline_forward_rejects_bad_shapes(worlds):
    ranks, jax_out, _ = worlds
    for key in ("pp_indivisible_layers", "pp_unstacked"):
        assert jax_out[key] == "ValueError"
        assert all(r[key] == "ValueError" for r in ranks)
    assert all(r["pp_indivisible_batch"] == "ValueError" for r in ranks)


def test_run_eval_sp_prints_the_perplexity_of_sp_1(worlds, capsys, monkeypatch):
    from pb_llm_tpu_torch.cli import run_eval
    from pb_llm_tpu_torch.ops import kernel_config as tkc

    monkeypatch.setattr(tkc, "_field_overrides", {})
    assert run_eval.main(RUN_EVAL + ["--sp", "1"]) == 0
    want = capsys.readouterr().out
    ranks, _, _ = worlds

    def ppl(out):
        return float(next(line for line in out.splitlines()
                          if "perplexity:" in line).split(":")[1])

    got = ranks[0]["run_eval"]
    assert got.startswith("sp backend gloo")
    np.testing.assert_allclose(ppl(got), ppl(want), rtol=2e-5)
    assert all(r["run_eval"] == "" for r in ranks[1:])  # rank 0 prints


def test_cross_entropy_shifted_matches_jax():
    from pb_llm_tpu.eval.ppl import cross_entropy_shifted as jce

    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 9, 17)).astype(np.float32)
    targets = rng.integers(0, 17, size=(2, 9))
    got = float(cross_entropy_shifted(torch.from_numpy(logits), torch.from_numpy(targets)))
    np.testing.assert_allclose(got, float(jce(jnp.asarray(logits), jnp.asarray(targets))),
                               rtol=1e-6)
