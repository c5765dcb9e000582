"""Port parity for the producer path: quantizers, Hessian fold, GPTQ-PB
solver, loaders, the PTQ pipeline and windowed perplexity, each against
the JAX package on the same numpy-seeded inputs.

Tolerances: the quantizers sum in the order XLA:CPU compiles (`quant.
reduce`), so their states are bit for bit equal to the JAX functions as
the JAX solver runs them (jitted: divisions by constants become f32
reciprocal products).  The Hessian fold's products sum in another order:
f32 rounding (rtol 1e-5).  Solver masks are bit-identical; w_q and the
error, which go through two Cholesky factorizations and the column loop in
another summation order, agree to 1e-5 of their norms.  Pipeline ppl:
5e-4 relative, the bound of the JAX golden test (tests/test_cli.py).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.calib import hessian as jhessian
from pb_llm_tpu.calib import pipeline as jpipeline
from pb_llm_tpu.calib import solver as jsolver
from pb_llm_tpu.data import loaders as jloaders
from pb_llm_tpu.data import synthetic as jsynthetic
from pb_llm_tpu.eval import ppl as jppl
from pb_llm_tpu.models import llama as jllama
from pb_llm_tpu.models.registry import family_for as jfamily_for
from pb_llm_tpu.ops import binary_matmul as _jbm  # noqa: F401  (registers the JAX dispatch)
from pb_llm_tpu.ops import kernel_config as jkc
from pb_llm_tpu.quant import high_quant as jhq
from pb_llm_tpu.quant import low_quant as jlq
from pb_llm_tpu_torch import no_tf32
from pb_llm_tpu_torch.calib import hessian as thessian
from pb_llm_tpu_torch.calib import pipeline as tpipeline
from pb_llm_tpu_torch.calib import solver as tsolver
from pb_llm_tpu_torch.core.pbw import PackedLinearV2
from pb_llm_tpu_torch.data import loaders as tloaders
from pb_llm_tpu_torch.data import synthetic as tsynthetic
from pb_llm_tpu_torch.eval import ppl as tppl
from pb_llm_tpu_torch.interop import from_jax_params
from pb_llm_tpu_torch.models import llama as tllama
from pb_llm_tpu_torch.models.registry import family_for
from pb_llm_tpu_torch.ops import kernel_config as tkc
from pb_llm_tpu_torch.quant import high_quant as thq
from pb_llm_tpu_torch.quant import low_quant as tlq
from pb_llm_tpu_torch.quant.reduce import tree_sum

torch.set_num_threads(2)

T = torch.from_numpy


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _weights(oc, ic, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((oc, ic)).astype(np.float32)
    return w * (1.0 + 3.0 * (rng.random(ic) < 0.1))[None, :]


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [7, 32, 64, 416, 1000, 4096])
def test_tree_sum_matches_xla(n):
    x = np.random.default_rng(n).standard_normal((16, n)).astype(np.float32)
    np.testing.assert_array_equal(tree_sum(T(x)).numpy(), np.asarray(jnp.sum(jnp.asarray(x), axis=-1)))


@pytest.mark.parametrize("groupsize", [-1, 64])
@pytest.mark.parametrize("method", jlq.LOW_METHODS)
def test_low_quant_bit_identical(method, groupsize):
    w = _weights(96, 192, seed=1) * (np.random.default_rng(2).random((96, 192)) < 0.8)
    jcal = jax.jit(jlq.low_calibrate, static_argnums=(1, 2))
    want = jcal(jnp.asarray(w), method, groupsize)
    got = tlq.low_calibrate(T(w), method, groupsize)
    for k in ("scale", "mean", "zero"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    jq = jax.jit(jlq.low_quantize, static_argnums=(2, 3))
    np.testing.assert_array_equal(tlq.low_quantize(T(w), got, method, groupsize).numpy(),
                                  np.asarray(jq(jnp.asarray(w), want, method, groupsize)))


@pytest.mark.parametrize("sym,mse", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("bits", [4, 8])
def test_high_quant_bit_identical(sym, mse, bits):
    w = _weights(64, 128, seed=3)
    w[5] = 0.0  # a degenerate row
    jcal = jax.jit(jhq.high_calibrate, static_argnames=("bits", "sym", "mse"))
    want = jcal(jnp.asarray(w), bits=bits, sym=sym, mse=mse)
    got = thq.high_calibrate(T(w), bits=bits, sym=sym, mse=mse)
    for k in ("scale", "zero", "maxq"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(thq.high_quantize(T(w), got).numpy(),
                                  np.asarray(jhq.high_quantize(jnp.asarray(w), want)))
    np.testing.assert_array_equal(thq.high_codes(T(w), got).numpy(),
                                  np.asarray(jhq.high_codes(jnp.asarray(w), want)))


# ---------------------------------------------------------------------------
# Hessian and solver
# ---------------------------------------------------------------------------


def test_fold_coefficients_equal():
    for start, batch in ((0, 4), (5, 3)):
        for a, b in zip(thessian.fold_coefficients(start, batch), jhessian.fold_coefficients(start, batch)):
            np.testing.assert_array_equal(a, b)


def test_hessian_fold_chunk_matches_jax():
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((3, 40, 48)).astype(np.float32)
    h0 = np.zeros((48, 48), np.float32)
    a, b = jhessian.fold_coefficients(0, 3)
    want = np.asarray(jhessian.hessian_fold_chunk(jnp.asarray(h0), jnp.asarray(xs), jnp.asarray(a),
                                                  jnp.asarray(b)))
    got = thessian.hessian_fold_chunk(T(h0), T(xs), a, b).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # batched folds equal the sequential protocol
    h1 = thessian.hessian_fold_chunk(T(h0), T(xs[:2]), *thessian.fold_coefficients(0, 2))
    h1 = thessian.hessian_fold_chunk(h1, T(xs[2:]), *thessian.fold_coefficients(2, 1))
    np.testing.assert_array_equal(h1.numpy(), got)


def _wh(oc, ic, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4 * ic, ic)).astype(np.float32)
    x *= (1.0 + 2.0 * (rng.random(ic) < 0.2))[None, :]
    x[:, 3] = 0.0  # a dead input column
    return _weights(oc, ic, seed), (2.0 / x.shape[0]) * (x.T @ x)


SOLVER_CASES = {
    "magnitude-element": dict(salient_metric="magnitude"),
    "hessian-element": dict(salient_metric="hessian"),
    "magnitude-column": dict(salient_metric="magnitude", mask_structure="column"),
    "hessian-column": dict(salient_metric="hessian", mask_structure="column"),
    "magnitude-column-ct64": dict(salient_metric="magnitude", mask_structure="column", col_tile=64),
    "hessian-column-ct64": dict(salient_metric="hessian", mask_structure="column", col_tile=64),
    "rtn-4bit": dict(low_method="4bit", disable_gptq=True, salient_metric="hessian"),
}


@pytest.mark.parametrize("case", sorted(SOLVER_CASES))
def test_gptq_pb_matches_jax(case):
    w, h = _wh(128, 192, seed=5)
    kw = dict(low_frac=0.8, blocksize=64, **SOLVER_CASES[case])
    want = jsolver.gptq_pb(jnp.asarray(w), jnp.asarray(h), jsolver.SolverConfig(**kw))
    got = tsolver.gptq_pb(T(w), T(h), tsolver.SolverConfig(**kw))
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    for k in ("low_state", "high_state"):
        for f in got[k]:
            np.testing.assert_array_equal(got[k][f].numpy(), np.asarray(want[k][f]), err_msg=f)
    wq_want = np.asarray(want["w_q"])
    assert np.linalg.norm(got["w_q"].numpy() - wq_want) <= 1e-5 * np.linalg.norm(wq_want)
    assert abs(float(got["error"]) - float(want["error"])) <= 1e-5 * abs(float(want["error"]))


def test_no_tf32_restores_the_callers_setting():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with no_tf32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flavor", ["ptq", "qat"])
@pytest.mark.parametrize("name", ["wikitext2", "ptb", "c4", "mix"])
def test_loaders_token_identical(name, flavor):
    tok = tsynthetic.ByteTokenizer()
    want = jloaders.get_loaders(name, jsynthetic.ByteTokenizer(), nsamples=5, seed=3, seqlen=64,
                                flavor=flavor, source=jsynthetic.synthetic_source(40))
    got = tloaders.get_loaders(name, tok, nsamples=5, seed=3, seqlen=64, flavor=flavor,
                               source=tsynthetic.synthetic_source(40))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["wikitext2", "ptb", "c4"])
def test_eval_tokens_identical(name):
    want = jloaders.get_eval_tokens(name, jsynthetic.ByteTokenizer(), jsynthetic.synthetic_source(30))
    got = tloaders.get_eval_tokens(name, tsynthetic.ByteTokenizer(), tsynthetic.synthetic_source(30))
    np.testing.assert_array_equal(got, want)


def test_text_source_without_texts_raises():
    with pytest.raises(FileNotFoundError, match="no text for wikitext2/train"):
        tloaders.get_loaders("wikitext2", tsynthetic.ByteTokenizer(), source=tloaders.TextSource())


def test_loader_cache_roundtrip(tmp_path):
    kw = dict(nsamples=2, seqlen=32, source=tsynthetic.synthetic_source(20), cache_dir=str(tmp_path))
    first = tloaders.get_loaders("ptb", tsynthetic.ByteTokenizer(), **kw)
    again = tloaders.get_loaders("ptb", tsynthetic.ByteTokenizer(), **kw)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the pipeline: JAX weights → PTQ → PBW v2 → perplexity, both packages
# ---------------------------------------------------------------------------


def _tcfg(jcfg):
    return tllama.LlamaConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "max_position_embeddings")})


def _pipelines(jcfg, seqlen, nsamples, window_limit, window_batch, jkernels, tkernels, scfg_kw,
               jeval_kernels=None):
    """The same PTQ + ppl protocol through both packages → (jax, port)
    (ppl, masks, params).  ``jeval_kernels``: the JAX eval's arms, run
    without jit (see test_pipeline_matches_jax_through_the_kernels)."""
    source_j, source_t = jsynthetic.synthetic_source(), tsynthetic.synthetic_source()
    calib, evaltok = jloaders.get_loaders("wikitext2", jsynthetic.ByteTokenizer(), nsamples=nsamples,
                                          seqlen=seqlen, source=source_j)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(_np(jparams))
    jscfg = jsolver.SolverConfig(mask_structure="column", **scfg_kw)
    tscfg = tsolver.SolverConfig(mask_structure="column", **scfg_kw)
    jfam, tfam = jfamily_for("llama"), family_for("llama")
    tcfg = _tcfg(jcfg)
    with jkc.use_kernels(jkernels):
        jp, jrep = jpipeline.quantize_model_ptq(jparams, jcfg, jfam, calib, jscfg, fmt="packed_v2",
                                                log=None)
    eval_ctx = (contextlib.nullcontext() if jeval_kernels is None else jax.disable_jit())
    with jkc.use_kernels(jeval_kernels or jkernels), eval_ctx:
        jppl_ = jppl.perplexity(jp, jcfg, jfam.forward, evaltok, seqlen=seqlen,
                                window_limit=window_limit, window_batch=window_batch)
    with tkc.use_kernels(tkernels):
        tp, trep = tpipeline.quantize_model_ptq(tparams, tcfg, tfam, calib, tscfg, fmt="packed_v2",
                                                log=None)
        tppl_ = tppl.perplexity(tp, tcfg, tfam.forward, evaltok, seqlen=seqlen,
                                window_limit=window_limit, window_batch=window_batch)
    return (jppl_, jrep, jp), (tppl_, trep, tp)


def _check(jax_side, port_side):
    (jppl_, jrep, _), (tppl_, trep, tp) = jax_side, port_side
    assert sorted(trep.masks) == sorted(jrep.masks)
    for k in jrep.masks:
        np.testing.assert_array_equal(trep.masks[k], jrep.masks[k], err_msg=k)
    assert all(isinstance(tp["layers"][i][n], PackedLinearV2)
               for i in range(2) for n in tllama.LINEAR_NAMES)
    assert abs(tppl_ - jppl_) / jppl_ < 5e-4, (tppl_, jppl_)


def test_pipeline_matches_jax_at_the_cli_config(monkeypatch):
    """The CLIs' synthetic llama (hidden 64): CPU "auto" arms on both sides
    (the reference matmul and the masked softmax)."""
    monkeypatch.setattr(tkc, "_field_overrides", {})
    jcfg = jllama.LlamaConfig(vocab_size=259, hidden_size=64, intermediate_size=128,
                              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                              max_position_embeddings=256)
    tkc.pin_exact_prefill()
    _check(*_pipelines(jcfg, seqlen=128, nsamples=2, window_limit=None, window_batch=4,
                       jkernels=jkc.KernelConfig(prefill="hybrid"),
                       tkernels=tkc.current(), scfg_kw=dict(low_frac=0.5)))


KERNEL_ARMS = dict(backend="pallas_interpret", decode_dot="f32", prefill="hybrid")


def _kernel_pipelines(scfg_kw, nsamples=2, calib_attention="flash_interpret"):
    """The hidden-128 llama through both packages on the kernels' arms: the
    JAX interpret-mode hybrid prefill and flash kernel against the port's
    plain versions.  JAX's flash arm calls float() on the softmax scale,
    which is traced inside jit (ROADMAP Queue 3), so the JAX calibration
    attends with the masked softmax (the port's with ``calib_attention``)
    and the JAX eval runs its flash kernel without jit."""
    jcfg = jllama.LlamaConfig(vocab_size=259, hidden_size=128, intermediate_size=256,
                              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                              max_position_embeddings=256)
    return _pipelines(jcfg, seqlen=128, nsamples=nsamples, window_limit=2, window_batch=2,
                      jkernels=jkc.KernelConfig(attention="xla", **KERNEL_ARMS),
                      tkernels=tkc.KernelConfig(attention=calib_attention, **KERNEL_ARMS),
                      scfg_kw=scfg_kw,
                      jeval_kernels=jkc.KernelConfig(attention="flash_interpret", **KERNEL_ARMS))


def _sign_bits_apart(jax_side, port_side) -> int:
    """Binary sign bits that differ between the two packed models."""
    jp, tp = jax_side[2], port_side[2]
    n = 0
    for jl, tl in zip(jp["layers"], tp["layers"]):
        for name in tllama.LINEAR_NAMES:
            a = np.asarray(jl[name].sign_packed).view(np.uint32)
            b = tl[name].sign_packed.numpy().view(np.uint32)
            n += int(np.unpackbits(np.bitwise_xor(a, b).view(np.uint8)).sum())
    return n


def test_pipeline_matches_jax_through_the_kernels(monkeypatch):
    """hidden 128, the RTN arm: the hybrid prefill (its dequant kernel) and
    flash plain versions inside calibration (m = 2·128 per propagate) and
    the eval.  Without GPTQ's error feedback the two packed models agree
    bit for bit, so this holds the kernels' arms alone."""
    monkeypatch.setattr(tkc, "_field_overrides", {})
    _check(*_kernel_pipelines(dict(low_frac=0.9, salient_metric="hessian", disable_gptq=True)))


def test_pipeline_matches_jax_through_the_kernels_with_gptq(monkeypatch):
    """hidden 128, GPTQ-PB with magnitude saliency, the same calibration
    arms on both sides: the column loop's error feedback and the kernels'
    plain versions together against JAX.  The feedback turns the f32
    rounding differences of the two propagate passes into a few flipped
    sign bits of layer 1 (33 of 327680 here), so the packed models are
    compared by their masks (identical) and their ppl (5e-4).  Readings of
    the other settings: `python -m tests.test_torch_ptq`."""
    monkeypatch.setattr(tkc, "_field_overrides", {})
    jax_side, port_side = _kernel_pipelines(dict(low_frac=0.9, salient_metric="magnitude"),
                                            nsamples=4, calib_attention="xla")
    _check(jax_side, port_side)
    assert _sign_bits_apart(jax_side, port_side) < 200


def test_resume_dir_skips_solved_layers(tmp_path):
    jcfg = jllama.LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                              num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=64)
    tcfg = _tcfg(jcfg)
    calib = np.random.default_rng(0).integers(0, 64, size=(2, 32))
    scfg = tsolver.SolverConfig(mask_structure="column", low_frac=0.5)
    params = from_jax_params(_np(jllama.init_params(jcfg, jax.random.PRNGKey(1))))
    first, rep1 = tpipeline.quantize_model_ptq(params, tcfg, family_for("llama"), calib, scfg,
                                               fmt="packed_v2", log=None, resume_dir=str(tmp_path))
    params = from_jax_params(_np(jllama.init_params(jcfg, jax.random.PRNGKey(1))))
    lines = []
    again, rep2 = tpipeline.quantize_model_ptq(params, tcfg, family_for("llama"), calib, scfg,
                                               fmt="packed_v2", log=lines.append,
                                               resume_dir=str(tmp_path))
    assert sum("resumed from checkpoint" in m for m in lines) == 2
    assert rep2.errors == rep1.errors
    for k in rep1.masks:
        np.testing.assert_array_equal(rep2.masks[k], rep1.masks[k])
    ids = torch.as_tensor(calib)
    torch.testing.assert_close(tllama.forward(again, ids, tcfg)[0], tllama.forward(first, ids, tcfg)[0],
                               rtol=0, atol=0)
    path = str(tmp_path / "masks.npz")
    tpipeline.save_masks(path, rep1.masks, 0.5)
    masks, low_frac = tpipeline.load_masks(path)
    assert low_frac == 0.5 and sorted(masks) == sorted(rep1.masks)


def test_unported_pipeline_paths_raise():
    """The streamed pipeline writes packed formats only, and PBW v2 only
    from column masks (as in JAX)."""
    with pytest.raises(ValueError, match="packed formats only"):
        tpipeline.quantize_model_ptq_streamed(None, None, None, None, tsolver.SolverConfig(),
                                              "unused", fmt="sim")
    with pytest.raises(ValueError, match="mask_structure='column'"):
        tpipeline.quantize_model_ptq_streamed(None, None, None, None,
                                              tsolver.SolverConfig(mask_structure="element"),
                                              "unused", fmt="packed_v2")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_run_ptq_then_serve_the_checkpoint(tmp_path, capsys, monkeypatch):
    from pb_llm_tpu_torch.cli import run_eval, run_ptq, serve

    monkeypatch.setattr(tkc, "_field_overrides", {})
    ck = str(tmp_path / "pbw")
    assert run_ptq.main(["huggyllama/llama-7b", "wikitext2", "xnor", "--low_frac", "0.5",
                         "--synthetic", "--nsamples", "2", "--format", "packed_v2",
                         "--device", "cpu", "--save_pbw", ck]) == 0
    out = capsys.readouterr().out
    ppl = {ds: float(out.split(f"{ds} perplexity: ")[1].split()[0]) for ds in ("wikitext2", "ptb", "c4")}
    assert all(np.isfinite(v) and 1.0 < v < 259.0 * 2 for v in ppl.values())
    assert tkc.current().prefill == "hybrid"  # pinned by the CLI
    assert serve.main(["--model_id", "llama", "--synthetic", "--pbw", ck, "--device", "cpu",
                       "--n_requests", "3", "--max_new_tokens", "2"]) == 0
    assert "requests=3 tokens=6" in capsys.readouterr().out
    assert run_eval.main([ck, "--model_id", "llama", "--synthetic", "--eval_ppl", "wikitext2",
                          "--flavor", "ptq", "--seqlen", "128", "--device", "cpu"]) == 0
    again = float(capsys.readouterr().out.split("wikitext2 perplexity: ")[1].split()[0])
    assert again == pytest.approx(ppl["wikitext2"], rel=1e-6)


# argv → what run_ptq raises: a hub id where transformers is missing (it is
# blocked below, so nothing is fetched); --stream without --save_pbw, and
# with --synthetic
_PTQ_REFUSALS = {
    ("huggyllama/llama-7b", "wikitext2", "xnor", "--device", "cpu"):
        (RuntimeError, "needs transformers"),
    ("huggyllama/llama-7b", "wikitext2", "xnor", "--synthetic", "--stream", "--device", "cpu"):
        (SystemExit, "--stream requires --save_pbw"),
    ("huggyllama/llama-7b", "wikitext2", "xnor", "--synthetic", "--stream", "--save_pbw", "unused",
     "--device", "cpu"):
        (SystemExit, "drop --synthetic"),
}


@pytest.mark.parametrize("argv", [list(a) for a in _PTQ_REFUSALS])
def test_run_ptq_unported_options_raise(argv, monkeypatch):
    import sys

    from pb_llm_tpu_torch.cli import run_ptq

    monkeypatch.setattr(tkc, "_field_overrides", {})
    monkeypatch.setitem(sys.modules, "transformers", None)
    exc, match = _PTQ_REFUSALS[tuple(argv)]
    with pytest.raises(exc, match=match):
        run_ptq.main(argv)


@pytest.mark.parametrize("flag", [["--tasks", "boolq"]])
def test_run_eval_unported_options_raise(flag, monkeypatch):
    """--tasks is ported (eval/tasks.py), and without the `datasets` package
    it raises naming it (no download).  (--sp is ported: tests/
    test_torch_ring_pp.py.)"""
    import sys

    from pb_llm_tpu_torch.cli import run_eval

    monkeypatch.setitem(sys.modules, "datasets", None)
    exc, match = ImportError, "datasets"
    with pytest.raises(exc, match=match):
        run_eval.main(["--model_id", "llama", "--synthetic", "--device", "cpu", "--eval_ppl", "",
                       *flag])


def _gptq_readings():
    """Print, for GPTQ-PB settings through the kernels' arms, the ppl gap to
    JAX, the salient-mask columns and the sign bits that differ."""
    tkc._field_overrides = {}
    total = None
    for metric, nsamples, calib_attention in (("hessian", 2, "flash_interpret"), ("hessian", 2, "xla"),
                                              ("magnitude", 2, "flash_interpret"), ("magnitude", 2, "xla"),
                                              ("hessian", 4, "xla"), ("magnitude", 4, "xla")):
        jax_side, port_side = _kernel_pipelines(dict(low_frac=0.9, salient_metric=metric),
                                                nsamples=nsamples, calib_attention=calib_attention)
        jrep, trep = jax_side[1], port_side[1]
        cols = sum(int((trep.masks[k][0] != jrep.masks[k][0]).sum()) for k in jrep.masks)
        total = total or sum(p.sign_packed.numel() * 32 for lp in port_side[2]["layers"]
                             for p in (lp[n] for n in tllama.LINEAR_NAMES))
        print(f"{metric} nsamples {nsamples} port calibration attention {calib_attention}: "
              f"ppl {port_side[0]!r} vs JAX {jax_side[0]!r}, relative gap "
              f"{abs(port_side[0] - jax_side[0]) / jax_side[0]:.3e}; mask columns apart {cols}; "
              f"sign bits apart {_sign_bits_apart(jax_side, port_side)} of {total}", flush=True)


if __name__ == "__main__":
    _gptq_readings()
