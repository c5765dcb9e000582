"""Port parity for the PBW-v1 producer: `calib.pipeline.quantize_model_ptq(
fmt="packed")` on an OPT against the JAX pipeline on the same JAX-drawn
weights (element masks identical, ppl within 5e-4 relative, the bound of
the JAX golden test tests/test_cli.py), and the CLI flow `run_ptq
facebook/opt-synth … --format packed --save_pbw` → `serve --pbw` →
`run_eval` on the CPU (the mirror of tests/test_cli.py:11-30, :137-152)."""

import jax
import numpy as np
import pytest
import torch

from pb_llm_tpu.calib import pipeline as jpipeline
from pb_llm_tpu.calib import solver as jsolver
from pb_llm_tpu.data import loaders as jloaders
from pb_llm_tpu.data import synthetic as jsynthetic
from pb_llm_tpu.eval import ppl as jppl
from pb_llm_tpu.models import opt as jopt
from pb_llm_tpu.models.registry import family_for as jfamily_for
from pb_llm_tpu.ops import binary_matmul as _jbm  # noqa: F401  (registers the JAX dispatch)
from pb_llm_tpu.ops import kernel_config as jkc
from pb_llm_tpu_torch.calib import pipeline as tpipeline
from pb_llm_tpu_torch.calib import solver as tsolver
from pb_llm_tpu_torch.core.pbw import PackedLinear
from pb_llm_tpu_torch.eval import ppl as tppl
from pb_llm_tpu_torch.interop import from_jax_params
from pb_llm_tpu_torch.models import opt as topt
from pb_llm_tpu_torch.models.registry import family_for
from pb_llm_tpu_torch.ops import kernel_config as tkc

torch.set_num_threads(2)

SEQLEN = 128


def _tcfg(jcfg):
    return topt.OPTConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "ffn_dim", "num_hidden_layers", "num_attention_heads",
        "max_position_embeddings")})


def _pipelines(hidden, scfg_kw, jkernels, tkernels, nsamples=2):
    """The same PTQ (fmt "packed") + ppl protocol through both packages on
    the same JAX-drawn OPT → ((ppl, report, params) of JAX, of the port)."""
    jcfg = jopt.OPTConfig(vocab_size=259, hidden_size=hidden, ffn_dim=2 * hidden,
                          num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=256)
    calib, evaltok = jloaders.get_loaders("wikitext2", jsynthetic.ByteTokenizer(),
                                          nsamples=nsamples, seqlen=SEQLEN,
                                          source=jsynthetic.synthetic_source())
    jparams = jopt.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams))
    tcfg = _tcfg(jcfg)
    with jkc.use_kernels(jkernels):
        jp, jrep = jpipeline.quantize_model_ptq(jparams, jcfg, jfamily_for("opt"), calib,
                                                jsolver.SolverConfig(**scfg_kw), fmt="packed",
                                                log=None)
        jppl_ = jppl.perplexity(jp, jcfg, jfamily_for("opt").forward, evaltok, seqlen=SEQLEN,
                                window_batch=2)
    with tkc.use_kernels(tkernels):
        tp, trep = tpipeline.quantize_model_ptq(tparams, tcfg, family_for("opt"), calib,
                                                tsolver.SolverConfig(**scfg_kw), fmt="packed",
                                                log=None)
        tppl_ = tppl.perplexity(tp, tcfg, family_for("opt").forward, evaltok, seqlen=SEQLEN,
                                window_batch=2)
    return (jppl_, jrep, jp), (tppl_, trep, tp)


def _check(jax_side, port_side):
    (jppl_, jrep, _), (tppl_, trep, tp) = jax_side, port_side
    assert sorted(trep.masks) == sorted(jrep.masks) and len(jrep.masks) == 12
    for k in jrep.masks:
        np.testing.assert_array_equal(trep.masks[k], jrep.masks[k], err_msg=k)
    assert all(isinstance(lp[n], PackedLinear) for lp in tp["layers"] for n in topt.LINEAR_NAMES)
    assert abs(tppl_ - jppl_) / jppl_ < 5e-4, (tppl_, jppl_)


@pytest.mark.parametrize("scfg_kw", [
    dict(low_frac=0.5),
    dict(low_frac=0.9, salient_metric="hessian", groupsize=32, high_bit=4),
], ids=["cli", "hessian_groups_nibbles"])
def test_pipeline_matches_jax_at_the_cli_config(scfg_kw, monkeypatch):
    """The CLIs' synthetic OPT (hidden 64): the CPU "auto" arms on both
    sides (the reference matmul)."""
    monkeypatch.setattr(tkc, "_field_overrides", {})
    _check(*_pipelines(64, scfg_kw, jkc.KernelConfig(), tkc.KernelConfig()))


def test_pipeline_matches_jax_through_the_kernels(monkeypatch):
    """hidden 128, groups of 64: calibration (m = 2·128 per propagate: the
    select arm) and the eval through the JAX Pallas kernels in interpret
    mode against the port's plain versions."""
    monkeypatch.setattr(tkc, "_field_overrides", {})
    arms = dict(backend="pallas_interpret", attention="xla")
    _check(*_pipelines(128, dict(low_frac=0.9, groupsize=64, blocksize=64),
                       jkc.KernelConfig(**arms), tkc.KernelConfig(**arms)))


def _ppl(out, ds):
    return float(out.split(f"{ds} perplexity: ")[1].split()[0])


@pytest.mark.parametrize("extra", [[], ["--groupsize", "32", "--high_bit", "4", "--salient_metric",
                                        "hessian"]], ids=["default", "groups_nibbles"])
def test_run_ptq_packed_then_serve_and_eval(tmp_path, capsys, monkeypatch, extra):
    from pb_llm_tpu_torch.cli import run_eval, run_ptq, serve
    from pb_llm_tpu_torch.core.pbw import load_pbw

    monkeypatch.setattr(tkc, "_field_overrides", {})
    ck = str(tmp_path / "pbw")
    assert run_ptq.main(["facebook/opt-synth", "wikitext2", "xnor", "--low_frac", "0.5",
                         "--synthetic", "--nsamples", "2", "--format", "packed", "--device", "cpu",
                         "--save_pbw", ck, *extra]) == 0
    out = capsys.readouterr().out
    ppl = {ds: _ppl(out, ds) for ds in ("wikitext2", "ptb", "c4")}
    assert all(np.isfinite(v) and 1.0 < v < 259.0 * 2 for v in ppl.values())
    layers, meta = load_pbw(ck)
    assert len(layers) == 12 and meta["model"] == "facebook/opt-synth"
    assert all(isinstance(p, PackedLinear) for p in layers.values())
    assert all(p.sidecar_bits == (4 if extra else 8) for p in layers.values())
    assert serve.main(["--model_id", "facebook/opt-synth", "--synthetic", "--pbw", ck,
                       "--device", "cpu", "--n_requests", "3", "--max_new_tokens", "2"]) == 0
    assert "requests=3 tokens=6" in capsys.readouterr().out
    assert run_eval.main([ck, "--model_id", "facebook/opt-synth", "--synthetic", "--eval_ppl",
                          "wikitext2", "--flavor", "ptq", "--seqlen", "128", "--device", "cpu"]) == 0
    assert _ppl(capsys.readouterr().out, "wikitext2") == pytest.approx(ppl["wikitext2"], rel=1e-6)


def test_serve_cli_opt_demo_with_draft(capsys):
    from pb_llm_tpu_torch.cli import serve

    assert serve.main(["--model_id", "facebook/opt-synth", "--synthetic", "--demo", "--device",
                       "cpu", "--n_requests", "3", "--max_new_tokens", "3", "--page_size", "8",
                       "--spec_gamma", "2", "--draft_synthetic"]) == 0
    assert "requests=3 tokens=9" in capsys.readouterr().out
