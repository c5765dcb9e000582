"""The port's QAT and eval CLIs on the CPU (`cli.run_qat`, `cli.run_eval
--tasks`), against the JAX package's.

`run_qat --synthetic` trains the JAX CLIs' tiny config (the port's weights
come from a torch generator, so the run's numbers are its own) and writes a
dense checkpoint in the JAX package's layout; the port's `run_eval` and the
JAX package's `run_eval` read it and print the same perplexity (rtol 1e-4:
f32 forwards, sums in another order) and, scoring the same hand-built
examples through `--tasks`, the same accuracies.  Nothing is downloaded:
`--tasks` takes its examples from a patched `load_task_examples`, and
without the `datasets` package it raises.
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from pb_llm_tpu.cli import run_eval as jrun_eval
from pb_llm_tpu.cli import run_qat as jrun_qat
from pb_llm_tpu.eval import tasks as J
from pb_llm_tpu.ops import kernel_config as jkc
from pb_llm_tpu_torch.calib.pipeline import save_masks
from pb_llm_tpu_torch.cli import run_eval, run_qat
from pb_llm_tpu_torch.eval import tasks as T
from pb_llm_tpu_torch.ops import kernel_config as tkc
from pb_llm_tpu_torch.utils.checkpoint import load_dense_checkpoint

torch.set_num_threads(2)

PPL_RTOL = 1e-4
MODEL = "facebook/opt-synth"


@pytest.fixture(autouse=True)
def _no_pins(monkeypatch):
    """Both run_evals pin the exact prefill process-wide: undone after each test."""
    monkeypatch.setattr(tkc, "_field_overrides", {})
    monkeypatch.setattr(jkc, "_field_overrides", {})


@pytest.fixture(scope="module")
def qat_ckpt(tmp_path_factory):
    out = tmp_path_factory.mktemp("qat")
    rc = run_qat.main(["--model_id", MODEL, "--dataset", "red_pajama", "--train_steps", "2",
                       "--seqlen", "32", "--out_dir", str(out), "--synthetic", "--device", "cpu"])
    assert rc == 0
    return str(out / MODEL / "xnor_outlier_0.1_2")


def _ppl(out: str) -> float:
    return float(re.search(r"wikitext2 perplexity: ([0-9.]+)", out).group(1))


def test_run_qat_writes_checkpoint_that_both_run_evals_read(qat_ckpt, capsys):
    params, extra = load_dense_checkpoint(qat_ckpt)
    assert extra["model_id"] == MODEL and np.isfinite(extra["final_loss"])
    with open(os.path.join(qat_ckpt, "manifest.json")) as fh:
        kinds = {k: v["kind"] for k, v in json.load(fh)["tree"].items()}
    assert kinds["params/layers/0/fc1"] == "dict" and kinds["params/layers/0/fc1/w"] == "array"
    args = [qat_ckpt, "--model_id", MODEL, "--synthetic", "--eval_ppl", "wikitext2", "--seqlen", "32",
            "--ppl_limit", "4"]
    assert run_eval.main(args + ["--device", "cpu"]) == 0
    got = _ppl(capsys.readouterr().out)
    assert jrun_eval.main(args) == 0
    want = _ppl(capsys.readouterr().out)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=PPL_RTOL)


def _examples(mod):
    fmt = mod.TASK_FORMATTERS
    return {"boolq": [fmt["boolq"]({"passage": f"The {w} is here.", "question": f"is the {w} here",
                                    "answer": i % 2}) for i, w in enumerate(["cat", "dog", "sun"])],
            "piqa": [fmt["piqa"]({"goal": f"open the {w}", "sol1": "twist it", "sol2": "hit it",
                                  "label": i % 2}) for i, w in enumerate(["jar", "door"])]}


def test_run_eval_tasks_matches_jax(qat_ckpt, capsys, monkeypatch):
    """`--tasks boolq,piqa --num_fewshot 1` on the QAT checkpoint: the same
    per-task acc lines and mean acc as the JAX CLI."""
    monkeypatch.setattr(T, "load_task_examples", lambda t, split="validation": _examples(T)[t])
    monkeypatch.setattr(J, "load_task_examples", lambda t, split="validation": _examples(J)[t])
    args = [qat_ckpt, "--model_id", MODEL, "--synthetic", "--eval_ppl", "", "--tasks",
            "boolq,piqa", "--num_fewshot", "1"]
    assert run_eval.main(args + ["--device", "cpu"]) == 0
    got = [line for line in capsys.readouterr().out.splitlines() if "acc" in line]
    assert jrun_eval.main(args) == 0
    want = [line for line in capsys.readouterr().out.splitlines() if "acc" in line]
    assert got == want and len(got) == 3 and got[-1].startswith("mean acc: ")


def test_run_eval_tasks_without_datasets_raises(qat_ckpt, monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="datasets"):
        run_eval.main([qat_ckpt, "--model_id", MODEL, "--synthetic", "--eval_ppl", "",
                       "--tasks", "boolq", "--device", "cpu"])


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs, a.const,
                     type(a).__name__) for a in parser._actions if a.dest != "help"}


def test_run_qat_flags_equal_jax_plus_device():
    got, want = _actions(run_qat.build_parser()), _actions(jrun_qat.build_parser())
    assert got.pop("device") == (("--device",), None, None, str, None, None, "_StoreAction")
    assert got == want


@pytest.mark.parametrize("flag", [["--dp", "2", "--tp", "2"], ["--dp", "2", "--tp", "2", "--fsdp"],
                                  ["--fsdp"]])
def test_run_qat_across_ranks_writes_the_one_process_loss(flag, tmp_path, qat_ckpt, capfd):
    """--dp 2 --tp 2 (with and without --fsdp) trains on four gloo ranks
    the CLI spawns; rank 0 prints the backend line and writes the dense
    checkpoint, gathered from the blocks, whose final loss is within rtol
    1e-5 of the one-process run's (`qat_ckpt`; the order of sums differs
    across ranks).  --fsdp at dp = tp = 1 trains on one device, as JAX's
    CLI does (it takes the mesh only when dp·tp > 1): the same final loss."""
    assert run_qat.main(["--model_id", MODEL, "--dataset", "red_pajama", "--train_steps", "2",
                         "--seqlen", "32", "--out_dir", str(tmp_path), "--synthetic",
                         "--device", "cpu", *flag]) == 0
    got, extra = load_dense_checkpoint(str(tmp_path / MODEL / "xnor_outlier_0.1_2"))
    want, want_extra = load_dense_checkpoint(qat_ckpt)
    assert np.isfinite(extra["final_loss"])
    if flag == ["--fsdp"]:
        assert extra["final_loss"] == want_extra["final_loss"]
        return
    assert "dp x tp backend gloo: 4 ranks on the CPU" in capfd.readouterr().out
    np.testing.assert_allclose(extra["final_loss"], want_extra["final_loss"], rtol=1e-5)
    assert torch.equal(got["embed_tokens"], want["embed_tokens"])
    for i, lp in enumerate(want["layers"]):
        for name in ("q_proj", "out_proj", "fc1", "fc2"):
            assert got["layers"][i][name]["w"].shape == lp[name]["w"].shape


def test_run_qat_gptq_masks_hessian_variant(tmp_path, capsys):
    """--gptq_masks (run_ptq's masks file) with the hessian variant: the QAT
    masks are the GPTQ-PB masks inverted, so mean_bit is 1 + the CSR bits
    of their complement."""
    from pb_llm_tpu_torch.core.packing import csr_sidecar_bits
    from pb_llm_tpu_torch.data.synthetic import synthetic_model
    from pb_llm_tpu_torch.models.registry import family_for

    cfg, params = synthetic_model("opt", device="cpu")
    rng = np.random.default_rng(0)
    masks, bits, n = {}, 0.0, 0
    for i, lp in enumerate(params["layers"]):
        for name in family_for(MODEL).linear_names:
            ic, oc = lp[name]["w"].shape
            m = rng.random((oc, ic)) < 0.8  # binarized
            masks[f"layer_{i}/{name}"] = m
            bits += (1.0 + csr_sidecar_bits(~m)) * m.size
            n += m.size
    path = str(tmp_path / "masks.npz")
    save_masks(path, masks, 0.8)
    rc = run_qat.main(["--model_id", MODEL, "--synthetic", "--device", "cpu", "--train_steps", "2",
                       "--seqlen", "16", "--binarization_method", "xnor_outlier_hessian",
                       "--gptq_masks", path, "--out_dir", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"mean_bit: {bits / n} frac: {bits / n / 16}" in out


def test_run_qat_save_hf(tmp_path, capsys):
    """--save_hf writes an HF directory that `from_pretrained` reads back as
    the dense checkpoint's tree."""
    pytest.importorskip("transformers")
    from pb_llm_tpu_torch.models.hf_import import from_pretrained

    rc = run_qat.main(["--model_id", MODEL, "--synthetic", "--device", "cpu", "--train_steps", "2",
                       "--seqlen", "16", "--out_dir", str(tmp_path), "--save_hf"])
    assert rc == 0
    save_dir = str(tmp_path / MODEL / "xnor_outlier_0.1_2")
    assert "HF checkpoint saved" in capsys.readouterr().out
    dense, _ = load_dense_checkpoint(save_dir)
    hf, _, family = from_pretrained(save_dir + "_hf")
    assert family == "opt"
    for i, lp in enumerate(dense["layers"]):
        for name in ("q_proj", "fc1", "fc2"):
            assert torch.equal(hf["layers"][i][name]["w"], lp[name]["w"])
            assert torch.equal(hf["layers"][i][name]["b"], lp[name]["b"])
    assert torch.equal(hf["embed_tokens"], dense["embed_tokens"])
