"""The port's CLIs on HF checkpoint directories, on the CPU: `convert`,
`serve --model_id DIR` (with --pbw and the --draft_* flags), `run_ptq DIR`
(with --save, --load_quantized of the export, --stream), `run_eval
--model_id DIR`, and `utils.tokenizer` against the JAX package's.

Nothing is fetched: the directories are tiny models built in process and
saved with `transformers`; the tokenizer is stubbed (`AutoTokenizer`
returns the byte tokenizer), and where the CLIs read text datasets the
loaders' `TextSource` serves small synthetic corpora
(`data.synthetic.synthetic_texts`); without them they raise the port's
offline error.  Tolerances: a CLI equals the library calls it makes bit
for bit; run_eval's perplexity equals the JAX package's on the same
checkpoint within 5e-4 relative (tests/test_torch_ptq.py's bound).
"""

import re
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.eval import ppl as jppl
from pb_llm_tpu.models import hf_import as jhf
from pb_llm_tpu.models.registry import family_for as jfamily_for
from pb_llm_tpu.utils import tokenizer as jtokenizer
from pb_llm_tpu_torch.calib import pipeline as tpipeline
from pb_llm_tpu_torch.cli import convert, run_eval, run_ptq, serve
from pb_llm_tpu_torch.core import pbw as tpbw
from pb_llm_tpu_torch.core.config import PTQJobConfig
from pb_llm_tpu_torch.data import loaders as tloaders
from pb_llm_tpu_torch.data.synthetic import ByteTokenizer, synthetic_texts
from pb_llm_tpu_torch.models import hf_import as thf
from pb_llm_tpu_torch.models import hf_stream as tstream
from pb_llm_tpu_torch.models.registry import family_for
from pb_llm_tpu_torch.ops import kernel_config as tkc
from pb_llm_tpu_torch.utils import tokenizer as ttokenizer

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    """A 2-layer GQA llama at the CLIs' synthetic width (vocab 259, the byte
    tokenizer's), saved as sharded safetensors under a name with "llama"."""
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(vocab_size=259, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, max_position_embeddings=256)
    d = tmp_path_factory.mktemp("ckpt") / "tiny-llama"
    transformers.LlamaForCausalLM(cfg).eval().save_pretrained(str(d), max_shard_size="100KB")
    return str(d)


@pytest.fixture
def stub_tokenizer(monkeypatch):
    """`transformers.AutoTokenizer` → the byte tokenizer; records calls.
    The rest of `transformers` is absent: the paths under test need none."""
    calls = []

    class _Auto:
        @staticmethod
        def from_pretrained(model_id, use_fast=True):
            calls.append((model_id, use_fast))
            return ByteTokenizer()

    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(AutoTokenizer=_Auto))
    return calls


@pytest.fixture
def texts(monkeypatch):
    """Small synthetic corpora for every dataset/split the loaders read."""
    small = {}

    def get(self, dataset, split):
        key = f"{dataset}/{split}"
        return self.texts.get(key) or small.setdefault(key, synthetic_texts(6, len(small)))

    monkeypatch.setattr(tloaders.TextSource, "get", get)


@pytest.fixture(autouse=True)
def _unpinned(monkeypatch):
    monkeypatch.setattr(tkc, "_field_overrides", {})  # the CLIs pin the exact prefill


def ppls(out: str):
    return {ds: float(v) for ds, v in re.findall(r"(\w+) perplexity: (\S+)", out)}


def served(out: str):
    """The printed request lines and the stats line's tokens."""
    lines = [ln for ln in out.splitlines() if re.match(r"\[\d+\] ", ln)]
    return lines, re.search(r"requests=(\d+) tokens=(\d+)", out).groups()


# ---------------------------------------------------------------------------
# tokenizer: the four cases of tests/test_tokenizer.py, port and JAX alike
# ---------------------------------------------------------------------------


class _StubTok:
    def __init__(self, bos, eos, vocab=32000):
        self.bos_token_id, self.eos_token_id, self.vocab_size = bos, eos, vocab


TOKENIZER_CASES = {
    "llama_pinned": ("huggyllama/llama-7b", (0, 0), 32000, (1, 2)),
    "llama_untouched": ("decapoda-research/llama-7b-hf", (1, 2), 32000, (1, 2)),
    "opt_left_alone": ("facebook/opt-1.3b", (2, 2), 50272, (2, 2)),
    "llama3_left_alone": ("meta-llama/Meta-Llama-3-8B", (128000, 128001), 128256, (128000, 128001)),
}


@pytest.mark.parametrize("case", sorted(TOKENIZER_CASES))
def test_tokenizer_pin(monkeypatch, case):
    model_id, ids, vocab, want = TOKENIZER_CASES[case]
    calls = []

    class _Auto:
        @staticmethod
        def from_pretrained(mid, use_fast=True):
            calls.append((mid, use_fast))
            return _StubTok(*ids, vocab=vocab)

    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(AutoTokenizer=_Auto))
    for get in (ttokenizer.get_tokenizer, jtokenizer.get_tokenizer):
        tok = get(model_id)
        assert (tok.bos_token_id, tok.eos_token_id) == want
    assert calls == [(model_id, False)] * 2  # slow tokenizers: window parity


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------


def test_convert_cli(llama_dir, tmp_path, capsys):
    out = str(tmp_path / "pbw")
    assert convert.main([llama_dir, out, "--family", "llama", "--device", "cpu"]) == 0
    assert re.fullmatch(rf"packed 14 linears -> {re.escape(out)} in \d+\.\ds\n",
                        capsys.readouterr().out)
    layers, meta = tpbw.load_pbw(out)
    assert meta["family"] == "llama"
    lib = str(tmp_path / "lib")
    tstream.stream_pack_to_pbw(llama_dir, lib, "llama", pack_fn=tstream.rtn_pack_fn(device="cpu"))
    want, _ = tpbw.load_pbw(lib)
    for k, p in want.items():  # JAX's defaults: xnor, low_frac 0.9, 8-bit, packed_v2
        assert isinstance(layers[k], tpbw.PackedLinearV2) and layers[k].k_pad == p.k_pad
        for f in tpbw.fields_of(p):
            if getattr(p, f) is not None:
                assert torch.equal(getattr(layers[k], f), getattr(p, f)), (k, f)


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

SERVE = ["--device", "cpu", "--n_requests", "3", "--max_new_tokens", "6", "--max_seq", "128"]


def test_serve_hf_dir(llama_dir, tmp_path, stub_tokenizer, capsys):
    assert serve.main(["--model_id", llama_dir, "--demo", *SERVE]) == 0
    lines, stats = served(capsys.readouterr().out)
    assert stats == ("3", "18") and len(lines) == 3
    assert stub_tokenizer == [(llama_dir, False)]
    ck = str(tmp_path / "pbw")
    tstream.stream_pack_to_pbw(llama_dir, ck, "llama", pack_fn=tstream.rtn_pack_fn(device="cpu"))
    assert serve.main(["--model_id", llama_dir, "--pbw", ck, *SERVE]) == 0
    assert served(capsys.readouterr().out)[1] == ("3", "18")


def test_serve_self_draft_equals_plain(llama_dir, tmp_path, stub_tokenizer, capsys):
    """The model as its own draft (--draft_model_id DIR, --spec_gamma 2):
    greedy streams equal plain decoding; then the draft with its own
    PBW checkpoint over it (--draft_pbw)."""
    assert serve.main(["--model_id", llama_dir, *SERVE]) == 0
    plain = served(capsys.readouterr().out)
    assert serve.main(["--model_id", llama_dir, "--spec_gamma", "2",
                       "--draft_model_id", llama_dir, *SERVE]) == 0
    out = capsys.readouterr().out
    assert served(out) == plain
    drafted, accepted = map(int, re.search(r"spec drafted=(\d+) accepted=(\d+)", out).groups())
    assert drafted > 0 and accepted == drafted
    ck = str(tmp_path / "draft_pbw")
    tstream.stream_pack_to_pbw(llama_dir, ck, "llama", pack_fn=tstream.rtn_pack_fn(device="cpu"))
    assert serve.main(["--model_id", llama_dir, "--spec_gamma", "2", "--draft_model_id",
                       llama_dir, "--draft_pbw", ck, *SERVE]) == 0
    assert served(capsys.readouterr().out) == plain  # spec decoding keeps the target's stream


def test_serve_draft_checkpoint_needs_model_id(llama_dir):
    with pytest.raises(SystemExit, match="need --draft_model_id"):
        serve.main(["--model_id", llama_dir, "--spec_gamma", "2", "--draft_pbw", llama_dir,
                    *SERVE])


def test_family_comes_from_the_name(tmp_path, stub_tokenizer):
    """As in JAX, serve and run_eval take the family from --model_id's name
    (`family_for`) and drop the one from_pretrained reads: an OPT directory
    whose path names no family is refused (kept on purpose, ROADMAP Queue 3)."""
    cfg = transformers.OPTConfig(vocab_size=259, hidden_size=32, ffn_dim=64, num_hidden_layers=1,
                                 num_attention_heads=4, max_position_embeddings=64)
    d = str(tmp_path / "tiny-model")
    real = sys.modules.get("transformers")
    try:
        sys.modules["transformers"] = transformers
        transformers.OPTForCausalLM(cfg).save_pretrained(d)
    finally:
        sys.modules["transformers"] = real
    assert thf.from_pretrained(d)[2] == "opt"
    with pytest.raises(NotImplementedError, match="unknown model family"):
        serve.main(["--model_id", d, *SERVE])
    with pytest.raises(NotImplementedError, match="unknown model family"):
        run_eval.main(["--model_id", d, "--device", "cpu"])


# ---------------------------------------------------------------------------
# run_ptq
# ---------------------------------------------------------------------------


def test_run_ptq_save_then_load_quantized(tmp_path, texts, capsys):
    """The verify skill's check: --save exports an HF directory, and
    --load_quantized of it gives the same perplexities exactly."""
    save_dir = str(tmp_path / "export")
    base = ["huggyllama/llama-7b", "wikitext2", "xnor", "--synthetic", "--device", "cpu"]
    assert run_ptq.main([*base, "--low_frac", "0.5", "--nsamples", "2", "--save",
                         "--save_dir", save_dir]) == 0
    first = ppls(capsys.readouterr().out)
    assert thf.from_pretrained(save_dir)[2] == "llama"
    assert run_ptq.main([*base, "--load_quantized", save_dir]) == 0
    again = ppls(capsys.readouterr().out)
    assert sorted(first) == ["c4", "ptb", "wikitext2"] and again == first


def test_run_ptq_hf_dir(llama_dir, texts, stub_tokenizer, capsys):
    assert run_ptq.main([llama_dir, "wikitext2", "xnor", "--low_frac", "0.5", "--nsamples", "2",
                         "--format", "packed_v2", "--device", "cpu"]) == 0
    out = ppls(capsys.readouterr().out)
    assert sorted(out) == ["c4", "ptb", "wikitext2"]
    assert all(np.isfinite(v) and 1.0 < v < 2 * 259 for v in out.values())


def test_run_ptq_stream(llama_dir, tmp_path, texts, stub_tokenizer, capsys):
    """--stream --save_pbw: the streamed pipeline on the CLI's calibration
    windows, equal to the resident pipeline bit for bit."""
    out = str(tmp_path / "pbw")
    assert run_ptq.main([llama_dir, "wikitext2", "xnor", "--low_frac", "0.5", "--nsamples", "2",
                         "--format", "packed_v2", "--stream", "--save_pbw", out,
                         "--device", "cpu"]) == 0
    assert f"streamed PBW checkpoint saved to {out} (peak resident layers: 1)" in \
        capsys.readouterr().out
    params, cfg, famname = thf.from_pretrained(llama_dir)
    calib, _ = tloaders.get_loaders("wikitext2", ByteTokenizer(), nsamples=2, seed=0,
                                    seqlen=cfg.seqlen, flavor="ptq")
    # the CLI's settings: its flags' defaults, packed_v2 → global column masks
    scfg = PTQJobConfig(model=llama_dir, low_frac=0.5, fmt="packed_v2", mask_structure="column",
                        col_tile=0).solver()
    resident, _ = tpipeline.quantize_model_ptq(params, cfg, family_for(famname), calib, scfg,
                                               fmt="packed_v2", log=None)
    layers, meta = tpbw.load_pbw(out)
    assert meta["gptq"] is True
    for i, lp in enumerate(resident["layers"]):
        for n in family_for(famname).linear_names:
            for f in tpbw.fields_of(lp[n]):
                if getattr(lp[n], f) is not None:
                    assert torch.equal(getattr(layers[f"layer_{i}/{n}"], f), getattr(lp[n], f))


# ---------------------------------------------------------------------------
# run_eval
# ---------------------------------------------------------------------------


def test_run_eval_hf_dir(llama_dir, tmp_path, texts, stub_tokenizer, capsys):
    """run_eval --model_id DIR: the JAX package's perplexity of the same
    checkpoint on the same tokens; then a PBW directory over it."""
    assert run_eval.main(["--model_id", llama_dir, "--eval_ppl", "wikitext2", "--flavor", "ptq",
                          "--seqlen", "64", "--device", "cpu"]) == 0
    got = ppls(capsys.readouterr().out)["wikitext2"]
    _, evaltok = tloaders.get_loaders("wikitext2", ByteTokenizer(), nsamples=2, seqlen=64,
                                      flavor="ptq")
    jparams, jcfg, jfam = _jax_from_pretrained(llama_dir)
    want = jppl.perplexity(jparams, jcfg, jfamily_for(jfam).forward, jnp.asarray(evaltok),
                           seqlen=64, window_batch=4)
    assert abs(got - want) / want < 5e-4, (got, want)
    ck = str(tmp_path / "pbw")
    tstream.stream_pack_to_pbw(llama_dir, ck, "llama", pack_fn=tstream.rtn_pack_fn(device="cpu"))
    assert run_eval.main([ck, "--model_id", llama_dir, "--eval_ppl", "wikitext2", "--flavor",
                          "ptq", "--seqlen", "64", "--device", "cpu"]) == 0
    assert np.isfinite(ppls(capsys.readouterr().out)["wikitext2"])


def _jax_from_pretrained(d):
    real = sys.modules.pop("transformers")
    sys.modules["transformers"] = transformers  # JAX reads the directory through transformers
    try:
        return jhf.from_pretrained(d)
    finally:
        sys.modules["transformers"] = real


def test_run_eval_without_texts_raises_offline(llama_dir, stub_tokenizer):
    """No dataset is fetched: without texts the loaders raise."""
    with pytest.raises(FileNotFoundError, match="no text for wikitext2/test"):
        run_eval.main(["--model_id", llama_dir, "--eval_ppl", "wikitext2", "--seqlen", "64",
                       "--device", "cpu"])
