"""Port parity for the slice as a whole: a tiny packed llama (2 layers,
hidden 128) quantized by the JAX package's own PTQ pipeline, carried over
with `interop.from_jax_params`, served by the port's `Engine` and
`ContinuousBatcher` and held against the JAX `Engine`:

  (a) exact CPU arms (auto): logits to 1e-4, equal greedy streams;
  (b) int8 arms (int8 KV, int8 matmul, kernels' plain versions): forced
      decode NLL within 2% of the JAX engine on the same arms
      (the bar of test_pbw_v2.py::test_engine_decode_dot_int8_quality_bound);
  (c) sliding window: the masked path matches JAX;
  (d) entry points raise without CUDA unless given device="cpu".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.calib.pipeline import quantize_model_ptq
from pb_llm_tpu.calib.solver import SolverConfig
from pb_llm_tpu.core import pbw as jpbw
from pb_llm_tpu.models import llama as jllama
from pb_llm_tpu.models.registry import family_for as jfamily_for
from pb_llm_tpu.ops import binary_matmul as _jbm  # noqa: F401  (registers the JAX dispatch)
from pb_llm_tpu.ops.kernel_config import KernelConfig as JKernelConfig
from pb_llm_tpu.runtime import batching as jbatching
from pb_llm_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
from pb_llm_tpu_torch.core import pbw as tpbw
from pb_llm_tpu_torch.interop import from_jax_params
from pb_llm_tpu_torch.models import llama as tllama
from pb_llm_tpu_torch.models.registry import family_for
from pb_llm_tpu_torch.ops import kernel_config as tkc
from pb_llm_tpu_torch.runtime import batching as tbatching
from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

torch.set_num_threads(2)

MAX_SEQ = 64
BUCKETS = (16, 64)


def _jcfg(**kw):
    return jllama.LlamaConfig(vocab_size=128, hidden_size=128, intermediate_size=256,
                              num_hidden_layers=2, num_attention_heads=8,
                              num_key_value_heads=kw.pop("kv_heads", 4),
                              max_position_embeddings=512, **kw)


def _tcfg(jcfg):
    return tllama.LlamaConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
        "rms_norm_eps", "rope_theta", "sliding_window", "head_dim_override")})


def _to_numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def packed_model():
    cfg = _jcfg()
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    calib = np.random.default_rng(0).integers(0, 128, size=(2, 16))
    scfg = SolverConfig(low_frac=0.9, blocksize=32, mask_structure="column", col_tile=0)
    packed, _ = quantize_model_ptq(params, cfg, jfamily_for("llama"), calib, scfg,
                                   fmt="packed_v2", log=None, pack_block=32)
    return cfg, packed


PROMPTS = [[5, 17, 42, 3], [9, 1, 100, 77, 23, 64, 8], [3] * 12, list(range(20, 40))]


def _requests(mod):
    return [mod.Request(request_id=i, prompt_ids=list(p), max_new_tokens=6)
            for i, p in enumerate(PROMPTS)]


@pytest.fixture(scope="module")
def jax_exact(packed_model):
    """The JAX engine with its CPU auto arms: prefill logits and greedy
    streams through its ContinuousBatcher."""
    cfg, packed = packed_model
    ecfg = JEngineConfig(n_slots=2, max_seq=MAX_SEQ, prefill_buckets=BUCKETS)
    eng = JEngine(packed, cfg, jfamily_for("llama"), ecfg)
    eng.prefill(0, PROMPTS[1])
    logits = np.asarray(eng._prefill_logits[0])
    nll = eng.forced_decode_nll(0, [7, 21, 9, 33])
    eng.release(0)
    streams = [r.output_ids for r in jbatching.ContinuousBatcher(eng).run(_requests(jbatching))]
    return logits, nll, streams


def _port_engine(cfg, packed, **kw):
    return Engine(from_jax_params(_to_numpy_tree(packed)), _tcfg(cfg), family_for("llama"),
                  EngineConfig(n_slots=2, max_seq=MAX_SEQ, prefill_buckets=BUCKETS, **kw),
                  device="cpu")


def test_exact_arms_logits_and_streams_match_jax(packed_model, jax_exact):
    cfg, packed = packed_model
    want_logits, want_nll, want_streams = jax_exact
    eng = _port_engine(cfg, packed)
    assert eng.cache_dtype == torch.float32  # "auto" on the CPU
    eng.prefill(0, PROMPTS[1])
    np.testing.assert_allclose(eng._prefill_logits[0].numpy(), want_logits, atol=1e-4, rtol=1e-4)
    nll = eng.forced_decode_nll(0, [7, 21, 9, 33])
    assert abs(nll - want_nll) <= 1e-4 * abs(want_nll)
    eng.release(0)
    got = [r.output_ids for r in tbatching.ContinuousBatcher(eng).run(_requests(tbatching))]
    assert got == want_streams


def test_pbw_checkpoint_from_jax_serves_identically(tmp_path, packed_model, jax_exact):
    """`save_pbw` in JAX, `load_pbw` + `install_pbw` in the port (the
    `cli.serve --pbw` path): same prefill logits as the JAX engine."""
    cfg, packed = packed_model
    layers = {f"layer_{i}/{n}": lp[n] for i, lp in enumerate(packed["layers"])
              for n in jllama.LINEAR_NAMES}
    jpbw.save_pbw(str(tmp_path / "ck"), layers)
    dense = jllama.init_params(cfg, jax.random.PRNGKey(1))
    base = {k: v for k, v in _to_numpy_tree(packed).items() if k != "layers"}
    base["layers"] = [{k: v for k, v in lp.items() if k not in jllama.LINEAR_NAMES}
                      | {n: _to_numpy_tree(dl[n]) for n in jllama.LINEAR_NAMES}
                      for lp, dl in zip(_to_numpy_tree(packed)["layers"], dense["layers"])]
    loaded, _ = tpbw.load_pbw(str(tmp_path / "ck"))
    params = tpbw.install_pbw(from_jax_params(base), loaded)
    eng = Engine(params, _tcfg(cfg), family_for("llama"),
                 EngineConfig(n_slots=2, max_seq=MAX_SEQ, prefill_buckets=BUCKETS), device="cpu")
    eng.prefill(1, PROMPTS[1])
    np.testing.assert_allclose(eng._prefill_logits[1].numpy(), jax_exact[0], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("prompt_len,bucket", [(12, 16), (260, 512)])
def test_int8_arms_forced_nll_within_2pct(packed_model, prompt_len, bucket):
    """int8 KV + int8 matmul (decode at m < 256, fused prefill at m >= 256)
    + decode attention, each the kernel's plain version, against the JAX
    engine's Pallas-interpret kernels on the same arms."""
    cfg, packed = packed_model
    r = np.random.default_rng(prompt_len)
    prompt = r.integers(0, 128, size=prompt_len).tolist()
    forced = r.integers(0, 128, size=4).tolist()
    jkc = JKernelConfig(backend="pallas_interpret", decode_dot="int8", prefill="int8",
                        attention="xla", decode_attention="pallas_interpret")
    jeng = JEngine(packed, cfg, jfamily_for("llama"),
                   JEngineConfig(n_slots=2, max_seq=bucket, prefill_buckets=(bucket,),
                                 cache_dtype=jnp.int8, kernels=jkc))
    jeng.prefill(1, prompt)
    want = jeng.forced_decode_nll(1, forced)

    tkcfg = tkc.KernelConfig(backend="pallas_interpret", decode_dot="int8", prefill="int8",
                             attention="xla", decode_attention="pallas_interpret")
    eng = Engine(from_jax_params(_to_numpy_tree(packed)), _tcfg(cfg), family_for("llama"),
                 EngineConfig(n_slots=2, max_seq=bucket, prefill_buckets=(bucket,),
                              cache_dtype=torch.int8, kernels=tkcfg), device="cpu")
    eng.prefill(1, prompt)
    got = eng.forced_decode_nll(1, forced)
    assert np.isfinite(got) and got > 0
    assert abs(got - want) / want < 0.02, (got, want)


def test_sliding_window_matches_jax():
    cfg = _jcfg(kv_heads=8, sliding_window=5)
    params = jllama.init_params(cfg, jax.random.PRNGKey(3))
    jeng = JEngine(params, cfg, jfamily_for("mistral"),
                   JEngineConfig(n_slots=2, max_seq=MAX_SEQ, prefill_buckets=BUCKETS))
    eng = Engine(from_jax_params(_to_numpy_tree(params)), _tcfg(cfg), family_for("mistral"),
                 EngineConfig(n_slots=2, max_seq=MAX_SEQ, prefill_buckets=BUCKETS), device="cpu")
    prompt = PROMPTS[3]
    toks_j = [jeng.prefill(0, prompt)] + [jeng.decode_step()[0] for _ in range(5)]
    toks_t = [eng.prefill(0, prompt)] + [eng.decode_step()[0] for _ in range(5)]
    np.testing.assert_allclose(eng._prefill_logits[0].numpy(),
                               np.asarray(jeng._prefill_logits[0]), atol=1e-4, rtol=1e-4)
    assert toks_t == toks_j
    ids = np.asarray(prompt)[None]
    want, _ = jllama.forward(params, jnp.asarray(ids), cfg)
    got, _ = tllama.forward(eng.params, torch.as_tensor(ids), _tcfg(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch, packed_model):
    cfg, packed = packed_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = from_jax_params(_to_numpy_tree(packed))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(params, _tcfg(cfg), family_for("llama"), EngineConfig(n_slots=1, max_seq=16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(params, _tcfg(cfg), family_for("llama"), EngineConfig(n_slots=1, max_seq=16),
               device="cuda")
    from pb_llm_tpu_torch.cli import serve

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--model_id", "llama", "--synthetic", "--demo"])


def test_make_caches_needs_cuda_or_an_explicit_device(monkeypatch):
    """`make_caches` resolves its device like every entry point: no silent
    CPU default."""
    from pb_llm_tpu_torch.runtime import kv_cache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kv_cache.make_caches(None, 2, 16, 1, 2, 8, torch.int8)
    caches = kv_cache.make_caches(None, 2, 16, 1, 2, 8, torch.int8, device="cpu")
    assert caches[0]["k"].device.type == "cpu" and caches[0]["k_scale"].shape == (2, 16, 2, 1)


@pytest.mark.parametrize("mode", ["draft_model_id"])
def test_unported_engine_modes_raise(mode, monkeypatch):
    """A draft model from a hub id needs transformers (blocked here, so
    nothing is fetched): the port says so and substitutes nothing."""
    import sys

    from pb_llm_tpu_torch.cli import serve

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="needs transformers"):
        serve.main(["--model_id", "llama", "--synthetic", "--device", "cpu",
                    "--spec_gamma", "2", "--draft_model_id", "huggyllama/llama-7b"])


def test_serve_cli_synthetic_demo_on_cpu(capsys):
    from pb_llm_tpu_torch.cli import serve

    assert serve.main(["--model_id", "llama", "--synthetic", "--demo", "--device", "cpu",
                       "--n_requests", "5", "--max_new_tokens", "4"]) == 0
    assert "requests=5 tokens=20" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [
    ["--page_size", "8", "--prefix_cache", "--prefill_chunk", "16", "--spec_gamma", "3"],
    ["--page_size", "16", "--n_pages", "20", "--spec_gamma", "2", "--draft_synthetic"],
])
def test_serve_cli_paged_spec_chunked_demo_on_cpu(capsys, extra):
    """The serving extensions through the CLI: paged pool, prefix cache,
    chunked prefill and prompt-lookup spec; a synthetic draft model over an
    oversubscribed pool (preemptions)."""
    from pb_llm_tpu_torch.cli import serve

    assert serve.main(["--model_id", "llama", "--synthetic", "--demo", "--device", "cpu",
                       "--n_requests", "6", "--max_new_tokens", "8"] + extra) == 0
    out = capsys.readouterr().out
    assert "requests=6 tokens=48" in out and "spec drafted=" in out and "pages=" in out


def test_serve_cli_pbw_checkpoint_on_cpu(tmp_path, capsys):
    """`--pbw` installs a v2 checkpoint over the synthetic model's linears."""
    from pb_llm_tpu_torch.cli import serve
    from pb_llm_tpu_torch.data.synthetic import random_packed_v2

    g = torch.Generator().manual_seed(0)
    shapes = {"q_proj": (64, 64), "k_proj": (64, 64), "v_proj": (64, 64), "o_proj": (64, 64),
              "gate_proj": (64, 128), "up_proj": (64, 128), "down_proj": (128, 64)}
    tpbw.save_pbw(str(tmp_path / "ck"), {f"layer_{i}/{n}": random_packed_v2(ic, oc, g)
                                         for i in range(2) for n, (ic, oc) in shapes.items()})
    assert serve.main(["--model_id", "llama", "--synthetic", "--pbw", str(tmp_path / "ck"),
                       "--device", "cpu", "--kv_dtype", "int8", "--n_requests", "3",
                       "--max_new_tokens", "2"]) == 0
    assert "requests=3 tokens=6" in capsys.readouterr().out
