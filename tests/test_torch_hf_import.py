"""Port parity for HF import (`pb_llm_tpu_torch.models.hf_import`, the
config classes' `from_hf`, and `hf_stream`'s file reader) against the JAX
package on the same tiny HF models, built in process from config objects
(nothing is downloaded).

Tolerances: params are bit for bit (both widen the stored values to f32 on
the host); configs and families are equal; the port's forward on imported
params matches `transformers`' logits within the bound of the JAX
package's own parity tests (tests/test_models.py: atol 2e-4, rtol 1e-3).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from pb_llm_tpu.models import hf_import as jhf
from pb_llm_tpu.models import llama as jllama
from pb_llm_tpu.models import opt as jopt
from pb_llm_tpu_torch.models import hf_import as thf
from pb_llm_tpu_torch.models import hf_stream as tstream
from pb_llm_tpu_torch.models import llama as tllama
from pb_llm_tpu_torch.models import opt as topt
from pb_llm_tpu_torch.models.registry import family_for

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)

# name: (transformers config class, causal-LM class, config kwargs)
MODELS = {
    "llama": ("LlamaConfig", "LlamaForCausalLM",
              dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=64)),
    "llama_gqa": ("LlamaConfig", "LlamaForCausalLM",
                  dict(vocab_size=96, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                       num_attention_heads=8, num_key_value_heads=2,
                       max_position_embeddings=64, rope_theta=500.0, rms_norm_eps=1e-5)),
    "llama_tied": ("LlamaConfig", "LlamaForCausalLM",
                   dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                        num_attention_heads=4, max_position_embeddings=64,
                        tie_word_embeddings=True)),
    "mistral": ("MistralConfig", "MistralForCausalLM",
                dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                     num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                     sliding_window=8, attn_implementation="eager")),
    "opt": ("OPTConfig", "OPTForCausalLM",
            dict(vocab_size=96, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=64, word_embed_proj_dim=32,
                 dropout=0.0)),
    "opt_350m": ("OPTConfig", "OPTForCausalLM",
                 dict(vocab_size=96, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
                      num_attention_heads=4, max_position_embeddings=64, word_embed_proj_dim=16,
                      do_layer_norm_before=False, dropout=0.0)),
}
# save_pretrained arguments of the four file layouts (the sharded ones
# split a layer's tensors across shards)
LAYOUTS = {
    "safetensors": dict(safe_serialization=True),
    "safetensors_sharded": dict(safe_serialization=True, max_shard_size="20KB"),
    "bin": dict(safe_serialization=False),
    "bin_sharded": dict(safe_serialization=False, max_shard_size="20KB"),
}


def build(name, seed=0, dtype=torch.float32):
    cfg_cls, model_cls, kw = MODELS[name]
    torch.manual_seed(seed)
    model = getattr(transformers, model_cls)(getattr(transformers, cfg_cls)(**kw))
    return model.eval().to(dtype)


@pytest.fixture(scope="module")
def models():
    return {name: build(name, seed=i) for i, name in enumerate(MODELS)}


def save(model, path, **kw) -> str:
    model.save_pretrained(str(path), **kw)
    return str(path)


def assert_trees_equal(jtree, ttree, path="params"):
    if jtree is None or ttree is None:
        assert jtree is None and ttree is None, path
    elif isinstance(jtree, dict):
        assert set(jtree) == set(ttree), path
        for k in jtree:
            assert_trees_equal(jtree[k], ttree[k], f"{path}/{k}")
    elif isinstance(jtree, (list, tuple)):
        assert len(jtree) == len(ttree), path
        for i, (a, b) in enumerate(zip(jtree, ttree)):
            assert_trees_equal(a, b, f"{path}/{i}")
    else:
        want = np.asarray(jtree)
        got = ttree.numpy()
        assert got.dtype == want.dtype == np.float32, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def assert_configs_equal(jcfg, tcfg):
    assert type(jcfg).__name__ == type(tcfg).__name__
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_from_hf_configs_equal(models, name):
    hf = models[name].config
    cls = (jopt.OPTConfig, topt.OPTConfig) if "opt" in name else (jllama.LlamaConfig,
                                                                  tllama.LlamaConfig)
    assert_configs_equal(cls[0].from_hf(hf), cls[1].from_hf(hf))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_from_torch_model_bit_identical(models, name):
    jparams, jcfg, jfam = jhf.from_torch_model(models[name])
    tparams, tcfg, tfam = thf.from_torch_model(models[name])
    assert jfam == tfam == ("opt" if "opt" in name else "llama")
    assert_configs_equal(jcfg, tcfg)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, jparams), tparams)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("name", ["llama", "llama_tied", "mistral", "opt", "opt_350m"])
def test_from_pretrained_local_dir(models, tmp_path, name, layout):
    """The port reads the directory itself (no transformers); JAX reads it
    through transformers: the same params, config and family."""
    d = save(models[name], tmp_path / name, **LAYOUTS[layout])
    if "sharded" in layout:
        index = "model.safetensors.index.json" if "safe" in layout else "pytorch_model.bin.index.json"
        with open(os.path.join(d, index)) as fh:
            assert len(set(json.load(fh)["weight_map"].values())) > 1
    jparams, jcfg, jfam = jhf.from_pretrained(d)
    tparams, tcfg, tfam = thf.from_pretrained(d)
    assert jfam == tfam
    assert_configs_equal(jcfg, tcfg)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, jparams), tparams)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("layout", ["safetensors", "bin_sharded"])
def test_from_pretrained_half_precision(tmp_path, dtype, layout):
    """fp16 / bf16 checkpoints: every stored value widened to f32 as is."""
    model = build("llama_gqa", seed=7, dtype=dtype)
    d = save(model, tmp_path / "llama_half", **LAYOUTS[layout])
    jparams, jcfg, _ = jhf.from_pretrained(d)
    tparams, tcfg, _ = thf.from_pretrained(d)
    assert_configs_equal(jcfg, tcfg)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, jparams), tparams)
    want = model.model.layers[1].mlp.down_proj.weight.detach().float().T
    np.testing.assert_array_equal(tparams["layers"][1]["down_proj"]["w"].numpy(), want.numpy())


# keys a trimmed config.json leaves out: what the config classes default
TRIM = {
    "llama": ("rms_norm_eps", "rope_theta", "num_key_value_heads", "tie_word_embeddings",
              "head_dim", "max_position_embeddings", "torch_dtype", "dtype"),
    "mistral": ("sliding_window", "num_key_value_heads", "rope_theta", "rms_norm_eps",
                "head_dim", "tie_word_embeddings"),
    "opt": ("do_layer_norm_before", "word_embed_proj_dim", "enable_bias",
            "tie_word_embeddings", "torch_dtype", "dtype"),
}


@pytest.mark.parametrize("name", sorted(TRIM))
def test_trimmed_config_takes_class_defaults(models, tmp_path, name):
    d = save(models[name], tmp_path / name)
    path = os.path.join(d, "config.json")
    with open(path) as fh:
        raw = json.load(fh)
    for k in TRIM[name]:
        raw.pop(k, None)
    with open(path, "w") as fh:
        json.dump(raw, fh)
    hf = transformers.AutoConfig.from_pretrained(d)
    ns = thf.hf_config(raw, raw["model_type"])
    for k in TRIM[name]:
        if k not in ("torch_dtype", "dtype", "enable_bias") and hasattr(hf, k):
            assert getattr(ns, k) == getattr(hf, k), k
    cls = (jopt.OPTConfig, topt.OPTConfig) if name == "opt" else (jllama.LlamaConfig,
                                                                  tllama.LlamaConfig)
    assert_configs_equal(cls[0].from_hf(hf), cls[1].from_hf(ns))
    if name == "mistral":  # sliding_window and num_key_value_heads defaults bind
        assert (ns.sliding_window, ns.num_key_value_heads) == (4096, 8)
        return  # a different kv-head count: the weights no longer fit the config
    jparams, jcfg, jfam = jhf.from_pretrained(d)
    tparams, tcfg, tfam = thf.from_pretrained(d)
    assert jfam == tfam
    assert_configs_equal(jcfg, tcfg)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, jparams), tparams)


def test_prefixless_opt_checkpoint(tmp_path):
    """A checkpoint saved from a bare OPTModel stores "decoder.*": both
    from_pretrained map it under "model." (transformers does for JAX);
    neither package's streaming path matches those keys (kept on purpose,
    ROADMAP Queue 3)."""
    cfg_cls, _, kw = MODELS["opt"]
    torch.manual_seed(11)
    base = transformers.OPTModel(getattr(transformers, cfg_cls)(**kw)).eval()
    d = save(base, tmp_path / "opt_base")
    keys = set(tstream.safetensors_header(os.path.join(d, "model.safetensors"))[0])
    assert keys and all(k.startswith("decoder.") for k in keys)
    jparams, jcfg, jfam = jhf.from_pretrained(d)
    tparams, tcfg, tfam = thf.from_pretrained(d)
    assert jfam == tfam == "opt"
    assert_configs_equal(jcfg, tcfg)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, jparams), tparams)
    assert tstream.StreamedLayerLoader(d, "opt").n_layers() == 0
    assert tstream.stream_pack_to_pbw(d, str(tmp_path / "pbw"), "opt",
                                      pack_fn=tstream.rtn_pack_fn(device="cpu")) == {}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16,
                                   torch.int64, torch.int8, torch.uint8, torch.bool])
def test_safetensors_reader_matches_package(tmp_path, dtype):
    from safetensors import safe_open
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(3)
    tensors = {"a.weight": torch.randn(5, 7, generator=g), "b": torch.randn(3, generator=g) * 100,
               "c.scalar": torch.tensor(2.5), "d.empty": torch.zeros(0, 4)}
    tensors = {k: (v > 0 if dtype == torch.bool else v.to(dtype)) for k, v in tensors.items()}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = tstream.read_safetensors(path)
    assert set(got) == set(tensors)
    with safe_open(path, framework="pt") as sf:
        for k in sf.keys():
            want = sf.get_tensor(k)
            assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
            assert torch.equal(got[k], want), k
    assert set(tstream.read_safetensors(path, ["b"])) == {"b"}


@pytest.mark.parametrize("name", ["llama_gqa", "mistral", "opt", "opt_350m"])
def test_forward_on_imported_params_matches_transformers(models, tmp_path, name):
    model = models[name]
    params, cfg, famname = thf.from_pretrained(save(model, tmp_path / name, **LAYOUTS["bin"]))
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 16))
    with torch.no_grad():
        ref = model(torch.from_numpy(ids)).logits.numpy()
        got, _ = family_for(famname).forward(params, torch.from_numpy(ids), cfg)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-3)


def test_non_directory_needs_transformers(monkeypatch):
    """A path that is no local directory goes through transformers, and
    says so where it is missing; nothing is substituted."""
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="needs transformers"):
        thf.from_pretrained("no-such-org/llama-7b")


@pytest.mark.parametrize("shard_bytes", [0, 20_000])
def test_written_checkpoint_reads_as_transformers_reads_it(tmp_path, shard_bytes):
    """`data.synthetic.write_hf_checkpoint` (torch alone, as chip_smoke.py
    writes its directories): JAX's from_pretrained through transformers and
    the port's read the same fp16 values, widened."""
    from pb_llm_tpu_torch.data.synthetic import write_hf_checkpoint

    cfg = tllama.LlamaConfig(vocab_size=96, hidden_size=32, intermediate_size=64,
                             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                             max_position_embeddings=64)
    params = tllama.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    d = write_hf_checkpoint(params, cfg, "llama", str(tmp_path / "llama-written"),
                            max_shard_bytes=shard_bytes)
    assert os.path.exists(os.path.join(
        d, "pytorch_model.bin.index.json" if shard_bytes else "pytorch_model.bin"))
    jparams, jcfg, jfam = jhf.from_pretrained(d)
    tparams, tcfg, tfam = thf.from_pretrained(d)
    assert jfam == tfam == "llama" and tcfg == cfg
    assert_configs_equal(jcfg, tcfg)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, jparams), tparams)
    np.testing.assert_array_equal(tparams["layers"][1]["up_proj"]["w"].numpy(),
                                  params["layers"][1]["up_proj"]["w"].half().float().numpy())
