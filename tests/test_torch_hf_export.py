"""Port parity for HF export (`pb_llm_tpu_torch.models.hf_export`): the
port's state dicts against the JAX package's for the same params, and the
port's `save_pretrained` directory reloaded in `transformers` against the
port's own forward (the JAX package's tests/test_hf_export.py recipe).

Tolerances: state dicts bit for bit (f32 and fp16: both cast the same f32
values); reloaded logits within the JAX round-trip test's bound (atol 3e-4,
rtol 1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.core import pbw as jpbw
from pb_llm_tpu.models import hf_export as jexport
from pb_llm_tpu.models import llama as jllama
from pb_llm_tpu.models import opt as jopt
from pb_llm_tpu.quant.high_quant import high_calibrate, high_quantize
from pb_llm_tpu.quant.low_quant import low_calibrate, low_quantize
from pb_llm_tpu_torch.interop import from_jax_params
from pb_llm_tpu_torch.models import hf_export as texport
from pb_llm_tpu_torch.models import hf_import as thf
from pb_llm_tpu_torch.models import llama as tllama
from pb_llm_tpu_torch.models import opt as topt
from pb_llm_tpu_torch.models.registry import family_for

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)


def jax_llama(layers=2, seed=0):
    cfg = jllama.LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                             num_hidden_layers=layers, num_attention_heads=4,
                             num_key_value_heads=2, max_position_embeddings=64)
    return cfg, jllama.init_params(cfg, jax.random.PRNGKey(seed))


def jax_opt(seed=1):
    cfg = jopt.OPTConfig(vocab_size=128, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
                         num_attention_heads=4, max_position_embeddings=64)
    return cfg, jopt.init_params(cfg, jax.random.PRNGKey(seed))


def port_cfg(jcfg):
    cls = tllama.LlamaConfig if isinstance(jcfg, jllama.LlamaConfig) else topt.OPTConfig
    return cls(**dataclasses.asdict(jcfg))


def pack_layer(params, rng, fmt):
    """Replace layer 0's linears with JAX-packed v1 (element masks) or v2
    (column masks) leaves, as the JAX export test does."""
    lp = params["layers"][0]
    for n in jllama.LINEAR_NAMES:
        w = np.asarray(lp[n]["w"]).T  # [oc, ic]
        if fmt == "v2":
            mask = np.asarray(jpbw.column_structured_mask(jnp.abs(jnp.asarray(w)), 0.9, 0))
        else:
            mask = rng.random(w.shape) < 0.9  # True ⇔ binarized
        low_state = low_calibrate(jnp.asarray(w * mask), "xnor", -1)
        high_state = high_calibrate(jnp.asarray(w), bits=8)
        w_q = np.where(mask, np.asarray(low_quantize(jnp.asarray(w), low_state, "xnor", -1)),
                       np.asarray(high_quantize(jnp.asarray(w), high_state)))
        pack = jpbw.pack_linear_v2 if fmt == "v2" else jpbw.pack_linear
        lp[n], _ = pack(jnp.asarray(w_q), jnp.asarray(mask), low_state, high_state, "xnor")
    return params


def assert_sd_equal(tsd, jsd):
    assert set(tsd) == set(jsd)
    for k in jsd:
        assert tsd[k].dtype == jsd[k].dtype and tsd[k].is_contiguous(), k
        assert torch.equal(tsd[k], jsd[k]), k


CASES = {
    "llama": lambda: ("llama", *jax_llama()),
    "opt": lambda: ("opt", *jax_opt()),
    "llama_packed_v1": lambda: ("llama", jax_llama(1, 2)[0],
                                pack_layer(jax_llama(1, 2)[1], np.random.default_rng(5), "v1")),
    "llama_packed_v2": lambda: ("llama", jax_llama(1, 3)[0],
                                pack_layer(jax_llama(1, 3)[1], np.random.default_rng(6), "v2")),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_equals_jax(case, dtype):
    family, jcfg, jparams = CASES[case]()
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams))
    fn = {"llama": (texport.llama_to_state_dict, jexport.llama_to_state_dict),
          "opt": (texport.opt_to_state_dict, jexport.opt_to_state_dict)}[family]
    assert_sd_equal(fn[0](tparams, port_cfg(jcfg), dtype), fn[1](jparams, jcfg, dtype))


def test_opt_350m_style_state_dict_equals_jax():
    from pb_llm_tpu.models import hf_import as jhf

    hf_cfg = transformers.OPTConfig(vocab_size=96, hidden_size=32, ffn_dim=64,
                                    num_hidden_layers=2, num_attention_heads=4,
                                    max_position_embeddings=64, word_embed_proj_dim=16,
                                    do_layer_norm_before=False, dropout=0.0)
    torch.manual_seed(3)
    src = transformers.OPTForCausalLM(hf_cfg).eval().float()
    jparams, jcfg, _ = jhf.from_torch_model(src)
    tparams, tcfg, _ = thf.from_torch_model(src)
    assert_sd_equal(texport.opt_to_state_dict(tparams, tcfg, torch.float32),
                    jexport.opt_to_state_dict(jparams, jcfg, torch.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_save_pretrained_reloads_in_transformers(tmp_path, case):
    """The port's export loads back into transformers and computes the
    port's logits (packed leaves export dense)."""
    family, jcfg, jparams = CASES[case]()
    cfg = port_cfg(jcfg)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams))
    out = texport.save_pretrained(params, cfg, family, str(tmp_path / "export"))
    cls = transformers.LlamaForCausalLM if family == "llama" else transformers.OPTForCausalLM
    reloaded = cls.from_pretrained(out).eval().float()
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 16))
    with torch.no_grad():
        ref = reloaded(torch.from_numpy(ids)).logits.numpy()
        got, _ = family_for(family).forward(params, torch.from_numpy(ids), cfg)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-4, rtol=1e-3)
    # and the port's own import of the export: the dense weights it wrote
    back, bcfg, bfam = thf.from_pretrained(out)
    assert bfam == family
    want = texport.llama_to_state_dict if family == "llama" else texport.opt_to_state_dict
    assert_sd_equal(want(back, bcfg, torch.float32), want(params, cfg, torch.float32))


def test_hf_config_dict_is_to_hf_config():
    for family, (jcfg, _) in (("llama", jax_llama()), ("opt", jax_opt())):
        kw = texport.hf_config_dict(port_cfg(jcfg), family)
        hf = texport.to_hf_config(port_cfg(jcfg), family)
        assert hf.model_type == kw.pop("model_type")
        assert all(getattr(hf, k) == v for k, v in kw.items())
        assert hf.to_dict() == jexport.to_hf_config(jcfg, family).to_dict()


def test_qat_leaf_is_not_ported():
    """QAT leaves are ported (quant/qat.py): a QATLinear exports as its
    fake-quant weight, the JAX package's state dict within 4 ulps (the
    binary scale: JAX's f32 sum in XLA's order against the port's f64 sum)."""
    from pb_llm_tpu.quant import qat as jqat
    from pb_llm_tpu_torch.quant import qat as tqat

    cfg, jparams = jax_llama(1)
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams))
    w = np.array(jparams["layers"][0]["q_proj"]["w"]).T
    jparams["layers"][0]["q_proj"] = jqat.make_qat_linear(jnp.asarray(w), None, 0.1)
    params["layers"][0]["q_proj"] = tqat.make_qat_linear(torch.from_numpy(w), None, 0.1)
    got = texport.llama_to_state_dict(params, port_cfg(cfg), torch.float32)
    want = jexport.llama_to_state_dict(jparams, cfg, torch.float32)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=5e-7, atol=0, err_msg=k)
