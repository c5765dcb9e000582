"""Port parity for streamed HF → PBW conversion (`models.hf_stream`),
`core.pbw.PBWShardWriter` and the streamed GPTQ-PB pipeline
(`calib.pipeline.quantize_model_ptq_streamed`), against the port's own
in-memory paths and the JAX package, on tiny HF models built in process.

Tolerances: the streamed artifact equals in-memory packing bit for bit,
and JAX's artifact bit for bit but for the 8-bit scale (one f32 ulp) and
the codes it rounds (within 1; JAX's converter calibrates eagerly, see
test_stream_matches_jax_and_artifacts_cross); given the same quantizer
states the packing itself is bit for bit (tests/test_torch_packing.py).
Streamed GPTQ-PB equals the resident
pipeline bit for bit in masks and planes (errors within rtol 1e-5, as JAX
asserts of itself) and JAX's streamed pipeline in masks, the bound of
tests/test_torch_ptq.py.
"""

import copy
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.calib import pipeline as jpipeline
from pb_llm_tpu.calib import solver as jsolver
from pb_llm_tpu.core import pbw as jpbw
from pb_llm_tpu.models import hf_stream as jstream
from pb_llm_tpu.models import opt as jopt
from pb_llm_tpu.models.registry import family_for as jfamily_for
from pb_llm_tpu_torch.calib import pipeline as tpipeline
from pb_llm_tpu_torch.calib import solver as tsolver
from pb_llm_tpu_torch.core import pbw as tpbw
from pb_llm_tpu_torch.models import hf_import as thf
from pb_llm_tpu_torch.models import hf_stream as tstream
from pb_llm_tpu_torch.models.registry import family_for

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)

LAYOUTS = {
    "safetensors": dict(safe_serialization=True),
    "safetensors_sharded": dict(safe_serialization=True, max_shard_size="20KB"),
    "bin": dict(safe_serialization=False),
    "bin_sharded": dict(safe_serialization=False, max_shard_size="20KB"),
}
LINEARS = {"llama": ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"),
           "opt": ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")}
SUB = {"llama": {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
                 "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
                 "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj", "down_proj": "mlp.down_proj"},
       "opt": {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
               "v_proj": "self_attn.v_proj", "out_proj": "self_attn.out_proj",
               "fc1": "fc1", "fc2": "fc2"}}


def tiny(family, layers=2, seed=0):
    torch.manual_seed(seed)
    if family == "opt":  # the JAX package's own recipe (tests/test_hf_stream.py)
        cfg = transformers.OPTConfig(vocab_size=96, hidden_size=32, ffn_dim=64,
                                     num_hidden_layers=layers, num_attention_heads=4,
                                     max_position_embeddings=64, word_embed_proj_dim=32,
                                     dropout=0.0)
        return transformers.OPTForCausalLM(cfg).eval().float()
    cfg = transformers.LlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=96,
                                   num_hidden_layers=layers, num_attention_heads=4,
                                   num_key_value_heads=2, max_position_embeddings=64)
    return transformers.LlamaForCausalLM(cfg).eval().float()


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{(family, layout): (model, dir)}: the same model per family saved in
    each of the four layouts."""
    root = tmp_path_factory.mktemp("hf")
    out = {}
    for family in ("llama", "opt"):
        model = tiny(family)
        for layout, kw in LAYOUTS.items():
            d = root / f"{family}_{layout}"
            model.save_pretrained(str(d), **kw)
            out[family, layout] = (model, str(d))
    return out


def fields(p):
    return {f: getattr(p, f) for f in tpbw.fields_of(p) if getattr(p, f) is not None}


def assert_layers_equal(got, want, what="", ulp_fields=(), code_fields=()):
    """Every field bit for bit; those in ``ulp_fields`` within one f32 ulp,
    the 8-bit codes and zero points in ``code_fields`` within 1."""
    assert type(got) is type(want), what
    for f in ("ic", "oc", "pack_block", "low_bits"):
        assert getattr(got, f) == getattr(want, f), (what, f)
    gf, wf = fields(got), fields(want)
    assert set(gf) == set(wf), what
    for f in gf:
        assert gf[f].dtype == wf[f].dtype, (what, f)
        g, w = gf[f].cpu().numpy(), wf[f].cpu().numpy()
        if f in ulp_fields:
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
        elif f in code_fields:
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1, (what, f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {f}")


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("family", ["llama", "opt"])
def test_iter_hf_tensors_lists_everything(dirs, family, layout):
    model, d = dirs[family, layout]
    got = dict(tstream.iter_hf_tensors(d))
    want = dict(jstream.iter_hf_tensors(d))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # save_pretrained drops tied heads; every other key surfaces
    assert set(model.state_dict()) - set(got) in (set(), {"lm_head.weight"})


@pytest.mark.parametrize("fmt", ["packed_v2", "packed"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("family", ["llama", "opt"])
def test_stream_matches_in_memory(dirs, tmp_path, family, layout, fmt):
    model, d = dirs[family, layout]
    pack = tstream.rtn_pack_fn(method="xnor", low_frac=0.8, fmt=fmt, device="cpu")
    out = str(tmp_path / "pbw")
    done = tstream.stream_pack_to_pbw(d, out, family, pack_fn=pack)
    assert len(done) == 2 * len(LINEARS[family])
    assert all(os.path.exists(os.path.join(out, f)) for f in done.values())
    layers, meta = tpbw.load_pbw(out)
    assert meta["family"] == family and set(layers) == set(done)
    prefix = "model.decoder.layers" if family == "opt" else "model.layers"
    sd = model.state_dict()
    for i in range(2):
        for name in LINEARS[family]:
            key = f"{prefix}.{i}.{SUB[family][name]}"
            want = pack(name, sd[key + ".weight"], sd.get(key + ".bias"))
            assert_layers_equal(layers[f"layer_{i}/{name}"], want, f"layer_{i}/{name}")


@pytest.fixture(scope="module")
def jax_artifacts(dirs, tmp_path_factory):
    """JAX's streamed artifacts of the safetensors-sharded dirs, per
    (family, fmt)."""
    root = tmp_path_factory.mktemp("jax_pbw")
    out = {}
    for family, fmt in JAX_CASES:
        path = str(root / f"{family}_{fmt}")
        jstream.stream_pack_to_pbw(dirs[family, "safetensors_sharded"][1], path, family,
                                   pack_fn=jstream.rtn_pack_fn(low_frac=0.8, fmt=fmt))
        out[family, fmt] = path
    return out


JAX_CASES = (("llama", "packed_v2"), ("opt", "packed"))  # JAX packs eagerly: a few s each


@pytest.mark.parametrize("family,fmt", JAX_CASES)
def test_stream_matches_jax_and_artifacts_cross(dirs, jax_artifacts, tmp_path, family, fmt):
    """The port's artifact equals JAX's field for field but for the 8-bit
    scale, within one f32 ulp: JAX's converter calibrates eagerly, dividing
    (max − min) by 255, where its solver runs the quantizers jitted (a
    reciprocal product), which the port's quantizers follow
    (tests/test_torch_ptq.py).  A zero point or code on a rounding half may
    then move by 1: the dense weights agree to f32 rounding but for at most
    1e-3 of them, each within one 8-bit step.  Planes and the salient
    selection are the same.  Each package's load_pbw reads the other's
    sharded artifact."""
    d = dirs[family, "safetensors_sharded"][1]
    out = str(tmp_path / "pbw")
    tstream.stream_pack_to_pbw(d, out, family,
                               pack_fn=tstream.rtn_pack_fn(low_frac=0.8, fmt=fmt, device="cpu"))
    with open(os.path.join(out, "manifest.json")) as fh:
        tman = json.load(fh)
    with open(os.path.join(jax_artifacts[family, fmt], "manifest.json")) as fh:
        jman = json.load(fh)
    assert tman["layers"] == jman["layers"] and set(tman["files"]) == set(jman["files"])
    assert tman["extra"]["family"] == jman["extra"]["family"] == family

    ported, _ = tpbw.load_pbw(out)
    from_jax, _ = tpbw.load_pbw(jax_artifacts[family, fmt])  # the port reads JAX's
    jax_reads, _ = jpbw.load_pbw(out)                          # JAX reads the port's
    jax_own, _ = jpbw.load_pbw(jax_artifacts[family, fmt])
    deq_t = tpbw.dequantize_v2 if fmt == "packed_v2" else tpbw.dequantize
    deq_j = jpbw.dequantize_v2 if fmt == "packed_v2" else jpbw.dequantize
    for key in ported:
        assert_layers_equal(ported[key], from_jax[key], key, ulp_fields=("high_scale",),
                            code_fields=("side_val", "sidecar", "high_zero"))
        got, want = deq_t(ported[key]).numpy(), deq_t(from_jax[key]).numpy()
        step = from_jax[key].high_scale.numpy()[None, :] * 1.000001
        assert (np.abs(got - want) <= step).all(), key
        off = np.abs(got - want) > 1e-6 * np.abs(want) + 1e-12
        assert off.sum() <= 1e-3 * off.size, (key, off.sum())
        np.testing.assert_array_equal(np.asarray(deq_j(jax_reads[key])), got, err_msg=key)
        np.testing.assert_array_equal(deq_t(from_jax[key]).numpy(),
                                      np.asarray(deq_j(jax_own[key])), err_msg=key)


def test_shard_writer_writes_what_jax_writes(dirs, tmp_path):
    """One layer through both writers: the same manifest and arrays."""
    model, _ = dirs["llama", "bin"]
    w = model.state_dict()["model.layers.0.mlp.up_proj.weight"]
    tp = tstream.rtn_pack_fn(low_frac=0.8, device="cpu")("up_proj", w, None)
    jp = jstream.rtn_pack_fn(low_frac=0.8)("up_proj", w.numpy(), None)
    for pkg, layer, path in ((tpbw, tp, tmp_path / "t"), (jpbw, jp, tmp_path / "j")):
        writer = pkg.PBWShardWriter(str(path))
        writer.add_layer("layer_0/up_proj", layer)
        writer.finalize({"k": 1})
    assert json.loads((tmp_path / "t" / "manifest.json").read_text()) == \
        json.loads((tmp_path / "j" / "manifest.json").read_text())
    with np.load(tmp_path / "t" / "planes_00000.npz") as zt, \
            np.load(tmp_path / "j" / "planes_00000.npz") as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype, k
            if k.endswith("::high_scale"):  # see test_stream_matches_jax_and_artifacts_cross
                np.testing.assert_array_max_ulp(zt[k], zj[k], maxulp=1)
            elif k.endswith(("::side_val", "::high_zero")):
                assert np.abs(zt[k].astype(np.int32) - zj[k].astype(np.int32)).max() <= 1
            else:
                np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_streamed_artifact_serves(dirs, tmp_path, family):
    """load_pbw (sharded) → install_pbw over from_pretrained's params →
    finite logits of the right shape."""
    _, d = dirs[family, "bin_sharded"]
    out = str(tmp_path / "pbw")
    tstream.stream_pack_to_pbw(d, out, family,
                               pack_fn=tstream.rtn_pack_fn(low_frac=0.8, device="cpu"))
    params, cfg, famname = thf.from_pretrained(d)
    layers, _ = tpbw.load_pbw(out)
    packed = tpbw.install_pbw(params, layers)
    assert isinstance(packed["layers"][1][LINEARS[family][0]], tpbw.PackedLinearV2)
    logits, _ = family_for(famname).forward(packed, torch.tensor([[5, 17, 29, 3]]), cfg)
    assert logits.shape == (1, 4, 96) and bool(torch.isfinite(logits).all())


def test_rtn_pack_fn_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstream.rtn_pack_fn()


GPTQ = dict(low_frac=0.5, salient_metric="hessian", blocksize=16, mask_structure="column",
            col_tile=0)


@pytest.fixture(scope="module")
def gptq_dirs(tmp_path_factory):
    """3-layer models saved in multi-shard layouts (safetensors for OPT,
    torch bins for llama), with their calibration windows."""
    root = tmp_path_factory.mktemp("gptq")
    out = {}
    for family, kw in (("opt", LAYOUTS["safetensors_sharded"]), ("llama", LAYOUTS["bin_sharded"])):
        model = tiny(family, layers=3, seed=1)
        d = str(root / family)
        model.save_pretrained(d, **kw)
        calib = np.random.default_rng(0).integers(0, 96, size=(4, 16))
        out[family] = (model, d, calib)
    return out


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_streamed_gptq_matches_resident(gptq_dirs, tmp_path, family):
    """One decoder layer resident at a time, the same masks and planes as
    the whole-model pipeline on the same device."""
    _, d, calib = gptq_dirs[family]
    params, cfg, famname = thf.from_pretrained(d)
    fam = family_for(famname)
    scfg = tsolver.SolverConfig(**GPTQ)
    p_res, rep_res = tpipeline.quantize_model_ptq(copy.deepcopy(params), cfg, fam, calib, scfg,
                                                  fmt="packed_v2", log=None)
    loader = tstream.StreamedLayerLoader(d, family)
    assert loader.n_layers() == 3
    out = str(tmp_path / "pbw")
    rep_st = tpipeline.quantize_model_ptq_streamed(loader, cfg, fam, calib, scfg, out,
                                                   fmt="packed_v2", log=None, device="cpu")
    assert loader.max_live == 1
    assert set(rep_res.masks) == set(rep_st.masks)
    for k in rep_res.masks:
        np.testing.assert_array_equal(rep_res.masks[k], rep_st.masks[k], err_msg=k)
        np.testing.assert_allclose(rep_res.errors[k], rep_st.errors[k], rtol=1e-5)
    assert rep_st.layer_output_mse.keys() == rep_res.layer_output_mse.keys()
    layers, meta = tpbw.load_pbw(out)
    assert meta["gptq"] is True and meta["family"] == family
    for i, lp in enumerate(p_res["layers"]):
        for n in fam.linear_names:
            assert_layers_equal(layers[f"layer_{i}/{n}"], lp[n], f"layer_{i}/{n}")


def test_streamed_gptq_matches_jax(gptq_dirs, tmp_path):
    """The port's streamed pipeline against JAX's on the same checkpoint:
    masks bit for bit (tests/test_torch_ptq.py's bound for the pipeline)."""
    _, d, calib = gptq_dirs["opt"]
    cfg, _ = thf.config_from_dir(d)
    jcfg = jopt.OPTConfig(**dataclasses.asdict(cfg))
    jrep = jpipeline.quantize_model_ptq_streamed(
        jstream.StreamedLayerLoader(d, "opt"), jcfg, jfamily_for("opt"), calib,
        jsolver.SolverConfig(**GPTQ), str(tmp_path / "jax"), log=None)
    trep = tpipeline.quantize_model_ptq_streamed(
        tstream.StreamedLayerLoader(d, "opt"), cfg, family_for("opt"), calib,
        tsolver.SolverConfig(**GPTQ), str(tmp_path / "port"), log=None, device="cpu")
    assert sorted(trep.masks) == sorted(jrep.masks)
    for k in jrep.masks:
        np.testing.assert_array_equal(trep.masks[k], jrep.masks[k], err_msg=k)
    assert jnp.isfinite(jnp.asarray(list(jrep.errors.values()))).all()


@pytest.mark.parametrize("layout", ["safetensors_sharded", "bin_sharded"])
def test_card_paths_need_neither_package(dirs, tmp_path, monkeypatch, layout):
    """The card's machine has neither transformers nor safetensors: a local
    directory still imports, converts and streams, with the same result."""
    import sys

    _, d = dirs["llama", layout]
    want, cfg, fam = thf.from_pretrained(d)
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    got, gcfg, gfam = thf.from_pretrained(d)
    assert (gcfg, gfam) == (cfg, fam)
    assert all(torch.equal(got["layers"][1][n]["w"], want["layers"][1][n]["w"])
               for n in LINEARS["llama"])
    out = str(tmp_path / "pbw")
    done = tstream.stream_pack_to_pbw(d, out, "llama",
                                      pack_fn=tstream.rtn_pack_fn(device="cpu"))
    assert len(done) == 14 and len(tpbw.load_pbw(out)[0]) == 14
    loader = tstream.StreamedLayerLoader(d, "llama")
    assert loader.n_layers() == 2
    assert torch.equal(loader.layer_params(0)["q_proj"]["w"], want["layers"][0]["q_proj"]["w"])
