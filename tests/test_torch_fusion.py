"""Port parity for parallel-linear fusion (`pb_llm_tpu_torch.models.fusion`,
`core.pbw.merge_packed_linears_v2`) against the JAX package, mirroring
tests/test_fusion.py: the merged layer's dequant and reference matmul are
the concat of the parts' bit for bit; the int8, f32 and pair kernels' plain
versions on a multi-group layer against JAX's kernels in interpret mode;
the kernels take any group width, so no oc tile can straddle a group; the
fused engine streams the unfused engine's tokens and the JAX fused
engine's; GQA's narrower k/v stay unfused; and the serve CLI with
--scan_layers --fuse_linears --decode_dot pair.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.calib.pipeline import quantize_model_ptq
from pb_llm_tpu.calib.solver import SolverConfig
from pb_llm_tpu.core import pbw as jpbw
from pb_llm_tpu.models import llama as jllama
from pb_llm_tpu.models.fusion import fuse_parallel_linears as jfuse
from pb_llm_tpu.models.registry import family_for as jfamily_for
from pb_llm_tpu.ops import kernel_config as jkc
from pb_llm_tpu.ops import pallas_pb
from pb_llm_tpu.runtime import batching as jbatching
from pb_llm_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
from pb_llm_tpu_torch.core import pbw as tpbw
from pb_llm_tpu_torch.interop import from_jax_params, packed_from_fields
from pb_llm_tpu_torch.models import llama as tllama
from pb_llm_tpu_torch.models.fusion import fuse_parallel_linears
from pb_llm_tpu_torch.models.registry import family_for
from pb_llm_tpu_torch.ops import decode_arms, packed_matmul
from pb_llm_tpu_torch.ops import kernel_config as tkc
from pb_llm_tpu_torch.runtime import batching as tbatching
from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _packed(hidden=128, ffn=256, heads=8, kv_heads=8, seed=3, vocab=128):
    jcfg = jllama.LlamaConfig(vocab_size=vocab, hidden_size=hidden, intermediate_size=ffn,
                              num_hidden_layers=2, num_attention_heads=heads,
                              num_key_value_heads=kv_heads, max_position_embeddings=64)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    calib = np.random.default_rng(seed).integers(0, vocab, size=(2, 16))
    packed, _ = quantize_model_ptq(
        copy.deepcopy(params), jcfg, jfamily_for("llama"), calib,
        SolverConfig(low_frac=0.9, blocksize=32, mask_structure="column", col_tile=0),
        fmt="packed_v2", log=None, pack_block=32)
    tcfg = tllama.LlamaConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
        "rms_norm_eps", "rope_theta")})
    return jcfg, tcfg, packed


@pytest.fixture(scope="module")
def packed_v2_llama():
    return _packed()


def _parts(packed, names, layer=0):
    jparts = [packed["layers"][layer][n] for n in names]
    return jparts, [packed_from_fields(p) for p in jparts]


@pytest.mark.parametrize("names", [("q_proj", "k_proj", "v_proj"), ("gate_proj", "up_proj")])
def test_merged_dequant_and_reference_matmul_are_the_concat(packed_v2_llama, names):
    _, _, packed = packed_v2_llama
    jparts, tparts = _parts(packed, names)
    merged = tpbw.merge_packed_linears_v2(tparts)
    assert merged.n_row_groups == len(names) and merged.col_tile == tparts[0].oc
    want = torch.cat([tpbw.dequantize_v2(p) for p in tparts], dim=1)
    assert torch.equal(tpbw.dequantize_v2(merged), want)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 128)).astype(np.float32))
    got = tpbw.matmul_reference_v2(x, merged)
    assert torch.equal(got, torch.cat([tpbw.matmul_reference_v2(x, p) for p in tparts], dim=1))
    jm = jpbw.merge_packed_linears_v2(jparts)
    from_jax = packed_from_fields(jm)
    for f in tpbw.fields_of(merged):
        a, b = getattr(from_jax, f), getattr(merged, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    assert (jm.oc, jm.col_tile, jm.k_pad_shard) == (merged.oc, merged.col_tile, 0)


def test_merge_refuses_what_jax_refuses(packed_v2_llama):
    _, _, packed = packed_v2_llama
    _, (q, k, _) = _parts(packed, ("q_proj", "k_proj", "v_proj"))
    _, (gate, _) = _parts(packed, ("gate_proj", "up_proj"))
    with pytest.raises(ValueError, match="agree"):
        tpbw.merge_packed_linears_v2([q, gate])
    with pytest.raises(ValueError, match="global-selection"):
        tpbw.merge_packed_linears_v2([tpbw.merge_packed_linears_v2([q, k]), q])
    with pytest.raises(ValueError, match="PackedLinearV2"):
        tpbw.merge_packed_linears_v2([q, {"w": None}])


@pytest.mark.parametrize("arm,m", [("int8", 4), ("int8", 300), ("f32", 4), ("f32", 300),
                                   ("pair", 4)])
def test_kernel_plain_versions_on_a_multi_group_layer_match_jax(packed_v2_llama, arm, m):
    """The int8 (1e-5 of max|y|, the flat int8 bound), f32 (rtol/atol 1e-4)
    and pair (1e-5 of max|y|; a decode arm) plain versions against JAX's
    kernels on the fused qkv layer, decode and prefill rows."""
    _, _, packed = packed_v2_llama
    jparts, tparts = _parts(packed, ("q_proj", "k_proj", "v_proj"))
    jm, tm = jpbw.merge_packed_linears_v2(jparts), tpbw.merge_packed_linears_v2(tparts)
    x = np.random.default_rng(6 + m).standard_normal((m, 128)).astype(np.float32)
    kw = {"int8": dict(decode_dot="int8", prefill_int8=True), "f32": dict(decode_dot="f32"),
          "pair": dict(decode_dot="pair")}[arm]
    with jax.default_matmul_precision("float32"):
        if arm == "f32" and m >= 256:  # JAX's row-grouped prefill is the planar f32 kernel
            want = np.asarray(pallas_pb._planar_v2_call(jnp.asarray(x), jm, 128, True))
        else:
            want = np.asarray(pallas_pb.pb_matmul_pallas_v2(jnp.asarray(x), jm, interpret=True,
                                                            oc_tile=128, **kw))
    fn = {"int8": packed_matmul.pb_int8_matmul, "f32": packed_matmul.pb_f32_matmul,
          "pair": decode_arms.pb_pair_v2}[arm]
    got = fn(torch.from_numpy(x), tm).numpy()
    if arm == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_any_group_width_stays_aligned():
    """test_fusion.py:102's regression, gate|up at ffn 384 (col_tile 384, not
    a multiple of the 512/256 TPU tiles): the port's kernels read each
    column's own row group (blocks of 32 columns, one group a column), so no
    tile straddles a group; the layout is served and the plain versions
    agree with the reference."""
    _, _, packed = _packed(hidden=128, ffn=384, heads=4, kv_heads=4, seed=9, vocab=64)
    jparts, tparts = _parts(packed, ("gate_proj", "up_proj"))
    merged = tpbw.merge_packed_linears_v2(tparts)
    assert merged.oc == 768 and merged.col_tile == 384
    assert packed_matmul.kernel_supported_v2(merged)
    assert pallas_pb.pallas_supported_v2(jpbw.merge_packed_linears_v2(jparts))
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((4, 128)).astype(np.float32))
    ref = tpbw.matmul_reference_v2(x, merged)
    for fn in (packed_matmul.pb_f32_matmul, decode_arms.pb_pair_v2, packed_matmul.pb_int8_matmul):
        assert (fn(x, merged) - ref).abs().max() <= 2e-2 * ref.abs().max()


def _requests(mod):
    return [mod.Request(request_id=i, prompt_ids=list(map(int, p)), max_new_tokens=5)
            for i, p in enumerate(np.random.default_rng(31).integers(0, 128, size=(3, 5)))]


@pytest.mark.parametrize("arms", [dict(decode_dot="f32"), dict(decode_dot="pair")])
def test_engine_fused_stream_matches_unfused_and_jax(packed_v2_llama, arms):
    """Continuous batching with fuse_linears on and off, on the kernels'
    plain versions: the same greedy streams, and the JAX fused engine's on
    the same arms (pallas_interpret)."""
    jcfg, tcfg, packed = packed_v2_llama
    kw = dict(backend="pallas_interpret", **arms)
    jeng = JEngine(copy.deepcopy(packed), jcfg, jfamily_for("llama"), JEngineConfig(
        n_slots=2, max_seq=32, prefill_buckets=(8,), fuse_linears=True,
        cache_dtype=jnp.float32, kernels=jkc.KernelConfig(**kw)))
    want = [r.output_ids for r in jbatching.ContinuousBatcher(jeng).run(_requests(jbatching))]
    tparams = from_jax_params(_np(packed))
    for fuse in (False, True):
        eng = Engine(tparams, tcfg, family_for("llama"), EngineConfig(
            n_slots=2, max_seq=32, prefill_buckets=(8,), fuse_linears=fuse,
            cache_dtype=torch.float32, kernels=tkc.KernelConfig(**kw)), device="cpu")
        assert ("qkv_proj" in eng.params["layers"][0]) == fuse
        assert ("gateup_proj" in eng.params["layers"][0]) == fuse
        got = [r.output_ids for r in tbatching.ContinuousBatcher(eng).run(_requests(tbatching))]
        assert got == want, fuse


def test_fused_scanned_engine_and_jax_fused_tree(packed_v2_llama):
    """fuse, then stack: the stacked fused layers stream the unfused
    tokens; a tree fused by the JAX package converts to the port's."""
    jcfg, tcfg, packed = packed_v2_llama
    tparams = from_jax_params(_np(packed))
    fused_jax = from_jax_params(_np(jfuse(packed, "llama")))
    fused = fuse_parallel_linears(tparams, "llama")
    for name in ("qkv_proj", "gateup_proj"):
        for f in tpbw.fields_of(fused["layers"][1][name]):
            a, b = getattr(fused["layers"][1][name], f), getattr(fused_jax["layers"][1][name], f)
            assert (a is None and b is None) or torch.equal(a, b), (name, f)
    streams = []
    for kw in (dict(), dict(fuse_linears=True, scan_layers=True)):
        eng = Engine(tparams, tcfg, family_for("llama"), EngineConfig(
            n_slots=2, max_seq=32, prefill_buckets=(8,), cache_dtype=torch.float32,
            kernels=tkc.KernelConfig(backend="pallas_interpret", decode_dot="f32"), **kw),
            device="cpu")
        streams.append([r.output_ids for r in tbatching.ContinuousBatcher(eng).run(
            _requests(tbatching))])
    assert "qkv_proj" in eng.params["layers_stacked"]
    assert streams[0] == streams[1]


def test_fusion_skips_gqa_kv():
    _, _, packed = _packed(hidden=64, ffn=128, heads=4, kv_heads=2, seed=4, vocab=64)
    lp = fuse_parallel_linears(from_jax_params(_np(packed)), "llama")["layers"][0]
    assert "qkv_proj" not in lp and "q_proj" in lp  # k/v are narrower than q
    assert "gateup_proj" in lp and "gate_proj" not in lp
    dense = fuse_parallel_linears({"layers": [{"q_proj": {"w": None}}]}, "llama")
    assert dense["layers"][0] == {"q_proj": {"w": None}}  # dense leaves stay


def test_serve_cli_scan_fuse_pair_on_cpu(tmp_path, capsys):
    """serve --scan_layers --fuse_linears --decode_dot pair over a PBW-v2
    checkpoint (fusable: global selection, equal shapes) on the CPU."""
    from pb_llm_tpu_torch.cli import serve
    from pb_llm_tpu_torch.data.synthetic import random_packed_v2

    g = torch.Generator().manual_seed(0)
    shapes = {"q_proj": (64, 64), "k_proj": (64, 64), "v_proj": (64, 64), "o_proj": (64, 64),
              "gate_proj": (64, 128), "up_proj": (64, 128), "down_proj": (128, 64)}
    tpbw.save_pbw(str(tmp_path / "ck"), {f"layer_{i}/{n}": random_packed_v2(ic, oc, g)
                                         for i in range(2) for n, (ic, oc) in shapes.items()})
    outs = []
    for extra in ([], ["--scan_layers", "--fuse_linears", "--decode_dot", "pair"],
                  ["--scan_layers", "--decode_dot", "dma"]):
        assert serve.main(["--model_id", "llama", "--synthetic", "--pbw", str(tmp_path / "ck"),
                           "--device", "cpu", "--n_requests", "3", "--max_new_tokens", "4",
                           *extra]) == 0
        out = capsys.readouterr().out
        assert "requests=3 tokens=12" in out
        outs.append([ln for ln in out.splitlines() if ln.startswith("[")])
    assert outs[0] == outs[1] == outs[2]
