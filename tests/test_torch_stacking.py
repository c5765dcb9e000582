"""Port parity for stacked layers (`pb_llm_tpu_torch.models.stacking`, the
scan_layers path) against the JAX package, mirroring tests/test_stacking.py:
the stack/unstack round trip; the stacked forward equals the unrolled one
for llama and OPT, dense and PBW-v2 leaves, with and without caches, each
port result held against the JAX result at rtol = atol = 1e-5; the stacked
kernels' plain versions against JAX's `pb_matmul_pallas_v2_stacked` in
interpret mode for every layer; the engine under scan_layers against the
JAX engine (strips and a paged pool with chunked prefill); and
`run_eval --scan_layers`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pb_llm_tpu.ops.binary_matmul as _jbm  # noqa: F401  (registers the JAX dispatch)
from pb_llm_tpu.calib.pipeline import quantize_model_ptq
from pb_llm_tpu.calib.solver import SolverConfig
from pb_llm_tpu.models import llama as jllama
from pb_llm_tpu.models import opt as jopt
from pb_llm_tpu.models import stacking as jstacking
from pb_llm_tpu.models.registry import family_for as jfamily_for
from pb_llm_tpu.ops import kernel_config as jkc
from pb_llm_tpu.ops import pallas_pb
from pb_llm_tpu.runtime import kv_cache as jkv
from pb_llm_tpu.runtime.engine import Engine as JEngine, EngineConfig as JEngineConfig
from pb_llm_tpu_torch.core import pbw as tpbw
from pb_llm_tpu_torch.interop import from_jax_params
from pb_llm_tpu_torch.models import llama as tllama
from pb_llm_tpu_torch.models import opt as topt
from pb_llm_tpu_torch.models import stacking
from pb_llm_tpu_torch.models.linear import apply_linear, linear_shape
from pb_llm_tpu_torch.models.registry import family_for
from pb_llm_tpu_torch.ops import binary_matmul, packed_matmul
from pb_llm_tpu_torch.ops import kernel_config as tkc
from pb_llm_tpu_torch.runtime import kv_cache as tkv
from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _llama_cfgs(nl=3, hidden=32, heads=4, kv_heads=2, vocab=64):
    jcfg = jllama.LlamaConfig(vocab_size=vocab, hidden_size=hidden, intermediate_size=2 * hidden,
                              num_hidden_layers=nl, num_attention_heads=heads,
                              num_key_value_heads=kv_heads, max_position_embeddings=64)
    tcfg = tllama.LlamaConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "max_position_embeddings",
        "rms_norm_eps", "rope_theta")})
    return jcfg, tcfg


def _opt_cfgs():
    kw = dict(vocab_size=64, hidden_size=32, ffn_dim=64, num_hidden_layers=3,
              num_attention_heads=4, max_position_embeddings=64)
    return jopt.OPTConfig(**kw), topt.OPTConfig(**kw)


@pytest.fixture(scope="module")
def packed_llama():
    """A 2-layer llama at hidden 128 quantized into PBW v2 by the JAX
    package (the kernels' layouts: oc % 128 == 0)."""
    jcfg, tcfg = _llama_cfgs(nl=2, hidden=128, heads=8, kv_heads=8, vocab=128)
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    calib = np.random.default_rng(0).integers(0, 128, size=(2, 16))
    scfg = SolverConfig(low_frac=0.9, blocksize=32, mask_structure="column", col_tile=0)
    packed, _ = quantize_model_ptq(params, jcfg, jfamily_for("llama"), calib, scfg,
                                   fmt="packed_v2", log=None, pack_block=32)
    return jcfg, tcfg, packed


def test_stack_unstack_roundtrip():
    jcfg, _ = _llama_cfgs()
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(_np(jparams))
    st = stacking.stack_layers(tparams)
    jst = jstacking.stack_layers(jparams)
    assert st["num_layers"] == jst["num_layers"] == 3
    np.testing.assert_array_equal(st["layers_stacked"]["q_proj"]["w"].numpy(),
                                  np.asarray(jst["layers_stacked"]["q_proj"]["w"]))
    back = stacking.unstack_layers(st)
    for a, b in zip(tparams["layers"], back["layers"]):
        assert torch.equal(a["q_proj"]["w"], b["q_proj"]["w"])
        assert torch.equal(a["input_layernorm"], b["input_layernorm"])
    with pytest.raises(ValueError, match="differing structures"):
        stacking.stack_layers(dict(tparams, layers=[tparams["layers"][0], {"x": None}]))


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_scan_forward_matches_unrolled_and_jax(family):
    if family == "llama":
        jcfg, tcfg = _llama_cfgs()
        jparams, jfwd, tfwd = jllama.init_params(jcfg, jax.random.PRNGKey(0)), jllama.forward, \
            tllama.forward
    else:
        jcfg, tcfg = _opt_cfgs()
        jparams, jfwd, tfwd = jopt.init_params(jcfg, jax.random.PRNGKey(1)), jopt.forward, \
            topt.forward
    ids = np.random.default_rng(2).integers(0, 64, size=(2, 12))
    with jax.default_matmul_precision("float32"):
        want, _ = jfwd(jstacking.stack_layers(jparams), jnp.asarray(ids), jcfg)
    tparams = from_jax_params(_np(jparams))
    ids_t = torch.as_tensor(ids)
    unrolled, _ = tfwd(tparams, ids_t, tcfg)
    scanned, _ = tfwd(stacking.stack_layers(tparams), ids_t, tcfg)
    np.testing.assert_array_equal(scanned.numpy(), unrolled.numpy())
    np.testing.assert_allclose(scanned.numpy(), np.asarray(want), **TOL)
    # a JAX tree stacked by the JAX package converts to the port's
    from_stacked, _ = tfwd(from_jax_params(_np(jstacking.stack_layers(jparams))), ids_t, tcfg)
    np.testing.assert_array_equal(from_stacked.numpy(), scanned.numpy())


def test_scan_forward_with_caches_matches_unrolled_and_jax():
    jcfg, tcfg = _llama_cfgs()
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    nl, kvh, hd = jkv.cache_spec_for(jcfg, "llama")
    ids = np.random.default_rng(3).integers(0, 64, size=(1, 8))
    with jax.default_matmul_precision("float32"):
        jcaches = jkv.make_caches(jcfg, 1, 16, nl, kvh, hd, jnp.float32)
        want, jnew = jllama.forward(jstacking.stack_layers(jparams), jnp.asarray(ids), jcfg,
                                    kv_caches=jstacking.stack_caches(jcaches), pos=0)
    tparams = from_jax_params(_np(jparams))
    ids_t = torch.as_tensor(ids)
    caches_u = tkv.make_caches(tcfg, 1, 16, nl, kvh, hd, torch.float32, device="cpu")
    y_u, _ = tllama.forward(tparams, ids_t, tcfg, kv_caches=caches_u, pos=0)
    caches_s = stacking.stack_caches(tkv.make_caches(tcfg, 1, 16, nl, kvh, hd, torch.float32,
                                                     device="cpu"))
    y_s, _ = tllama.forward(stacking.stack_layers(tparams), ids_t, tcfg, kv_caches=caches_s, pos=0)
    np.testing.assert_array_equal(y_s.numpy(), y_u.numpy())
    for i in range(nl):  # the stacked caches were written in place, layer by layer
        assert torch.equal(caches_s["k"][i], caches_u[i]["k"])
        assert torch.equal(stacking.unstack_caches(caches_s, nl)[i]["v"], caches_u[i]["v"])
    np.testing.assert_allclose(y_s.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(caches_s["k"][1].numpy(), np.asarray(jnew["k"][1]), **TOL)


@pytest.mark.parametrize("backend", ["auto", "pallas_interpret"])
def test_scan_forward_packed_v2_leaves(packed_llama, backend):
    """PBW-v2 leaves go in as markers: the reference arm ("auto" on the CPU)
    and the stacked kernels' plain versions ("pallas_interpret") both equal
    the unrolled forward and JAX's scanned forward on the same arms."""
    jcfg, tcfg, packed = packed_llama
    ids = np.random.default_rng(5).integers(0, 128, size=(1, 8))
    kw = dict(backend=backend, decode_dot="f32")
    with jkc.use_kernels(jkc.KernelConfig(**kw)), jax.default_matmul_precision("float32"):
        want, _ = jllama.forward(jstacking.stack_layers(packed), jnp.asarray(ids), jcfg)
    tparams = from_jax_params(_np(packed))
    ids_t = torch.as_tensor(ids)
    with tkc.use_kernels(tkc.KernelConfig(**kw)):
        y_u, _ = tllama.forward(tparams, ids_t, tcfg)
        y_s, _ = tllama.forward(stacking.stack_layers(tparams), ids_t, tcfg)
    np.testing.assert_allclose(y_s.numpy(), y_u.numpy(), **TOL)
    np.testing.assert_allclose(y_s.numpy(), np.asarray(want), **TOL)


def test_scan_forward_packed_v1_leaves():
    """PBW-v1 leaves stack too and take per-layer views."""
    from pb_llm_tpu_torch.data.synthetic import random_packed_opt

    _, tcfg = _opt_cfgs()
    tcfg = topt.OPTConfig(vocab_size=64, hidden_size=128, ffn_dim=256, num_hidden_layers=2,
                          num_attention_heads=4, max_position_embeddings=64)
    params = random_packed_opt(tcfg, torch.Generator().manual_seed(0), groupsize=64)
    ids = torch.as_tensor(np.random.default_rng(6).integers(0, 64, size=(2, 9)))
    with tkc.use_kernels(tkc.KernelConfig(backend="pallas_interpret")):
        y_u, _ = topt.forward(params, ids, tcfg)
        y_s, _ = topt.forward(stacking.stack_layers(params), ids, tcfg)
    np.testing.assert_array_equal(y_s.numpy(), y_u.numpy())


def _stacked_layers(n=3):
    from tests.test_torch_decode_arms import _make_v2

    layers = [_make_v2(256, 256, seed=s) for s in range(n)]
    jsp = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *[j for j, _ in layers])
    tsp = stacking.stack_layers({"layers": [{"w": t} for _, t in layers]})["layers_stacked"]["w"]
    return jsp, tsp


def _marker(tsp, li):
    return stacking.StackedPackedLinearV2(tsp, li, torch.tensor([li], dtype=torch.int32))


@pytest.mark.parametrize("dd", ["f32", "int8"])
def test_stacked_plain_matches_jax_stacked_kernel(dd):
    """Every layer index: f32 at rtol/atol 1e-4 (test_pbw_v2.py:765), int8
    at the port's flat int8 bound against JAX's int8 kernel (1e-5 of
    max|y|)."""
    jsp, tsp = _stacked_layers()
    assert packed_matmul.stacked_supported_v2(tsp)
    x = np.random.default_rng(21).standard_normal((4, 256)).astype(np.float32)
    fn = packed_matmul.pb_f32_matmul_stacked if dd == "f32" else packed_matmul.pb_int8_matmul_stacked
    for li in range(3):
        with jax.default_matmul_precision("float32"):
            want = np.asarray(pallas_pb.pb_matmul_pallas_v2_stacked(
                jnp.asarray(x), jsp, jnp.int32(li), interpret=True, oc_tile=128, decode_dot=dd))
        got = fn(torch.from_numpy(x), _marker(tsp, li)).numpy()
        if dd == "f32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        else:
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), li


def test_stacked_coefficients_made_once_and_equal_the_flat_rows():
    _, tsp = _stacked_layers()
    coef = packed_matmul.coef_rows(tsp)
    assert coef.shape == (3, 5, 256) and packed_matmul.coef_rows(tsp) is coef
    for li in range(3):
        flat = packed_matmul.coef_rows(stacking.take_layer({"w": tsp}, li)["w"])
        assert torch.equal(coef[li], flat)


@pytest.mark.parametrize("m,dd,want", [
    (4, "int8", "stacked_int8"), (4, "f32", "stacked_f32"), (4, "pair", "stacked_f32"),
    (4, "dma", "stacked_f32"), (300, "int8", "views"), (257, "f32", "views"),
])
def test_stacked_dispatch(monkeypatch, m, dd, want):
    """`pb_matmul_stacked` on the kernel arms: the stacked int8 kernel for
    int8, the stacked f32 kernel for any other decode arm, the layer's
    views through `pb_matmul` past 256 rows or for an unsupported layout."""
    _, tsp = _stacked_layers(2)
    seen = []
    for name in ("pb_int8_matmul_stacked_plain", "pb_f32_matmul_stacked_plain"):
        fn = getattr(packed_matmul, name)
        monkeypatch.setattr(packed_matmul, name,
                            lambda x, mk, _f=fn, _n=name: seen.append(_n) or _f(x, mk))
    x = torch.from_numpy(np.random.default_rng(m).standard_normal((m, 256)).astype(np.float32))
    with tkc.use_kernels(tkc.KernelConfig(backend="pallas_interpret", decode_dot=dd,
                                          prefill="hybrid")):
        got = apply_linear(_marker(tsp, 1), x)
        ref = binary_matmul.pb_matmul(x, stacking.take_layer({"w": tsp}, 1)["w"])
    assert seen == ({"stacked_int8": ["pb_int8_matmul_stacked_plain"],
                     "stacked_f32": ["pb_f32_matmul_stacked_plain"], "views": []}[want])
    if want != "stacked_f32" or dd == "f32":
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert linear_shape(_marker(tsp, 1)) == (256, 256)
    # an unsupported layout (2 row groups) takes the views on every arm
    from tests.test_torch_decode_arms import _make_v2

    grouped = stacking.stack_layers({"layers": [{"w": _make_v2(256, 256, col_tile=128, seed=s)[1]}
                                                for s in (0, 1)]})["layers_stacked"]["w"]
    assert not packed_matmul.stacked_supported_v2(grouped)
    seen.clear()
    with tkc.use_kernels(tkc.KernelConfig(backend="pallas_interpret", decode_dot=dd)):
        apply_linear(_marker(grouped, 0), x[:4])
    assert seen == []


def test_linear_fn_must_be_scan_safe(packed_llama):
    _, tcfg, packed = packed_llama
    st = stacking.stack_layers(from_jax_params(_np(packed)))
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="scan_safe"):
        tllama.forward(st, ids, tcfg, linear_fn=lambda name, lin, h: apply_linear(lin, h))

    def safe(name, lin, h):
        return apply_linear(lin, h)

    safe.scan_safe = True
    y, _ = tllama.forward(st, ids, tcfg, linear_fn=safe)
    torch.testing.assert_close(y, tllama.forward(st, ids, tcfg)[0], rtol=0, atol=0)


def _greedy(eng, prompt, steps, slot=0):
    toks = [eng.prefill(slot, prompt)]
    toks += [eng.decode_step()[slot] for _ in range(steps - 1)]
    eng.release(slot)
    return toks


def test_engine_scan_layers_matches_jax_on_strips(packed_llama):
    """test_pbw_v2.py:772-806: the scan_layers engine on the kernel arms
    (decode_dot f32, the stacked f32 kernel's plain version) streams the
    same greedy tokens as the unrolled port engine and the JAX scan_layers
    engine under pallas_interpret."""
    jcfg, tcfg, packed = packed_llama
    tparams = from_jax_params(_np(packed))
    kw = dict(backend="pallas_interpret", decode_dot="f32")
    want = _greedy(JEngine(packed, jcfg, jfamily_for("llama"), JEngineConfig(
        n_slots=1, max_seq=32, prefill_buckets=(8,), scan_layers=True,
        kernels=jkc.KernelConfig(**kw))), [5, 17, 42, 3], 5)
    got = {}
    before = packed_matmul.stacked_f32_launches
    for scan in (False, True):
        eng = Engine(tparams, tcfg, family_for("llama"), EngineConfig(
            n_slots=1, max_seq=32, prefill_buckets=(8,), scan_layers=scan,
            cache_dtype=torch.float32, kernels=tkc.KernelConfig(**kw)), device="cpu")
        assert ("layers_stacked" in eng.params) == scan
        got[scan] = _greedy(eng, [5, 17, 42, 3], 5)
    assert got[True] == got[False] == want
    assert packed_matmul.stacked_f32_launches == before  # the CPU runs plain versions


def test_engine_scan_layers_int8_cache_nll(packed_llama):
    jcfg, tcfg, packed = packed_llama
    tparams = from_jax_params(_np(packed))
    nll = {}
    for scan in (False, True):
        eng = Engine(tparams, tcfg, family_for("llama"), EngineConfig(
            n_slots=1, max_seq=32, prefill_buckets=(8,), cache_dtype=torch.int8,
            scan_layers=scan, kernels=tkc.KernelConfig(backend="pallas_interpret")),
            device="cpu")
        eng.prefill(0, [5, 17, 42])
        nll[scan] = eng.forced_decode_nll(0, [7, 21, 9])
    assert np.isfinite(nll[True]) and nll[True] == pytest.approx(nll[False], rel=1e-6)


@pytest.fixture(scope="module")
def tiny_opt():
    jcfg = jopt.OPTConfig(vocab_size=128, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                          num_attention_heads=4, max_position_embeddings=64)
    jparams = jopt.init_params(jcfg, jax.random.PRNGKey(1))
    tcfg = topt.OPTConfig(vocab_size=128, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
                          num_attention_heads=4, max_position_embeddings=64)
    return jcfg, jparams, tcfg, from_jax_params(_np(jparams))


def test_paged_scan_layers_matches_jax(tiny_opt):
    """test_paged.py:123-160: scan_layers over the paged pool (the stacked
    cache carries [L]-axis pages and table), with chunked prefill over
    pages and strips, streams the tokens of the unrolled paged engine and
    of the JAX engine."""
    jcfg, jparams, tcfg, tparams = tiny_opt
    prompt = [42, 7, 11, 23, 60, 2, 19, 8, 77, 31]
    jeng = JEngine(jparams, jcfg, jfamily_for("opt"), JEngineConfig(
        n_slots=2, max_seq=48, prefill_buckets=(8, 16), page_size=8, scan_layers=True,
        cache_dtype=jnp.float32))
    want = _greedy(jeng, [5, 17, 99, 3], 8) + _greedy(jeng, prompt, 6)

    def port(**kw):
        return Engine(tparams, tcfg, family_for("opt"), EngineConfig(
            n_slots=2, max_seq=48, cache_dtype=torch.float32, **kw), device="cpu")

    for scan in (False, True):
        eng = port(prefill_buckets=(8, 16), page_size=8, scan_layers=scan)
        assert _greedy(eng, [5, 17, 99, 3], 8) + _greedy(eng, prompt, 6) == want, scan
    assert eng.caches["table"].shape[0] == 2
    for paged_kw in ({"page_size": 8}, {}):  # the paged and strip chunk paths
        eng = port(prefill_buckets=(16,), prefill_chunk=8, scan_layers=True, **paged_kw)
        eng.start_chunked_prefill(0, prompt)
        first = None
        while first is None:
            first = eng.prefill_chunk_step(0)
        assert [first] + [eng.decode_step()[0] for _ in range(5)] == want[8:], paged_kw


def test_run_eval_scan_layers_equals_unrolled(capsys):
    """The same per-layer views run: the perplexity is equal to the digit."""
    from pb_llm_tpu_torch.cli import run_eval

    out = []
    for extra in ([], ["--scan_layers"]):
        assert run_eval.main(["--model_id", "llama", "--synthetic", "--device", "cpu",
                              "--eval_ppl", "wikitext2", "--ppl_limit", "2", *extra]) == 0
        out.append([ln for ln in capsys.readouterr().out.splitlines() if "perplexity" in ln])
    assert out[0] == out[1] and out[0]


def test_dequant_of_a_stacked_layer_view_is_the_layers():
    _, tsp = _stacked_layers(2)
    from tests.test_torch_decode_arms import _make_v2

    for li in range(2):
        want = tpbw.dequantize_v2(_make_v2(256, 256, seed=li)[1])
        assert torch.equal(tpbw.dequantize_v2(stacking.take_layer({"w": tsp}, li)["w"]), want)
