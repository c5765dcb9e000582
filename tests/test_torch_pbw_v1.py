"""Port parity for PBW v1 (`pb_llm_tpu_torch.core.pbw.PackedLinear`):
`pack_linear` planes, `dequantize`, `pack_mismatch` and `effective_bits`
bit for bit against the JAX package for every packable low method, whole-
row and grouped scales, 8- and 4-bit high codes; checkpoints (`save_pbw` /
`load_pbw` and `utils.checkpoint`) crossing in both directions; and
`interop.from_jax_params` on v1 leaves given as objects or dicts.

Packing runs eagerly on both sides (no jit), so every quantizer division
and rounding is one IEEE operation in each package: bit equality holds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.core import pbw as jpbw
from pb_llm_tpu.quant.high_quant import high_calibrate, high_quantize
from pb_llm_tpu.quant.low_quant import low_calibrate, low_quantize
from pb_llm_tpu.utils import checkpoint as jckpt
from pb_llm_tpu_torch.core import pbw as tpbw
from pb_llm_tpu_torch.data.synthetic import random_packed_v1
from pb_llm_tpu_torch.interop import from_jax_params, packed_from_fields
from pb_llm_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

METHODS = ("xnor", "sign", "rtn", "prune", "2bit", "4bit")


def _solver_output(method, groupsize, high_bits, oc=128, ic=512, seed=0):
    """A GPTQ-PB-shaped output from the JAX quantizers: element-wise mask
    (80% binarized), w_q, low and high states (numpy)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((oc, ic)).astype(np.float32)
    mask = np.abs(w) <= np.quantile(np.abs(w), 0.8)
    low = low_calibrate(jnp.asarray(w * mask), method, groupsize)
    high = high_calibrate(jnp.asarray(w), bits=high_bits)
    w_q = np.where(mask, np.asarray(low_quantize(jnp.asarray(w), low, method, groupsize)),
                   np.asarray(high_quantize(jnp.asarray(w), high)))
    bias = rng.standard_normal(oc).astype(np.float32)
    return w_q, mask, low, high, bias


def _packs(method, groupsize, high_bits, **kw):
    w_q, mask, low, high, bias = _solver_output(method, groupsize, high_bits, **kw)
    jp, jdiag = jpbw.pack_linear(jnp.asarray(w_q), jnp.asarray(mask), low, high, method,
                                 groupsize, bias=jnp.asarray(bias))
    tp, tdiag = tpbw.pack_linear(torch.from_numpy(w_q), torch.from_numpy(mask),
                                 {k: np.asarray(v) for k, v in low.items()},
                                 {k: np.asarray(v) for k, v in high.items()}, method, groupsize,
                                 bias=torch.from_numpy(bias))
    return jp, jdiag, tp, tdiag


def _assert_same_layer(tp, jp):
    assert (tp.ic, tp.oc, tp.groupsize, tp.pack_block, tp.sidecar_bits, tp.low_bits) == (
        jp.ic, jp.oc, jp.groupsize, jp.pack_block, jp.sidecar_bits, jp.low_bits)
    for f in tpbw._FIELDS:
        a, b = getattr(tp, f), getattr(jp, f)
        if b is None:
            assert a is None, f
            continue
        want = np.asarray(b)
        got = a.numpy().view(np.uint32) if f in ("sign_packed", "mask_packed") else a.numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("high_bits", [8, 4])
@pytest.mark.parametrize("groupsize", [-1, 128])
@pytest.mark.parametrize("method", METHODS)
def test_pack_linear_bit_identical(method, groupsize, high_bits):
    jp, jdiag, tp, tdiag = _packs(method, groupsize, high_bits)
    _assert_same_layer(tp, jp)
    assert tp.sidecar_bits == (4 if high_bits == 4 else 8)
    assert tp.pack_block == (128 if groupsize == 128 else 512)
    assert tdiag["pack_mismatch"] == jdiag["pack_mismatch"] == 0.0
    assert tp.effective_bits() == jp.effective_bits()
    np.testing.assert_array_equal(tpbw.dequantize(tp).numpy(), np.asarray(jpbw.dequantize(jp)))


@pytest.mark.parametrize("method", ["xnor", "4bit"])
def test_multi_block_planes_and_reference(method):
    """ic = 416 (pack block 416: one block) and ic = 1024 grouped by 256
    (four blocks): planes, and the reference matmul, whose products sum in
    another order in each package (tests/test_kernels.py's bound)."""
    for ic, gs in ((416, -1), (1024, 256)):
        jp, _, tp, _ = _packs(method, gs, 8, ic=ic, seed=ic)
        _assert_same_layer(tp, jp)
        x = np.random.default_rng(1).standard_normal((3, ic)).astype(np.float32)
        np.testing.assert_allclose(tpbw.matmul_reference(torch.from_numpy(x), tp).numpy(),
                                   np.asarray(jpbw.matmul_reference(jnp.asarray(x), jp)),
                                   rtol=1e-5, atol=1e-4)


def test_unpackable_method_raises():
    w_q, mask, low, high, _ = _solver_output("xnor", -1, 8)
    with pytest.raises(ValueError, match="packable"):
        tpbw.pack_linear(torch.from_numpy(w_q), torch.from_numpy(mask), low, high, "no")


def _layers():
    return {f"layer_0/{m}": _packs(m, gs, hb, seed=i)[0]
            for i, (m, gs, hb) in enumerate((("xnor", -1, 8), ("2bit", 128, 4), ("sign", -1, 4)))}


def test_pbw_checkpoint_from_jax_loads_identically(tmp_path):
    layers = _layers()
    jpbw.save_pbw(str(tmp_path), layers, {"model": "facebook/opt-synth"})
    loaded, extra = tpbw.load_pbw(str(tmp_path))
    assert extra == {"model": "facebook/opt-synth"} and sorted(loaded) == sorted(layers)
    for k, jp in layers.items():
        assert isinstance(loaded[k], tpbw.PackedLinear)
        _assert_same_layer(loaded[k], jp)


def test_pbw_checkpoint_from_the_port_loads_in_jax(tmp_path):
    layers = _layers()
    port = {k: packed_from_fields(jax.tree_util.tree_map(np.asarray, v)) for k, v in layers.items()}
    port["layer_1/fc1"] = random_packed_v1(256, 128, torch.Generator().manual_seed(0),
                                           groupsize=128, low_bits=4, sidecar_bits=4)
    tpbw.save_pbw(str(tmp_path), port, {"config": "x"})
    loaded, extra = jpbw.load_pbw(str(tmp_path))
    assert extra == {"config": "x"}
    for k, tp in port.items():
        assert isinstance(loaded[k], jpbw.PackedLinear)
        _assert_same_layer(tp, loaded[k])


def test_mixed_v1_v2_checkpoint_roundtrip(tmp_path):
    """One artifact may hold both formats; each layer keeps its own."""
    from pb_llm_tpu_torch.data.synthetic import random_packed_v2

    gen = torch.Generator().manual_seed(1)
    layers = {"layer_0/q_proj": random_packed_v1(128, 128, gen, bias=True),
              "layer_0/k_proj": random_packed_v2(128, 128, gen)}
    tpbw.save_pbw(str(tmp_path), layers)
    loaded, _ = tpbw.load_pbw(str(tmp_path))
    for k, p in layers.items():
        assert type(loaded[k]) is type(p)
        for f in tpbw.fields_of(p):
            a, b = getattr(p, f), getattr(loaded[k], f)
            assert (a is None and b is None) or torch.equal(a, b), (k, f)


def test_dense_checkpoint_with_packed_leaves_crosses_both_ways(tmp_path):
    """`utils.checkpoint` kind "packed": a JAX tree loads in the port and
    the port's tree loads in JAX, leaf for leaf."""
    jp = _packs("rtn", 128, 8)[0]
    tree = {"layers": [{"fc1": jp, "self_attn_layer_norm": {"w": jnp.ones(4), "b": jnp.zeros(4)}}],
            "project_in": None}
    jckpt.save_dense_checkpoint(str(tmp_path / "j"), tree, {"step": 1})
    got, extra = tckpt.load_dense_checkpoint(str(tmp_path / "j"))
    assert extra == {"step": 1} and got["project_in"] is None
    _assert_same_layer(got["layers"][0]["fc1"], jp)
    tckpt.save_dense_checkpoint(str(tmp_path / "t"), got)
    back, _ = jckpt.load_dense_checkpoint(str(tmp_path / "t"))
    _assert_same_layer(got["layers"][0]["fc1"], back["layers"][0]["fc1"])
    np.testing.assert_array_equal(np.asarray(back["layers"][0]["self_attn_layer_norm"]["w"]),
                                  np.ones(4, np.float32))


@pytest.mark.parametrize("as_dict", [False, True])
def test_from_jax_params_converts_v1_leaves(as_dict):
    jp = _packs("xnor", 128, 4)[0]
    leaf = jax.tree_util.tree_map(np.asarray, jp)
    if as_dict:
        leaf = {f.name: getattr(leaf, f.name) for f in jp.__dataclass_fields__.values()}
    tree = from_jax_params({"layers": [{"fc2": leaf}], "final_layer_norm": None})
    tp = tree["layers"][0]["fc2"]
    assert isinstance(tp, tpbw.PackedLinear) and tree["final_layer_norm"] is None
    _assert_same_layer(tp, jp)
    assert tp.sign_packed.dtype == tp.mask_packed.dtype == torch.int32


def test_local_dims_and_to():
    p = random_packed_v1(1024, 256, torch.Generator().manual_seed(2), groupsize=128, low_bits=2,
                         sidecar_bits=4, bias=True)
    assert (p.ic_local, p.oc_local, p.words_per_plane, p.n_groups) == (1024, 256, 32, 8)
    assert (p.groupsize_local, p.pack_block_local) == (128, 128)
    q = p.to("cpu")
    assert q.coef_cache is None and torch.equal(q.sidecar, p.sidecar)


def test_random_packed_v1_keeps_the_pack_convention():
    """Low codes zero at salient positions, high codes zero elsewhere, so
    the planar decomposition holds; about 1 − low_frac salient."""
    from pb_llm_tpu_torch.core import packing

    p = random_packed_v1(512, 128, torch.Generator().manual_seed(3), low_frac=0.8, low_bits=2)
    m = packing.unpack_bits(p.mask_packed, 512, p.pack_block).bool()
    code = tpbw.low_code(p.sign_packed, 2, 512, p.pack_block)
    assert not code[m].any() and not tpbw.sidecar_codes(p)[~m].any()
    assert 0.17 < m.float().mean().item() < 0.23
