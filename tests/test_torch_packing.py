"""Port parity: PBW packing, v2 layers, dequantization and checkpoints of
`pb_llm_tpu_torch.core` against `pb_llm_tpu.core` — bit-identical."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.core import packing as jpacking
from pb_llm_tpu.core import pbw as jpbw
from pb_llm_tpu.quant.high_quant import high_calibrate, high_quantize
from pb_llm_tpu.quant.low_quant import low_calibrate, low_quantize
from pb_llm_tpu_torch.core import packing as tpacking
from pb_llm_tpu_torch.core import pbw as tpbw
from pb_llm_tpu_torch.interop import packed_from_fields

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(t):
    return t.detach().cpu().numpy()


def _states_np(st):
    return {k: np.asarray(v) for k, v in st.items()}


def _make_v2(oc=64, ic=128, method="xnor", low_frac=0.8, col_tile=16, seed=0, bias=False,
             high_bits=8, ic_shards=1, pack_block=None, k_multiple=32):
    """The JAX package's own test recipe (tests/test_pbw_v2.py::_make_v2);
    returns what both packers need plus the JAX-packed layer."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((oc, ic)).astype(np.float32)
    w *= (1.0 + 3.0 * (rng.random(ic) < 0.1))[None, :]
    mask = np.asarray(jpbw.column_structured_mask(jnp.abs(jnp.asarray(w)), low_frac, col_tile,
                                                  ic_shards=ic_shards))
    low_state = low_calibrate(jnp.asarray(w * mask), method, -1)
    high_state = high_calibrate(jnp.asarray(w), bits=high_bits)
    q_low = np.asarray(low_quantize(jnp.asarray(w), low_state, method, -1))
    q_high = np.asarray(high_quantize(jnp.asarray(w), high_state))
    w_q = np.where(mask, q_low, q_high)
    b = rng.standard_normal(oc).astype(np.float32) if bias else None
    kw = dict(col_tile=col_tile, ic_shards=ic_shards, pack_block=pack_block, k_multiple=k_multiple)
    jp, _ = jpbw.pack_linear_v2(jnp.asarray(w_q), jnp.asarray(mask), low_state, high_state,
                                method, bias=None if b is None else jnp.asarray(b), **kw)
    return dict(w=w, w_q=w_q, mask=mask, low=_states_np(low_state), high=_states_np(high_state),
                method=method, bias=b, kw=kw, jp=jp)


CASES = {
    "xnor": dict(method="xnor"),
    "sign": dict(method="sign"),
    "rtn": dict(method="rtn"),
    "prune": dict(method="prune"),
    "2bit": dict(method="2bit"),
    "side4": dict(oc=64, ic=128, high_bits=4),
    "side4_rowgroups": dict(oc=256, ic=256, col_tile=64, high_bits=4),
    "global": dict(oc=256, ic=256, col_tile=0, low_frac=0.9, bias=True),
    "shards": dict(oc=64, ic=128, ic_shards=4, col_tile=16, pack_block=32, k_multiple=8),
    "side4_shards": dict(oc=64, ic=256, ic_shards=4, col_tile=0, pack_block=64, high_bits=4),
}


@pytest.mark.parametrize("ic,block", [(256, 256), (416, 128), (1376, 1376), (96, 64)])
def test_pack_unpack_bits_bit_identical(ic, block):
    rng = np.random.default_rng(ic)
    bits = (rng.random((ic, 48)) < 0.5).astype(np.uint32)
    want = np.asarray(jpacking.pack_bits(jnp.asarray(bits), block))
    got = tpacking.pack_bits(torch.from_numpy(bits.astype(np.int64)), block)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got).view(np.uint32), want)
    back = tpacking.unpack_bits(torch.from_numpy(np.array(want.view(np.int32))), ic, block)
    np.testing.assert_array_equal(_np(back), np.asarray(jpacking.unpack_bits(jnp.asarray(want), ic, block)))
    assert tpacking.block_sizes(ic, block) == jpacking.block_sizes(ic, block)
    assert tpacking.default_pack_block(ic) == jpacking.default_pack_block(ic)


@pytest.mark.parametrize("ic,block", [(256, 256), (416, 128)])
def test_nibbles_bit_identical(ic, block):
    codes = np.random.default_rng(1).integers(0, 16, size=(ic, 40)).astype(np.uint8)
    want = jpacking.pack_nibbles_np(codes, block)
    got = _np(tpacking.pack_nibbles(torch.from_numpy(codes), block))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_np(tpacking.unpack_nibbles(torch.from_numpy(want), ic, block)),
                                  jpacking.unpack_nibbles_np(want, ic, block))


@pytest.mark.parametrize("col_tile,shards", [(16, 1), (0, 1), (16, 4)])
def test_column_structured_mask_identical_with_ties(col_tile, shards):
    rng = np.random.default_rng(2)
    metric = rng.integers(0, 4, size=(64, 128)).astype(np.float32)  # many ties
    want = np.asarray(jpbw.column_structured_mask(jnp.asarray(metric), 0.85, col_tile, shards))
    got = _np(tpbw.column_structured_mask(metric, 0.85, col_tile, shards))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_linear_v2_bit_identical(case):
    c = _make_v2(**CASES[case])
    tp, diag = tpbw.pack_linear_v2(c["w_q"], c["mask"], c["low"], c["high"], c["method"],
                                   bias=c["bias"], **c["kw"])
    jp = c["jp"]
    assert diag["pack_mismatch"] == 0.0
    for f in ("ic", "oc", "col_tile", "pack_block", "k_pad_shard", "side_bits", "low_bits"):
        assert getattr(tp, f) == getattr(jp, f), f
    np.testing.assert_array_equal(_np(tp.sign_packed).view(np.uint32), np.asarray(jp.sign_packed))
    for f in ("side_val", "side_idx", "low_scale", "low_mean", "high_scale", "high_zero"):
        np.testing.assert_array_equal(_np(getattr(tp, f)), np.asarray(getattr(jp, f)), err_msg=f)
    assert tp.shards_local == jp.shards_local and tp.k_pad == jp.k_pad
    np.testing.assert_array_equal(_np(tpbw.dequantize_v2(tp)), np.asarray(jpbw.dequantize_v2(jp)))
    np.testing.assert_array_equal(
        _np(tpbw.unpack_side_codes(tp.side_val, tp.side_bits, tp.shards_local)),
        np.asarray(jpbw.unpack_side_codes(jp.side_val, jp.side_bits, jp.shards_local)))
    x = np.random.default_rng(3).standard_normal((5, tp.ic)).astype(np.float32)
    np.testing.assert_array_equal(_np(tpbw.gather_x_v2(torch.from_numpy(x), tp)),
                                  np.asarray(jpbw.gather_x_v2(jnp.asarray(x), jp)))


def test_rejects_unstructured_mask():
    rng = np.random.default_rng(7)
    w = rng.standard_normal((32, 64)).astype(np.float32)
    mask = rng.random((32, 64)) < 0.9
    low = _states_np(low_calibrate(jnp.asarray(w * mask), "xnor", -1))
    high = _states_np(high_calibrate(jnp.asarray(w), bits=8))
    with pytest.raises(ValueError, match="column-structured"):
        tpbw.pack_linear_v2(w, mask, low, high, "xnor", col_tile=16)


@pytest.mark.parametrize("case", ["xnor", "side4", "shards"])
def test_checkpoints_cross_both_ways(tmp_path, case):
    c = _make_v2(**dict(CASES[case], bias=True))
    jp = c["jp"]
    jpbw.save_pbw(str(tmp_path / "from_jax"), {"layer_0/q_proj": jp}, extra_meta={"k": 1})
    loaded, extra = tpbw.load_pbw(str(tmp_path / "from_jax"))
    tp = loaded["layer_0/q_proj"]
    assert extra == {"k": 1} and tp.k_pad == jp.k_pad
    np.testing.assert_array_equal(_np(tpbw.dequantize_v2(tp)), np.asarray(jpbw.dequantize_v2(jp)))

    tpbw.save_pbw(str(tmp_path / "from_torch"), {"layer_0/q_proj": tp})
    back, _ = jpbw.load_pbw(str(tmp_path / "from_torch"))
    jb = back["layer_0/q_proj"]
    assert jb.sign_packed.dtype == jnp.uint32
    np.testing.assert_array_equal(np.asarray(jpbw.dequantize_v2(jb)), np.asarray(jpbw.dequantize_v2(jp)))


def test_sharded_checkpoint_loads(tmp_path):
    c = _make_v2(**CASES["global"])
    w = jpbw.PBWShardWriter(str(tmp_path / "sh"))
    w.add_layer("layer_0/up_proj", c["jp"])
    w.finalize()
    loaded, _ = tpbw.load_pbw(str(tmp_path / "sh"))
    np.testing.assert_array_equal(_np(tpbw.dequantize_v2(loaded["layer_0/up_proj"])),
                                  np.asarray(jpbw.dequantize_v2(c["jp"])))


def test_interop_packed_from_jax_dataclass():
    c = _make_v2(**CASES["side4_rowgroups"])
    tp = packed_from_fields(c["jp"])
    np.testing.assert_array_equal(_np(tpbw.dequantize_v2(tp)), np.asarray(jpbw.dequantize_v2(c["jp"])))


def test_port_imports_without_jax():
    """The port never imports jax or the JAX package: import every module
    with jax blocked in sys.modules."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import pb_llm_tpu_torch\n"
        "for m in pkgutil.walk_packages(pb_llm_tpu_torch.__path__, 'pb_llm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'pb_llm_tpu' or k.startswith('pb_llm_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_port_sources_name_no_jax():
    """Source-level check of the same rule, chip_smoke.py included."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pb_llm_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as fh:
            for line in fh:
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    mod = s.split()[1]
                    assert mod.split(".")[0] not in ("jax", "jaxlib", "pb_llm_tpu"), (path, s)
