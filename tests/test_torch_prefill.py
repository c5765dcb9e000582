"""Port parity for the exact PBW-v2 arms: the binary-part dequant, the
hybrid prefill and the exact f32 matmul (`pb_llm_tpu_torch.ops.prefill`,
`ops.packed_matmul.pb_f32_matmul*`) against the JAX package's Pallas
kernels run in interpret mode, and the `pb_matmul` arm table against the
JAX dispatch.  The CUDA kernels themselves are held against these plain
versions on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).

Tolerances: the dequant is one rounded multiply and add per value, so the
plain version equals `dequant_v2_binary_xla` bit for bit, and the JAX
Pallas kernel too at 1-bit lows; at 2- and 4-bit lows XLA on the CPU fuses
the kernel's β + α·code2 into an FMA, one ulp off its own XLA twin.  The
products (prefill, f32 matmul) sum in another order than XLA's dots: rtol
and atol 1e-4, the JAX package's bound for them (test_pbw_v2.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.core import pbw as jpbw
from pb_llm_tpu.ops import binary_matmul as jbm
from pb_llm_tpu.ops import kernel_config as jkc
from pb_llm_tpu.ops import pallas_pb
from pb_llm_tpu.quant.high_quant import high_calibrate, high_quantize
from pb_llm_tpu.quant.low_quant import low_calibrate, low_quantize
from pb_llm_tpu_torch.interop import packed_from_fields
from pb_llm_tpu_torch.ops import binary_matmul, packed_matmul, prefill
from pb_llm_tpu_torch.ops import kernel_config as tkc

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _layer(oc, ic, method="xnor", col_tile=0, high_bits=8, low_frac=0.9, ic_shards=1,
           pack_block=None, seed=0):
    """A calibrated PBW-v2 layer packed by the JAX package (weights at a
    realistic 0.05 scale, so outputs are O(1)) → (JAX layer, port layer)."""
    rng = np.random.default_rng(seed)
    w = 0.05 * rng.standard_normal((oc, ic)).astype(np.float32)
    w *= (1.0 + 3.0 * (rng.random(ic) < 0.1))[None, :]
    mask = np.asarray(jpbw.column_structured_mask(jnp.abs(jnp.asarray(w)), low_frac, col_tile,
                                                  ic_shards))
    low = low_calibrate(jnp.asarray(w * mask), method, -1)
    high = high_calibrate(jnp.asarray(w), bits=high_bits)
    w_q = np.where(mask, np.asarray(low_quantize(jnp.asarray(w), low, method, -1)),
                   np.asarray(high_quantize(jnp.asarray(w), high)))
    b = jnp.asarray(0.1 * rng.standard_normal(oc).astype(np.float32))
    jp, _ = jpbw.pack_linear_v2(jnp.asarray(w_q), jnp.asarray(mask), low, high, method,
                                col_tile=col_tile, bias=b, ic_shards=ic_shards,
                                pack_block=pack_block)
    return jp, packed_from_fields(jp)


def _x(m, ic, seed=0):
    return np.random.default_rng(seed).standard_normal((m, ic)).astype(np.float32)


# ---------------------------------------------------------------------------
# binary-part dequant
# ---------------------------------------------------------------------------

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("method,pack_block", [("xnor", None), ("xnor", 128), ("2bit", None),
                                               ("4bit", None)])
def test_dequant_plain_matches_jax(method, pack_block, dt):
    jp, tp = _layer(256, 416 if pack_block else 256, method=method, pack_block=pack_block)
    tdt, jdt = DTYPES[dt]
    got = prefill.dequant_v2_binary_plain(tp, tdt)
    assert got.dtype == tdt
    got = got.float().numpy()
    xla = np.asarray(pallas_pb.dequant_v2_binary_xla(jp, dtype=jdt).astype(jnp.float32))
    kern = np.asarray(pallas_pb._dequant_v2_binary(jp, dtype=jdt, oc_tile=128, interpret=True)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(got, xla)
    if method == "xnor":
        np.testing.assert_array_equal(got, kern)
    else:  # the JAX kernel's FMA: one ulp of the working type
        ulp = np.spacing(np.abs(kern).max().astype(np.float32)) * (65536 if dt == "bf16" else 1)
        np.testing.assert_allclose(got, kern, rtol=0, atol=ulp)


def test_dequant_wrapper_on_cpu_is_the_plain_version():
    _, tp = _layer(128, 128)
    before = prefill.launches
    torch.testing.assert_close(prefill.dequant_v2_binary(tp), prefill.dequant_v2_binary_plain(tp),
                               rtol=0, atol=0)
    assert prefill.launches == before


def test_dequant_full_matches_jax():
    jp, tp = _layer(256, 256, seed=2)
    want = np.asarray(pallas_pb.dequant_v2_pallas(jp, dtype=jnp.float32, oc_tile=128, interpret=True))
    np.testing.assert_array_equal(prefill.dequant_v2_full(tp).numpy(), want)
    np.testing.assert_allclose(prefill.dequant_v2_full(tp).numpy(), np.asarray(jpbw.dequantize_v2(jp)),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# hybrid prefill
# ---------------------------------------------------------------------------

PREFILL_LAYERS = {
    "side8": dict(oc=256, ic=256),
    "side4": dict(oc=256, ic=256, high_bits=4),
    "shards2": dict(oc=256, ic=256, ic_shards=2),
    "shards2_side4": dict(oc=256, ic=256, ic_shards=2, high_bits=4),
    "low4": dict(oc=256, ic=256, method="4bit"),
    "rowgroups": dict(oc=256, ic=256, col_tile=128),  # falls through to the f32 matmul
}


GATHERS = [("take", "pallas"), ("dot", "pallas"), ("take", "xla"), ("dot", "xla")]
PREFILL_CASES = ([(n, g, e) for n in ("side8", "shards2", "shards2_side4") for g, e in GATHERS]
                 + [(n, "take", "pallas") for n in ("side4", "low4", "rowgroups")])


@pytest.mark.parametrize("name,gather,extract", PREFILL_CASES)
def test_v2_prefill_matches_jax(name, gather, extract):
    jp, tp = _layer(**PREFILL_LAYERS[name])
    x = _x(300, jp.ic, seed=9)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(pallas_pb._v2_prefill_call(jnp.asarray(x), jp, 128, True, jnp.float32,
                                                     gather=gather, extract=extract))
    got = prefill.v2_prefill(torch.from_numpy(x), tp, gather=gather, extract=extract).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    sentinel = np.asarray(jp.side_idx) == jp.ic_shard_local
    assert name == "rowgroups" or sentinel.any()  # the zero column is read


def test_v2_prefill_bf16_dots_match_jax():
    """hybrid_bf16: operands round to bf16, the products accumulate in f32."""
    jp, tp = _layer(256, 256)
    x = _x(300, 256, seed=3)
    want = np.asarray(pallas_pb._v2_prefill_call(jnp.asarray(x), jp, 128, True, jnp.bfloat16))
    got = prefill.v2_prefill(torch.from_numpy(x), tp, dot_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# exact f32 matmul
# ---------------------------------------------------------------------------

F32_LAYERS = {
    "global": dict(oc=256, ic=256),
    "rowgroups": dict(oc=256, ic=256, col_tile=128),
    "rowgroups64_side4": dict(oc=256, ic=256, col_tile=64, high_bits=4),
    "shards2": dict(oc=256, ic=256, ic_shards=2),
    "multiblock": dict(oc=128, ic=416, pack_block=128),
    "low2": dict(oc=256, ic=256, method="2bit"),
    "low4_rowgroups": dict(oc=256, ic=256, method="4bit", col_tile=128),
}


F32_CASES = ([(n, m, "f32") for n in sorted(F32_LAYERS) for m in (8, 300)]
             + [(n, m, "bf16") for n in ("global", "rowgroups") for m in (8, 300)])


@pytest.mark.parametrize("name,m,dt", F32_CASES)
def test_f32_matmul_plain_matches_jax(name, m, dt):
    jp, tp = _layer(**F32_LAYERS[name])
    tdt, jdt = DTYPES[dt]
    x = _x(m, jp.ic, seed=m)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(pallas_pb._planar_v2_call(jnp.asarray(x), jp, 128, True, jdt))
    got = packed_matmul.pb_f32_matmul_plain(torch.from_numpy(x), tp, dot_dtype=tdt)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    before = packed_matmul.f32_launches
    np.testing.assert_array_equal(packed_matmul.pb_f32_matmul(torch.from_numpy(x), tp, tdt).numpy(),
                                  got.numpy())
    assert packed_matmul.f32_launches == before  # a CPU tensor takes the plain version


# ---------------------------------------------------------------------------
# the arm table of pb_matmul against the JAX dispatch
# ---------------------------------------------------------------------------

ARMS = {
    "decode_int8": dict(decode_dot="int8"),
    "decode_f32": dict(decode_dot="f32"),
    "decode_bf16": dict(decode_dot="bf16"),
    "prefill_int8": dict(prefill="int8"),
    "prefill_hybrid": dict(prefill="hybrid"),
    "prefill_hybrid_bf16": dict(prefill="hybrid_bf16", prefill_gather="dot", prefill_extract="xla"),
}


@pytest.mark.parametrize("layer", ["global", "rowgroups", "low2"])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_pb_matmul_arm_table_matches_jax(arm, layer):
    kw = ARMS[arm]
    m = 8 if arm.startswith("decode") else 300
    jp, tp = _layer(**F32_LAYERS[layer])
    x = _x(m, jp.ic, seed=5)
    with jkc.use_kernels(jkc.KernelConfig(backend="pallas_interpret", **kw)), \
            jax.default_matmul_precision("float32"):
        want = np.asarray(jbm.pb_matmul(jnp.asarray(x), jp))
    with tkc.use_kernels(tkc.KernelConfig(backend="pallas_interpret", **kw)):
        got = binary_matmul.pb_matmul(torch.from_numpy(x), tp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
