"""Port parity: the int8 PBW-v2 matmul (`pb_llm_tpu_torch.ops.packed_matmul`)
against the JAX package's Pallas int8 kernel run in interpret mode, plus the
dispatch of `ops.binary_matmul.pb_matmul`.  The CUDA kernel itself is held
against its plain version on the card by tests/test_torch_cuda_kernels.py
and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.core import pbw as jpbw
from pb_llm_tpu.ops import pallas_pb
from pb_llm_tpu.quant.high_quant import high_calibrate, high_quantize
from pb_llm_tpu.quant.low_quant import low_calibrate, low_quantize
from pb_llm_tpu_torch.core import pbw as tpbw
from pb_llm_tpu_torch.interop import packed_from_fields
from pb_llm_tpu_torch.ops import binary_matmul, decode_arms, packed_matmul, prefill
from pb_llm_tpu_torch.ops.kernel_config import KernelConfig, use_kernels

torch.set_num_threads(2)


def _layer(oc, ic, col_tile=0, high_bits=8, low_frac=0.9, seed=0, bias=True):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((oc, ic)).astype(np.float32)
    w *= (1.0 + 3.0 * (rng.random(ic) < 0.1))[None, :]
    mask = np.asarray(jpbw.column_structured_mask(jnp.abs(jnp.asarray(w)), low_frac, col_tile))
    low = low_calibrate(jnp.asarray(w * mask), "xnor", -1)
    high = high_calibrate(jnp.asarray(w), bits=high_bits)
    w_q = np.where(mask, np.asarray(low_quantize(jnp.asarray(w), low, "xnor", -1)),
                   np.asarray(high_quantize(jnp.asarray(w), high)))
    b = jnp.asarray(rng.standard_normal(oc).astype(np.float32)) if bias else None
    jp, _ = jpbw.pack_linear_v2(jnp.asarray(w_q), jnp.asarray(mask), low, high, "xnor",
                                col_tile=col_tile, bias=b)
    return jp, packed_from_fields(jp)


LAYERS = {
    "side8": dict(oc=256, ic=256),
    "side4": dict(oc=256, ic=256, high_bits=4),
    "rowgroups": dict(oc=256, ic=256, col_tile=128),
    "side4_rowgroups": dict(oc=256, ic=256, col_tile=128, high_bits=4),
    "multiblock": dict(oc=128, ic=416),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
@pytest.mark.parametrize("m", [4, 300])
def test_int8_plain_matches_jax_int8_kernel(name, m):
    jp, tp = _layer(**LAYERS[name])
    x = np.random.default_rng(m).standard_normal((m, jp.ic)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(pallas_pb.pb_matmul_pallas_v2(
            jnp.asarray(x), jp, interpret=True, decode_dot="int8", prefill_int8=True))
    got = packed_matmul.pb_int8_matmul(torch.from_numpy(x), tp).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale, (name, m)


def test_int8_exact_at_unit_scale():
    """Integer x with every row's absmax 127 (sx == 1): int8 quantization is
    lossless and every integer dot and rowsum is exact on both sides, so the
    port's int8 path equals the JAX int8 kernel and the exact f32 kernel
    (test_pbw_v2.py::test_v2_decode_dot_int8_exact_at_unit_scale) up to the
    f32 rounding of the five-term epilogue, where XLA on the CPU contracts
    multiply-adds into FMAs and the port does not: 1e-6 of max|y| is a few
    ulps of the largest term."""
    jp, tp = _layer(256, 256)
    x = np.random.default_rng(14).integers(-127, 128, size=(4, 256)).astype(np.float32)
    x[:, 0] = 127.0
    with jax.default_matmul_precision("float32"):
        i8 = np.asarray(pallas_pb.pb_matmul_pallas_v2(
            jnp.asarray(x), jp, interpret=True, oc_tile=128, decode_dot="int8"))
        f32 = np.asarray(pallas_pb.pb_matmul_pallas_v2(
            jnp.asarray(x), jp, interpret=True, oc_tile=128, decode_dot="f32"))
    got = packed_matmul.pb_int8_matmul(torch.from_numpy(x), tp).numpy()
    ulps = 1e-6 * np.abs(f32).max()
    np.testing.assert_allclose(got, i8, rtol=0, atol=ulps)
    np.testing.assert_allclose(got, f32, rtol=0, atol=ulps)


def test_prepare_int8_matches_jax_quantization():
    """x8 = clip(round_half_even(x / sx)), sx = max(absmax, 1e-30)/127 —
    including exact .5 ties and an all-zero row."""
    x = np.array([[0.5, 1.5, 2.5, -0.5, 127.0] + [0.0] * 27,
                  [0.0] * 32], np.float32)
    jp, tp = _layer(128, 32, low_frac=0.75)
    ops = packed_matmul.prepare_int8(torch.from_numpy(x), tp)
    xp = jnp.asarray(x)
    sx = jnp.maximum(jnp.max(jnp.abs(xp), axis=1, keepdims=True), 1e-30) / 127.0
    want = np.asarray(jnp.clip(jnp.round(xp / sx), -127, 127).astype(jnp.int8))
    np.testing.assert_array_equal(ops.x8.numpy(), want)
    np.testing.assert_array_equal(ops.sx.numpy(), np.asarray(sx)[:, 0])


def test_dispatch_arms():
    """The arm table of `pb_matmul` on CPU tensors: "auto" takes the
    reference; the kernel arms' plain versions by decode_dot and prefill,
    "pair" and "dma" included."""
    jp, tp = _layer(256, 256)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 256)).astype(np.float32))
    ref = tpbw.matmul_reference_v2(x, tp)
    with use_kernels(KernelConfig()):  # auto on the CPU: the XLA reference
        torch.testing.assert_close(binary_matmul.pb_matmul(x, tp), ref, rtol=0, atol=0)
    with use_kernels(KernelConfig(backend="pallas_interpret")):
        np.testing.assert_array_equal(binary_matmul.pb_matmul(x, tp).numpy(),
                                      packed_matmul.pb_int8_matmul_plain(x, tp).numpy())
    with use_kernels(KernelConfig(backend="pallas_interpret", decode_dot="f32")):
        np.testing.assert_array_equal(binary_matmul.pb_matmul(x, tp).numpy(),
                                      packed_matmul.pb_f32_matmul_plain(x, tp).numpy())
    for arm, plain in (("pair", decode_arms.pb_pair_v2_plain), ("dma", decode_arms.pb_dma_v2_plain)):
        with use_kernels(KernelConfig(backend="pallas_interpret", decode_dot=arm)):
            np.testing.assert_array_equal(binary_matmul.pb_matmul(x, tp).numpy(),
                                          plain(x, tp).numpy())
    x_big = torch.zeros((256, 256))
    with use_kernels(KernelConfig(backend="pallas_interpret", prefill="hybrid")):
        np.testing.assert_array_equal(binary_matmul.pb_matmul(x_big, tp).numpy(),
                                      prefill.v2_prefill(x_big, tp, plain=True).numpy())


def test_kernel_counter_counts_only_launches():
    _, tp = _layer(128, 128)
    before = packed_matmul.launches
    packed_matmul.pb_int8_matmul(torch.zeros((2, 128)), tp)  # CPU: plain version
    assert packed_matmul.launches == before

