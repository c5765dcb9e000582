"""Port parity: the PBW-v1 matmuls (`pb_llm_tpu_torch.ops.packed_matmul_v1`)
against the JAX package's Pallas planar and select kernels run in interpret
mode, at the shapes and tolerances of tests/test_kernels.py (rtol 1e-5,
atol 1e-4; 2e-4 where the select kernel's dot sums over ic tiles in its own
order), plus `pb_matmul`'s v1 dispatch arm by arm against
`pb_llm_tpu.ops.binary_matmul.pb_matmul` under the same `KernelConfig`.
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda_kernels.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.core import pbw as jpbw
from pb_llm_tpu.ops import binary_matmul as jbm
from pb_llm_tpu.ops import pallas_pb
from pb_llm_tpu.ops.kernel_config import KernelConfig as JKernelConfig
from pb_llm_tpu.ops.kernel_config import use_kernels as juse_kernels
from pb_llm_tpu.quant.high_quant import high_calibrate, high_quantize
from pb_llm_tpu.quant.low_quant import low_calibrate, low_quantize
from pb_llm_tpu_torch.core import pbw as tpbw
from pb_llm_tpu_torch.interop import packed_from_fields
from pb_llm_tpu_torch.ops import binary_matmul as tbm
from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1
from pb_llm_tpu_torch.ops.kernel_config import KernelConfig, use_kernels

torch.set_num_threads(2)


def _packed(oc, ic, groupsize=-1, frac_binary=0.8, seed=0, bias=False, method="xnor",
            high_bits=8):
    """tests/test_kernels.py's `_packed`: JAX pack_linear of an element-wise
    mask; returns (JAX layer, port layer)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((oc, ic)).astype(np.float32)
    mask = np.abs(w) <= np.quantile(np.abs(w), frac_binary)
    low = low_calibrate(jnp.asarray(w * mask), method, groupsize)
    high = high_calibrate(jnp.asarray(w), bits=high_bits)
    w_q = np.where(mask, np.asarray(low_quantize(jnp.asarray(w), low, method, groupsize)),
                   np.asarray(high_quantize(jnp.asarray(w), high)))
    b = jnp.asarray(rng.standard_normal(oc).astype(np.float32)) if bias else None
    jp, diag = jpbw.pack_linear(jnp.asarray(w_q), jnp.asarray(mask), low, high, method, groupsize,
                                bias=b)
    assert diag["pack_mismatch"] == 0.0
    return jp, packed_from_fields(jax.tree_util.tree_map(np.asarray, jp))


def _x(m, ic, seed):
    return np.random.default_rng(seed).standard_normal((m, ic)).astype(np.float32)


def _jax_pallas(x, jp, **kw):
    with jax.default_matmul_precision("float32"):
        return np.asarray(pallas_pb.pb_matmul_pallas(jnp.asarray(x), jp, interpret=True, **kw))


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("oc,ic,gs", [
    (128, 256, -1),   # single ic tile
    (256, 512, -1),   # multi oc + ic tiles
    (128, 512, 256),  # groupsize == ic tile
    (128, 512, 128),  # two groups per ic tile
    (128, 64, -1),    # short ic (< one pack block)
])
def test_plain_matches_pallas(oc, ic, gs):
    """test_kernels.py:29-45 (m = 5: the planar arm), and the select arm's
    plain version at the same m against `_select_call`."""
    jp, tp = _packed(oc, ic, groupsize=gs, bias=True)
    assert v1.kernel_supported_v1(tp) == pallas_pb.pallas_supported(jp) is True
    x = _x(5, ic, 1)
    assert v1.use_planar(5, tp)
    _close(tbm.pb_matmul_v1(torch.from_numpy(x), tp, plain=True).numpy(), _jax_pallas(x, jp))
    with jax.default_matmul_precision("float32"):
        sel = np.asarray(pallas_pb._select_call(jnp.asarray(x), jp, pallas_pb._default_oc_tile(oc),
                                                True))
    _close(v1.pb_select_v1_plain(torch.from_numpy(x), tp).numpy(), sel)


def test_no_bias_and_tall_x():
    jp, tp = _packed(128, 256, bias=False)
    x = _x(64, 256, 2)
    _close(v1.pb_planar_v1(torch.from_numpy(x), tp).numpy(), _jax_pallas(x, jp))


@pytest.mark.parametrize("m", [5, 300])
def test_nibble_sidecar(m):
    """test_kernels.py:76-100 and :127-141: --high_bit 4 packs nibbles;
    planar at m = 5, select at m = 300 (atol 2e-4)."""
    jp, tp = _packed(128, 512, frac_binary=0.7, seed=8, high_bits=4)
    assert tp.sidecar_bits == 4 and tuple(tp.sidecar.shape) == (256, 128)
    x = _x(m, 512, 5)
    got = tbm.pb_matmul_v1(torch.from_numpy(x), tp, plain=True).numpy()
    _close(got, _jax_pallas(x, jp), atol=2e-4)


def test_large_m_select():
    """test_kernels.py:116-124: m ≥ 256 routes to the one-dot select."""
    jp, tp = _packed(128, 512)
    x = _x(300, 512, 7)
    assert not v1.use_planar(300, tp)
    _close(v1.pb_select_v1(torch.from_numpy(x), tp).numpy(), _jax_pallas(x, jp), atol=2e-4)


@pytest.mark.parametrize("m", [5, 300])
@pytest.mark.parametrize("method", ["2bit", "4bit"])
def test_multiplane_low(method, m):
    """test_kernels.py:177-193: plane-major 2- and 4-bit lows."""
    jp, tp = _packed(128, 512, seed=12, method=method)
    x = _x(m, 512, 12)
    _close(tbm.pb_matmul_v1(torch.from_numpy(x), tp, plain=True).numpy(), _jax_pallas(x, jp),
           atol=2e-4)


@pytest.mark.parametrize("oc,ic,gs", [(128, 512, 128), (128, 512, 256), (256, 256, 64)])
def test_planar_grouped(oc, ic, gs):
    """test_kernels.py:196-208: grouped scales on the planar arm, against
    `_planar_call` directly."""
    jp, tp = _packed(oc, ic, groupsize=gs, bias=True)
    assert tp.pack_block <= gs and gs % tp.pack_block == 0
    assert v1.planar_ok(8, tp) and pallas_pb._planar_ok(8, jp)
    x = _x(8, ic, 3)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(pallas_pb._planar_call(jnp.asarray(x), jp, pallas_pb._default_oc_tile(oc),
                                                 interpret=True))
    _close(v1.pb_planar_v1_plain(torch.from_numpy(x), tp).numpy(), want)


def test_select_bf16_matches_pallas():
    """prefill "hybrid_bf16": x and w rounded to bf16, f32 sums."""
    jp, tp = _packed(128, 512, groupsize=128, bias=True)
    x = _x(300, 512, 4)
    got = v1.pb_select_v1_plain(torch.from_numpy(x), tp, torch.bfloat16).numpy()
    _close(got, _jax_pallas(x, jp, prefill_bf16=True), atol=2e-4)


def test_select_weight_is_the_blend():
    """The rebuilt weight is the reference weight up to the blend's own
    rounding: w_bin + (w_hi − w_bin) is w_hi within an ulp of |w_bin|."""
    _, tp = _packed(128, 512, groupsize=128)
    w, ref = v1.select_weight(tp), tpbw.dequantize(tp)
    assert torch.allclose(w, ref, rtol=0, atol=1e-6)


def test_planar_ok_and_dispatch_follow_jax_at_wide_ic():
    """ic = 16384: the TPU VMEM budget sends m > 144 to the select arm in
    JAX; the port takes the same arm at every m, and matches at m = 160."""
    jp, tp = _packed(128, 16384, seed=9, bias=True)
    for m in (1, 8, 120, 144, 145, 160, 255, 256):
        assert v1.planar_ok(m, tp) == pallas_pb._planar_ok(m, jp), m
        assert v1.use_planar(m, tp) == (m < 256 and pallas_pb._planar_ok(m, jp)), m
    assert v1.use_planar(144, tp) and not v1.use_planar(145, tp)
    x = _x(160, 16384, 10)
    _close(tbm.pb_matmul_v1(torch.from_numpy(x), tp, plain=True).numpy(), _jax_pallas(x, jp),
           atol=2e-4)


@pytest.mark.parametrize("oc,ic,gs", [(48, 32, -1), (128, 96, 64), (128, 512, 96)])
def test_unsupported_layouts_agree(oc, ic, gs):
    jp, tp = _packed(oc, ic, groupsize=gs)
    assert v1.kernel_supported_v1(tp) == pallas_pb.pallas_supported(jp)
    assert v1.default_oc_tile(oc) == pallas_pb._default_oc_tile(oc)


@pytest.mark.parametrize("m", [3, 300])
@pytest.mark.parametrize("arms", [
    dict(backend="xla"),
    dict(backend="pallas_interpret", prefill="hybrid"),
    dict(backend="pallas_interpret", prefill="hybrid_bf16"),
    dict(backend="pallas_interpret", prefill="int8", decode_dot="int8"),
    dict(backend="auto"),
])
def test_dispatch_matches_jax_arm_by_arm(arms, m):
    """Under one KernelConfig, `pb_matmul` takes the JAX arm: "auto" is the
    reference on the CPU, v1 reads only prefill "hybrid_bf16" and neither
    decode_dot nor the int8 prefill."""
    jp, tp = _packed(256, 512, groupsize=128, bias=True)
    x = _x(m, 512, m)
    with juse_kernels(JKernelConfig(**arms)), jax.default_matmul_precision("float32"):
        want = np.asarray(jbm.pb_matmul(jnp.asarray(x), jp))
    with use_kernels(KernelConfig(**arms)):
        got = tbm.pb_matmul(torch.from_numpy(x), tp).numpy()
    _close(got, want, atol=2e-4)


def test_unsupported_layer_takes_the_reference():
    jp, tp = _packed(48, 32)
    x = _x(2, 32, 4)
    with use_kernels(KernelConfig(backend="pallas_interpret")):
        got = tbm.pb_matmul(torch.from_numpy(x), tp).numpy()
    _close(got, np.asarray(jpbw.matmul_reference(jnp.asarray(x), jp)))


def test_wrappers_refuse_other_devices():
    _, tp = _packed(128, 256)
    with pytest.raises(ValueError, match="unsupported device"):
        v1.pb_planar_v1(torch.zeros((2, 256), device="meta"), tp)
    with pytest.raises(ValueError, match="unsupported device"):
        v1.pb_select_v1(torch.zeros((300, 256), device="meta"), tp)
