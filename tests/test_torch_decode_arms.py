"""Port parity for the PBW-v2 decode arms "pair" and "dma"
(`pb_llm_tpu_torch.ops.decode_arms`) against the JAX package's Pallas
kernels run in interpret mode, and their gates in `ops.binary_matmul`.
The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda_kernels.py, chip_smoke.py).

Tolerances, of max|y|: pair rounds x and xg to bf16 on both sides in the
same way (round to nearest even), the products are exact in f32, so only
the f32 summation order differs: 1e-5.  dma is the exact f32 arm on both
sides, summed in other orders: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.core import pbw as jpbw
from pb_llm_tpu.ops import pallas_pb
from pb_llm_tpu.quant.high_quant import high_calibrate, high_quantize
from pb_llm_tpu.quant.low_quant import low_calibrate, low_quantize
from pb_llm_tpu_torch.interop import packed_from_fields
from pb_llm_tpu_torch.ops import binary_matmul, decode_arms, packed_matmul, prefill
from pb_llm_tpu_torch.ops.kernel_config import KernelConfig, use_kernels

torch.set_num_threads(2)

REL = 1e-5


def _make_v2(oc, ic, col_tile=0, high_bits=8, low_frac=0.9, seed=0, method="xnor",
             ic_shards=1, pack_block=None, k_multiple=32):
    """`tests/test_pbw_v2.py::_make_v2` (bias on) and `_make_v2_sharded`:
    a JAX-packed layer → (JAX layer, port layer)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((oc, ic)).astype(np.float32)
    if ic_shards == 1:
        w *= (1.0 + 3.0 * (rng.random(ic) < 0.1))[None, :]
    mask = np.asarray(jpbw.column_structured_mask(jnp.abs(jnp.asarray(w)), low_frac, col_tile,
                                                  ic_shards=ic_shards))
    low = low_calibrate(jnp.asarray(w * mask), method, -1)
    high = high_calibrate(jnp.asarray(w), bits=high_bits)
    w_q = np.where(mask, np.asarray(low_quantize(jnp.asarray(w), low, method, -1)),
                   np.asarray(high_quantize(jnp.asarray(w), high)))
    b = jnp.asarray(rng.standard_normal(oc).astype(np.float32))
    jp, _ = jpbw.pack_linear_v2(jnp.asarray(w_q), jnp.asarray(mask), low, high, method,
                                col_tile=col_tile, bias=b, ic_shards=ic_shards,
                                pack_block=pack_block, k_multiple=k_multiple)
    return jp, packed_from_fields(jp)


def _fused(oc=128, ic=256):
    """A 3-group layer: three same-shape parts merged by the JAX package."""
    parts = [_make_v2(oc, ic, seed=s)[0] for s in (3, 4, 5)]
    jp = jpbw.merge_packed_linears_v2(parts)
    return jp, packed_from_fields(jp)


LAYERS = {  # test_pbw_v2.py:396-397, its sharded layer, a fused layer
    "256x128": lambda: _make_v2(256, 128),
    "256x256_ct64": lambda: _make_v2(256, 256, col_tile=64),
    "128x416_side4": lambda: _make_v2(128, 416, high_bits=4),
    "sharded4": lambda: _make_v2(256, 256, ic_shards=4, pack_block=64, k_multiple=8, seed=21),
    "fused3": _fused,
}


def _x(m, ic, seed=11):
    return np.random.default_rng(seed).standard_normal((m, ic)).astype(np.float32)


def _jax(x, jp, **kw):
    with jax.default_matmul_precision("float32"):
        return np.asarray(pallas_pb.pb_matmul_pallas_v2(jnp.asarray(x), jp, interpret=True, **kw))


def _close(got, want):
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), err


@pytest.mark.parametrize("name", sorted(LAYERS))
@pytest.mark.parametrize("m", [4, 100])
def test_pair_plain_matches_jax_pair_kernel(name, m):
    jp, tp = LAYERS[name]()
    x = _x(m, jp.ic)
    _close(decode_arms.pb_pair_v2(torch.from_numpy(x), tp).numpy(),
           _jax(x, jp, oc_tile=128, decode_dot="pair"))


@pytest.mark.parametrize("name", ["256x128", "128x416_side4", "sharded4"])
@pytest.mark.parametrize("m", [4, 100])
def test_dma_plain_matches_jax_dma_kernel(name, m):
    jp, tp = LAYERS[name]()
    x = _x(m, jp.ic, seed=12)
    _close(decode_arms.pb_dma_v2(torch.from_numpy(x), tp).numpy(), _jax(x, jp, decode_dot="dma"))


def test_pair_permute_matches_jax():
    x = np.arange(2 * 416, dtype=np.float32).reshape(2, 416)
    for pack_block in (32, 128, 416):
        want = np.asarray(pallas_pb.pair_permute_x(jnp.asarray(x), 416, pack_block))
        got = decode_arms.pair_permute_x(torch.from_numpy(x), 416, pack_block).numpy()
        np.testing.assert_array_equal(got, want)


def test_dma_x_layout_holds_each_words_rows():
    """xt[t, w, b, r] = x[8t + r, row of bit b of word w], zero past m and
    past ic (pack blocks of 128 and a short tail block)."""
    ic, pack_block, m = 416, 128, 11
    x = torch.arange(m * ic, dtype=torch.float32).reshape(m, ic) + 1
    xt = decode_arms.dma_x_layout(x, ic, pack_block)
    assert xt.shape == (2, 16, 32, 8)
    w_off = r_off = 0
    for rows in (128, 128, 128, 32):
        g = rows // 32
        for gi in range(g):
            for b in range(32):
                col = x[:, r_off + b * g + gi]
                got = torch.cat([xt[0, w_off + gi, b], xt[1, w_off + gi, b]])
                assert torch.equal(got[:m], col) and not got[m:].any()
        w_off += g
        r_off += rows
    assert not xt[:, 13:].any()


class _Count:
    """Counts calls of a plain version, then runs it."""

    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *a, **kw):
        self.n += 1
        return self.fn(*a, **kw)


@pytest.fixture
def counted(monkeypatch):
    c = {"pair": _Count(decode_arms.pb_pair_v2_plain), "dma": _Count(decode_arms.pb_dma_v2_plain)}
    monkeypatch.setattr(decode_arms, "pb_pair_v2_plain", c["pair"])
    monkeypatch.setattr(decode_arms, "pb_dma_v2_plain", c["dma"])
    return c


def _lowbit(bits):
    rng = np.random.default_rng(21)
    oc, ic = 128, 128
    w = rng.standard_normal((oc, ic)).astype(np.float32)
    mask = np.ones((oc, ic), bool)
    mask[:, np.sort(np.argsort(-np.abs(w).sum(0))[:12])] = False
    method = f"{bits}bit"
    low, high = low_calibrate(jnp.asarray(w * mask), method), high_calibrate(jnp.asarray(w), bits=8)
    w_q = np.where(mask, np.asarray(low_quantize(jnp.asarray(w), low, method)),
                   np.asarray(high_quantize(jnp.asarray(w), high)))
    jp, _ = jpbw.pack_linear_v2(jnp.asarray(w_q), jnp.asarray(mask), low, high, method,
                                pack_block=64)
    return jp, packed_from_fields(jp)


@pytest.mark.parametrize("arm,layer,m,taken", [
    ("dma", "256x128", 4, "dma"),
    ("dma", "256x256_ct64", 4, "f32"),     # row groups: the f32 kernel
    ("dma", "low2", 4, "f32"),             # 2-bit lows: the f32 kernel
    ("dma", "256x128", 257, "prefill"),    # m >= 256: the prefill arm
    ("pair", "fused3", 4, "pair"),
    ("pair", "low2", 4, "f32"),            # 2-bit lows: the f32 kernel
    ("pair", "256x128", 257, "prefill"),
])
def test_decode_arm_gates_follow_jax(counted, arm, layer, m, taken):
    """`pb_matmul` takes an arm exactly where JAX's gates
    (pallas_pb.py:1263-1275) do, and agrees with JAX's dispatch there."""
    jp, tp = _lowbit(2) if layer == "low2" else LAYERS[layer]()
    x = _x(m, jp.ic, seed=13)
    kw = dict(decode_dot=arm, prefill="hybrid")
    with use_kernels(KernelConfig(backend="pallas_interpret", **kw)):
        got = binary_matmul.pb_matmul(torch.from_numpy(x), tp).numpy()
    assert (counted["pair"].n, counted["dma"].n) == ((taken == "pair") * 1, (taken == "dma") * 1)
    want = {"pair": decode_arms.pb_pair_v2_plain, "dma": decode_arms.pb_dma_v2_plain,
            "f32": packed_matmul.pb_f32_matmul_plain,
            "prefill": lambda x, p: prefill.v2_prefill(x, p, plain=True)}[taken]
    np.testing.assert_array_equal(got, want(torch.from_numpy(x), tp).numpy())
    from pb_llm_tpu.ops import binary_matmul as jbm
    from pb_llm_tpu.ops import kernel_config as jkc

    with jkc.use_kernels(jkc.KernelConfig(backend="pallas_interpret", **kw)), \
            jax.default_matmul_precision("float32"):
        ref = np.asarray(jbm.pb_matmul(jnp.asarray(x), jp))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_wrappers_on_the_cpu_count_no_launch():
    _, tp = LAYERS["256x128"]()
    before = (decode_arms.pair_launches, decode_arms.dma_launches)
    decode_arms.pb_pair_v2(torch.zeros((2, 128)), tp)
    decode_arms.pb_dma_v2(torch.zeros((2, 128)), tp)
    assert (decode_arms.pair_launches, decode_arms.dma_launches) == before
