"""Port parity: strip-cache decode attention (`pb_llm_tpu_torch.ops.
decode_attention`) against the JAX Pallas kernel in interpret mode, and the
port's strip cache write / cached attention against `pb_llm_tpu.models.
attention`.  Tolerances are those of tests/test_decode_attention.py: atol
5e-6 on f32 caches, 2e-2 on int8 caches (the TPU kernel rounds q and p to
bf16 there; the port stays in f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.models import attention as jattn
from pb_llm_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from pb_llm_tpu_torch.models import attention as tattn
from pb_llm_tpu_torch.ops import decode_attention as tda

torch.set_num_threads(2)


def _mk(B, S, Hq, Hkv, D, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, Hq, D)).astype(np.float32)
    k = r.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = r.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return q, k, v


def _quant(x):
    sc = np.maximum(np.abs(x).max(-1, keepdims=True) / 127.0, 1e-8).astype(np.float32)
    return np.clip(np.round(x / sc), -127, 127).astype(np.int8), sc


T = torch.from_numpy


@pytest.mark.parametrize("Hq,Hkv", [(8, 8), (8, 2)])
def test_f32_cache_matches_jax_kernel(Hq, Hkv):
    B, S, D = 4, 128, 64
    q, k, v = _mk(B, S, Hq, Hkv, D)
    lengths = np.array([1 + (37 * i) % S for i in range(B)], np.int32)
    want = np.asarray(jax_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(lengths), 1.0 / np.sqrt(D),
                                           block_s=32, interpret=True))
    got = tda.decode_attention(T(q), T(k), T(v), T(lengths), 1.0 / np.sqrt(D)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-6)


@pytest.mark.parametrize("Hq,Hkv", [(8, 4), (8, 1)])
def test_int8_cache_matches_jax_kernel(Hq, Hkv):
    B, S, D = 4, 128, 64
    q, k, v = _mk(B, S, Hq, Hkv, D, seed=1)
    (ki, ks), (vi, vs) = _quant(k), _quant(v)
    lengths = np.array([1, 128, 65, 32], np.int32)
    want = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(ki), jnp.asarray(vi), jnp.asarray(lengths), 0.125,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), block_s=32, interpret=True))
    got = tda.decode_attention(T(q), T(ki), T(vi), T(lengths), 0.125,
                               k_scale=T(ks), v_scale=T(vs)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-2)


def test_empty_slots_and_partial_windows():
    """Length-0 slots return zeros (as the TPU kernel's l == 0 guard does);
    rows past a slot's length are never used, even when they hold NaN."""
    B, S, Hq, D = 3, 256, 4, 32
    q, k, v = _mk(B, S, Hq, Hq, D, seed=2)
    lengths = np.array([0, 77, 128], np.int32)
    k[:, 128:] = np.nan
    v[:, 128:] = np.nan
    want = np.asarray(jax_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(lengths), 0.2, s_used=128,
                                           block_s=64, interpret=True))
    got = tda.decode_attention(T(q), T(k), T(v), T(lengths), 0.2).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_allclose(got, want, atol=5e-6)


def test_q_int8_arm_not_ported():
    """q_int8 over int8 strips runs the q8 arm now (it no longer raises) and
    agrees with JAX's q8 kernel on this small input, at JAX's q8 bound
    (tests/test_torch_kv_arms.py holds the arm at the JAX tests' shapes)."""
    q, k, v = _mk(1, 8, 2, 2, 32)
    ki, ks = _quant(k)
    lengths = np.array([3], np.int32)
    got = tda.decode_attention(T(q), T(ki), T(ki), T(lengths), 0.1,
                               k_scale=T(ks), v_scale=T(ks), q_int8=True).numpy()
    want = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(ki), jnp.asarray(ki), jnp.asarray(lengths), 0.1,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(ks), q_int8=True, interpret=True))
    np.testing.assert_allclose(got, want, atol=5e-2)


@pytest.mark.parametrize("quantized", [False, True])
def test_cache_update_matches_jax(quantized):
    """The strip write, scalar (prefill) and vector (decode) positions; the
    int8 write is exact: scale = max(absmax/127, 1e-8), half-to-even."""
    B, S, H, D = 3, 16, 2, 32
    r = np.random.default_rng(4)
    kv = [r.standard_normal((B, 5, H, D)).astype(np.float32) for _ in range(2)]
    kv[0][0, 0] = np.array([0.5, 1.5] + [0.0] * (D - 2), np.float32) * (127 / 1.5)  # ties
    dt = np.int8 if quantized else np.float32

    def empty():
        c = {"k": np.zeros((B, S, H, D), dt), "v": np.zeros((B, S, H, D), dt)}
        if quantized:
            c["k_scale"] = np.zeros((B, S, H, 1), np.float32)
            c["v_scale"] = np.zeros((B, S, H, 1), np.float32)
        return c

    for pos, t in ((2, 5), (np.array([0, 7, 3], np.int32), 1)):
        jc = jattn.cache_update({k_: jnp.asarray(a) for k_, a in empty().items()},
                                jnp.asarray(kv[0][:, :t]), jnp.asarray(kv[1][:, :t]),
                                pos if isinstance(pos, int) else jnp.asarray(pos))
        tc = tattn.cache_update({k_: T(a) for k_, a in empty().items()},
                                T(kv[0][:, :t]), T(kv[1][:, :t]),
                                pos if isinstance(pos, int) else T(pos))
        for name in jc:
            np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]), err_msg=name)


@pytest.mark.parametrize("window", [None, 3])
def test_cached_attention_xla_path_matches_jax(window):
    """Masked-softmax path over the strip cache (prefill at scalar pos and
    decode at vector pos, with and without a sliding window)."""
    B, S, Hq, Hkv, D = 2, 24, 4, 2, 16
    r = np.random.default_rng(5)
    cache = {"k": r.standard_normal((B, S, Hkv, D)).astype(np.float32),
             "v": r.standard_normal((B, S, Hkv, D)).astype(np.float32)}
    for pos, t in ((0, 6), (np.array([5, 11], np.int32), 1)):
        q = r.standard_normal((B, t, Hq, D)).astype(np.float32)
        jp = pos if isinstance(pos, int) else jnp.asarray(pos)
        want = np.asarray(jattn.cached_attention({k: jnp.asarray(a) for k, a in cache.items()},
                                                 jnp.asarray(q), None, None, jp, 0.25, window=window))
        tp = pos if isinstance(pos, int) else T(pos)
        got = tattn.cached_attention({k: T(a) for k, a in cache.items()}, T(q), None, None, tp,
                                     0.25, window=window).numpy()
        np.testing.assert_allclose(got, want, atol=5e-6)


def test_kernel_counter_counts_only_launches():
    q, k, v = _mk(1, 8, 2, 2, 32)
    before = tda.launches
    tda.decode_attention(T(q), T(k), T(v), T(np.array([3], np.int32)), 0.1)
    assert tda.launches == before

