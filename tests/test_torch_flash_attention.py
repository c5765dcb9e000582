"""Port parity: flash attention (`pb_llm_tpu_torch.ops.flash_attention`) and
the no-cache dispatch `models.attention.full_causal_attention` against the
JAX package's Pallas flash kernel in interpret mode.  The CUDA kernel is
held against the plain version on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).  Tolerance: atol/rtol 1e-4, the bound of
tests/test_flash_attention.py; the residual max m to 1e-5 as there.  With
``dots_bf16`` the softmax weights round to bf16 relative to a running max
that depends on the key tiling, so two tilings agree to bf16 precision
(2^-8 relative): atol/rtol 1e-2.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.models import attention as jattn
from pb_llm_tpu.ops import kernel_config as jkc
from pb_llm_tpu.ops.flash_attention import flash_attention as jflash
from pb_llm_tpu_torch.models import attention as tattn
from pb_llm_tpu_torch.ops import flash_attention as tfa
from pb_llm_tpu_torch.ops import kernel_config as tkc

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)
TOL_BF16 = dict(atol=1e-2, rtol=1e-2)


def _qkv(b, t, h, d, seed=0, s=None, hkv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    kv = [rng.standard_normal((b, s or t, hkv or h, d)).astype(np.float32) for _ in range(2)]
    return q, kv[0], kv[1]


@pytest.mark.parametrize("dots_bf16", [False, True])
@pytest.mark.parametrize("b,t,h,d,bq,bk,causal", [
    (1, 128, 2, 32, 64, 64, True),     # several tiles
    (2, 100, 2, 16, 64, 64, True),     # T not a multiple of the tile
    (1, 256, 1, 64, 128, 64, True),    # uneven q/k tiles
    (1, 64, 2, 16, 64, 64, False),     # non-causal
    (2, 90, 3, 32, 64, 64, False),     # non-causal, ragged
])
def test_flash_plain_matches_jax_kernel(b, t, h, d, bq, bk, causal, dots_bf16):
    q, k, v = _qkv(b, t, h, d, seed=t + h)
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal=causal,
                             block_q=bq, block_k=bk, dots_bf16=dots_bf16, interpret=True))
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale,
                              causal=causal, dots_bf16=dots_bf16)
    np.testing.assert_allclose(got.numpy(), want, **(TOL_BF16 if dots_bf16 else TOL))


def test_flash_residuals_match_jax_kernel():
    q, k, v = _qkv(1, 96, 2, 32, seed=3)
    scale = 1.0 / np.sqrt(32)
    out, m, l = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal=True,
                       block_q=64, block_k=64, interpret=True, return_residuals=True)
    t_out, t_m, t_l = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), scale, return_residuals=True)
    assert t_m.shape == (1, 96, 2) and t_l.shape == (1, 96, 2)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(t_m.numpy(), np.asarray(m), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_l.numpy(), np.asarray(l), **TOL)


def test_kv_len_masks_like_a_shorter_key_set():
    q, k, v = _qkv(2, 40, 2, 16, seed=5, s=64)
    T = torch.from_numpy
    got = tfa.flash_attention(T(q), T(k), T(v), 0.25, causal=False, kv_len=50)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k[:, :50]), jnp.asarray(v[:, :50]), 0.25,
                             causal=False, block_q=64, block_k=64, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_row_with_no_allowed_key_is_zero_not_nan():
    q, k, v = _qkv(1, 8, 2, 16, seed=6)
    T = torch.from_numpy
    out, m, l = tfa.flash_attention(T(q), T(k), T(v), 0.25, kv_len=0, return_residuals=True)
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.all(l == 0) and torch.all(m == tfa.NEG_INF)


def test_cpu_wrapper_takes_the_plain_version_uncounted():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 1, 8, seed=7))
    before = tfa.launches
    torch.testing.assert_close(tfa.flash_attention(q, k, v, 0.3), tfa.flash_attention_plain(q, k, v, 0.3),
                               rtol=0, atol=0)
    assert tfa.launches == before


@pytest.mark.parametrize("hkv", [4, 2, 1])
@pytest.mark.parametrize("impl", ["flash_interpret", "xla", "auto"])
def test_full_causal_attention_matches_jax(impl, hkv):
    """The dispatch with GQA heads: every arm equals the JAX flash kernel
    (interpret) on the same inputs; on a CPU tensor "auto" takes the masked
    softmax, as JAX does on the CPU."""
    q, k, v = _qkv(2, 72, 4, 32, seed=hkv, hkv=hkv)
    scale = 1.0 / np.sqrt(32)
    with jkc.use_kernels(jkc.KernelConfig(attention="flash_interpret")):
        want = np.asarray(jattn.full_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                      scale))
    with tkc.use_kernels(tkc.KernelConfig(attention=impl)):
        got = tattn.full_causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), scale)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_window_keeps_the_masked_path():
    q, k, v = _qkv(1, 48, 2, 16, seed=8)
    T = torch.from_numpy
    with tkc.use_kernels(tkc.KernelConfig(attention="flash_interpret")):
        got = tattn.full_causal_attention(T(q), T(k), T(v), 0.25, window=8)
    want = np.asarray(jattn.masked_softmax_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jattn.causal_allowed(0, 48, 48, None, 8), 0.25))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_auto_picks_flash_only_on_the_card_for_long_windows():
    assert not tattn._flash_eligible(torch.zeros((1, 2048, 2, 128)))  # CPU tensor
    assert not tattn._flash_eligible(torch.zeros((1, 2048, 2, 128), device="meta"))


@pytest.mark.parametrize("t", [512, 1024, 2048])
@pytest.mark.parametrize("d", [64, 100, 128, 256])
def test_auto_rule_on_the_card_is_the_jax_rule(t, d, monkeypatch):
    """On a CUDA tensor "auto" decides as the JAX package does on its chip,
    with no rule of its own (a head dim the kernel cannot take raises from
    the kernel's wrapper rather than taking the masked softmax)."""
    monkeypatch.setattr(jattn.jax, "default_backend", lambda: "tpu")
    q = types.SimpleNamespace(shape=(1, t, 2, d), device=torch.device("cuda"))
    assert tattn._flash_eligible(q) == jattn._flash_eligible(t, d)
