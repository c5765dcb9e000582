"""Port parity: the bf16 and q8 arms of the attention kernels, and bf16 KV
caches end to end, against the JAX package.

  * decode attention over bf16 strips and the q8 arm (int8 q codes against
    int8 strips) against JAX's `decode_attention(..., interpret=True)`, at
    tests/test_decode_attention.py's shapes and bounds: 2e-2 on bf16 (the
    TPU kernel rounds q to bf16; the port keeps f32) and 5e-2 on q8 (q's
    extra int8 rounding, and the TPU kernel rounds p to bf16).  The q8
    codes and scales equal JAX's bit for bit;
  * paged attention over bf16 pages (decode, verify windows, GQA) against
    JAX's kernels in interpret mode, at tests/test_paged.py's bound 2e-5
    (both sides widen the bf16 keys and sum in f32);
  * the `pallas_q8` dispatch rule of `models.attention.cached_attention`;
  * the 2-layer engine over bf16 strips and bf16 pages (prefill, chunked
    prefill, prefix cache, speculative verify, preemption, scan_layers)
    against JAX's engine on ``cache_dtype=jnp.bfloat16``: equal greedy
    streams but for near ties, where at the first differing token JAX's
    two highest logits lie within MARGIN = 1e-4 of max|logit|
    (chip_smoke.py's rule).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving import TinyLlama, random_prompts, serve
from pb_llm_tpu.models import attention as jattn
from pb_llm_tpu.ops import kernel_config as jkc
from pb_llm_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from pb_llm_tpu.ops.paged_attention import (paged_attention as jax_paged_attention,
                                            paged_attention_multi as jax_paged_attention_multi)
from pb_llm_tpu_torch.models import attention as tattn
from pb_llm_tpu_torch.ops import decode_attention as tda
from pb_llm_tpu_torch.ops import kernel_config as tkc
from pb_llm_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(2)

T = torch.from_numpy
MARGIN = 1e-4


def _bf16(x):
    """x rounded to bf16 once (by JAX), as (JAX array, torch tensor)."""
    j = jnp.asarray(x).astype(jnp.bfloat16)
    return j, T(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _quant(x):
    sc = np.maximum(np.abs(x).max(-1, keepdims=True) / 127.0, 1e-8).astype(np.float32)
    return np.clip(np.round(x / sc), -127, 127).astype(np.int8), sc


def _mk(B, S, Hq, Hkv, D, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, Hq, D)).astype(np.float32),
            r.standard_normal((B, S, Hkv, D)).astype(np.float32),
            r.standard_normal((B, S, Hkv, D)).astype(np.float32))


# ---------------------------------------------------------------------------
# decode attention: bf16 strips and the q8 arm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,Hq,Hkv,D,lengths", [
    (3, 96, 4, 4, 128, (5, 96, 33)),    # tests/test_decode_attention.py's bf16 case
    (4, 128, 8, 2, 64, (0, 1, 65, 128)),
])
def test_bf16_strips_match_jax_kernel(B, S, Hq, Hkv, D, lengths):
    q, k, v = _mk(B, S, Hq, Hkv, D, seed=Hkv)
    (jk, tk), (jv, tv) = _bf16(k), _bf16(v)
    lens = np.array(lengths, np.int32)
    want = np.asarray(jax_decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(lens), 0.1,
                                           block_s=32, interpret=True))
    before = tda.launches
    got = tda.decode_attention(T(q), tk, tv, T(lens), 0.1).numpy()
    assert tda.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(got, want, atol=2e-2)
    # the plain version is f32 over the widened cache: the f32 arm on it
    np.testing.assert_array_equal(
        got, tda.decode_attention(T(q), tk.float(), tv.float(), T(lens), 0.1).numpy())


@pytest.mark.parametrize("Hq,Hkv", [(8, 4), (8, 1)])
@pytest.mark.parametrize("block_b", [1, 2])
def test_q8_arm_matches_jax_kernel(Hq, Hkv, block_b):
    """tests/test_decode_attention.py::test_kernel_q_int8_matches_dequant_oracle's
    shapes, JAX's kernel on the same int8 strips."""
    B, S, D = 4, 128, 64
    q, k, v = _mk(B, S, Hq, Hkv, D, seed=Hq + Hkv)
    (ki, ks), (vi, vs) = _quant(k), _quant(v)
    lens = np.array([1, 128, 65, 32], np.int32)
    want = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(ki), jnp.asarray(vi), jnp.asarray(lens), 0.125,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), block_s=32, block_b=block_b,
        q_int8=True, interpret=True))
    got = tda.decode_attention(T(q), T(ki), T(vi), T(lens), 0.125, k_scale=T(ks),
                               v_scale=T(vs), q_int8=True).numpy()
    np.testing.assert_allclose(got, want, atol=5e-2)
    plain8 = tda.decode_attention(T(q), T(ki), T(vi), T(lens), 0.125, k_scale=T(ks),
                                  v_scale=T(vs)).numpy()
    assert not np.array_equal(got, plain8)  # q's codes did change the scores


def _jax_q_codes(q):
    """JAX's q8 quantization, pb_llm_tpu/ops/decode_attention.py:218-220."""
    qsc = jnp.maximum(jnp.max(jnp.abs(q), axis=-1), 1e-30) / 127.0
    return jnp.clip(jnp.round(q / qsc[..., None]), -127, 127).astype(jnp.int8), qsc


@pytest.mark.parametrize("case", ["random", "ties", "tiny", "zeros"])
def test_q8_codes_and_scales_equal_jax_bit_for_bit(case):
    r = np.random.default_rng(3)
    q = r.standard_normal((3, 8, 64)).astype(np.float32) * np.float32(0.125)
    if case == "ties":  # qsc = 1: codes at exact halves round to even
        q = np.round(r.uniform(-126, 126, (3, 8, 64))).astype(np.float32) + 0.5
        q[..., 0] = 127.0
    elif case == "tiny":  # below the 1e-30 floor
        q = (q * np.float32(1e-35)).astype(np.float32)
    elif case == "zeros":
        q[1] = 0.0
    jc, js = _jax_q_codes(jnp.asarray(q))
    tc, ts = tda.quantize_q(T(q))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if case == "ties":
        assert set(np.unique(np.abs(tc.numpy()) % 2)) == {0, 1}


def test_q8_scores_are_the_exact_dots_of_the_codes():
    """At unit scales with max|q| = 127 (qsc = 1) the plain q8 arm's scores
    are the integer dots of q and K: one key per slot gets weight 1."""
    r = np.random.default_rng(4)
    B, S, H, D = 2, 16, 2, 32
    q = r.integers(-5, 6, (B, H, D)).astype(np.float32)  # |q·k| <= 5·3·15 off dim 0
    q[..., 0] = 127.0
    k = r.integers(-3, 4, (B, S, H, D)).astype(np.int8)
    k[..., 0] = 0
    k[..., 16:] = 0
    k[:, 7, :, 0] = 2  # key 7 leads every other by >= 254 - 2·75: the rest weigh exactly 0
    v = r.integers(-127, 128, (B, S, H, D)).astype(np.int8)
    ones = np.ones((B, S, H, 1), np.float32)
    lens = np.full(B, S, np.int32)
    got = tda.decode_attention(T(q), T(k), T(v), T(lens), 1.0, k_scale=T(ones),
                               v_scale=T(ones), q_int8=True).numpy()
    np.testing.assert_array_equal(got, v[:, 7].astype(np.float32))


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
def test_pallas_q8_dispatch_follows_jax(cache):
    """tests/test_decode_attention.py::test_cached_attention_pallas_q8_requires_int8_cache's
    contract: "pallas_q8" quantizes q only over an int8 cache (k_scale
    present); over f32 or bf16 strips it is the plain kernel.  Both stay
    within JAX's bounds of JAX's XLA reference."""
    B, S, H, D = 4, 128, 4, 64
    r = np.random.default_rng(9)
    q, k_new, v_new = (r.standard_normal((B, 1, H, D)).astype(np.float32) for _ in range(3))
    fill = (r.standard_normal((B, S, H, D)) * 0.5).astype(np.float32)
    pos = np.array([0, 17, 100, 127], np.int32)
    empty = {"k": np.zeros((B, S, H, D), np.int8 if cache == "int8" else np.float32)}
    empty["v"] = empty["k"]
    if cache == "int8":
        empty["k_scale"] = empty["v_scale"] = np.zeros((B, S, H, 1), np.float32)
    jc = {n: jnp.asarray(a) for n, a in empty.items()}
    tc = {n: T(a.copy()) for n, a in empty.items()}
    if cache == "bf16":
        jc = {n: a.astype(jnp.bfloat16) for n, a in jc.items()}
        tc = {n: a.to(torch.bfloat16) for n, a in tc.items()}

    jc = jattn.cache_update(jc, jnp.asarray(fill), jnp.asarray(fill), 0)
    jc = jattn.cache_update(jc, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pos))
    tc = tattn.cache_update(tc, T(fill), T(fill), 0)
    tc = tattn.cache_update(tc, T(k_new), T(v_new), T(pos))
    for name in jc:
        np.testing.assert_array_equal(tc[name].float().numpy(),
                                      np.asarray(jc[name].astype(jnp.float32)), err_msg=name)
    with jkc.use_kernels(jkc.KernelConfig(decode_attention="xla")):
        ref = np.asarray(jattn.cached_attention(jc, jnp.asarray(q), None, None,
                                                jnp.asarray(pos), 0.125))
    outs = {}
    for impl in ("pallas_q8", "pallas_interpret"):
        with tkc.use_kernels(tkc.KernelConfig(decode_attention=impl)):
            outs[impl] = tattn.cached_attention(tc, T(q), None, None, T(pos), 0.125).numpy()
    q8 = cache == "int8"
    np.testing.assert_allclose(outs["pallas_q8"], ref, atol=5e-2 if q8 else 5e-6)
    assert np.array_equal(outs["pallas_q8"], outs["pallas_interpret"]) != q8
    if q8:  # the q8 arm proper: the wrapper's plain version with q codes
        want = tda.decode_attention_plain(T(q[:, 0]), tc["k"], tc["v"], T(pos + 1), 0.125,
                                          k_scale=tc["k_scale"], v_scale=tc["v_scale"],
                                          q_int8=True).numpy()
        np.testing.assert_array_equal(outs["pallas_q8"][:, 0], want)


# ---------------------------------------------------------------------------
# paged attention over bf16 pages
# ---------------------------------------------------------------------------

TOL = dict(rtol=2e-5, atol=2e-5)


def _bf16_pool(P, Hkv, PS, D, seed):
    r = np.random.default_rng(seed)
    return [_bf16(r.standard_normal((P, Hkv, PS, D)).astype(np.float32)) for _ in range(2)]


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 4), (8, 2)])
def test_bf16_paged_decode_matches_jax_kernel(Hq, Hkv):
    B, D, PS, MAXP, P = 4, 32, 8, 4, 20
    r = np.random.default_rng(Hq * Hkv)
    q = r.standard_normal((B, Hq, D)).astype(np.float32)
    (jk, tk), (jv, tv) = _bf16_pool(P, Hkv, PS, D, seed=Hkv)
    table = r.integers(0, P, size=(B, MAXP)).astype(np.int32)
    lengths = np.array([0, 1, 13, MAXP * PS], np.int32)
    want = np.asarray(jax_paged_attention(jnp.asarray(q), jk, jv, jnp.asarray(table),
                                          jnp.asarray(lengths), 0.3, PS, interpret=True))
    got = tpa.paged_attention(T(q), tk, tv, T(table), T(lengths), 0.3, PS).numpy()
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("t", [1, 5, 16])
def test_bf16_paged_windows_match_jax_kernel(t):
    """Verify (t = 5) and chunk-like windows crossing pages, GQA 4:1."""
    B, Hq, Hkv, D, PS, MAXP, P = 3, 8, 2, 32, 8, 6, 24
    r = np.random.default_rng(t + 1)
    q = r.standard_normal((B, t, Hq, D)).astype(np.float32)
    (jk, tk), (jv, tv) = _bf16_pool(P, Hkv, PS, D, seed=t)
    table = r.integers(0, P, size=(B, MAXP)).astype(np.int32)
    base = np.array([6, 13, 0], np.int32)
    want = np.asarray(jax_paged_attention_multi(jnp.asarray(q), jk, jv, jnp.asarray(table),
                                                jnp.asarray(base), 0.25, PS, interpret=True))
    got = tpa.paged_attention_multi(T(q), tk, tv, T(table), T(base), 0.25, PS).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_bf16_pages_refuse_scale_planes():
    """JAX's rule: int8 pages iff scale pages."""
    (_, tk), (_, tv) = _bf16_pool(4, 2, 8, 32, seed=0)
    sc = torch.ones((4, 2, 8))
    with pytest.raises(ValueError, match="int8 pages require"):
        tpa.paged_attention(torch.zeros((1, 2, 32)), tk, tv, torch.zeros((1, 2), dtype=torch.int32),
                            torch.tensor([3]), 0.1, 8, sc, sc)


# ---------------------------------------------------------------------------
# bf16 KV caches through the engine
# ---------------------------------------------------------------------------

STRIPS = dict(n_slots=2, max_seq=64, prefill_buckets=(16, 32))
PAGES = dict(STRIPS, page_size=8)
ENGINES = {
    "strips": STRIPS,
    "strips_chunked_spec": dict(STRIPS, prefill_chunk=16, spec_gamma=3),
    "strips_scan_layers": dict(STRIPS, scan_layers=True),
    "pages_prefix_chunked": dict(PAGES, prefix_cache=True, prefill_chunk=16),
    "pages_spec": dict(PAGES, spec_gamma=3),
    "pages_preempting_scan": dict(PAGES, n_pages=5, scan_layers=True),
}


@pytest.fixture(scope="module")
def model():
    return TinyLlama(kv_heads=2)


def _prompts(kw):
    """Two prompts sharing two pages of 8 (a prefix hit), two others; short
    ones for a pool small enough to preempt (tests/test_torch_paged.py's)."""
    rest = random_prompts(1 if kw.get("n_pages") else 5, [5, 12, 9, 14])
    if kw.get("n_pages"):
        return rest
    shared = [9, 4, 61, 20, 33, 8, 90, 41, 2, 77, 15, 63, 5, 19, 28, 100]
    return [shared + rest[0], rest[1], shared + rest[2], rest[3] + rest[1][:10]]


def _hold_streams(model, prompts, want, got):
    """got == want (JAX's run) request by request, but for near ties: at the
    first differing token JAX's two highest logits, re-scored by a one-shot
    prefill of the prefix over bf16 strips, lie within MARGIN of
    max|logit|.  Returns the number of near ties."""
    ties = 0
    for p, w, g in zip(prompts, want, got):
        if w == g:
            continue
        k = next(j for j, (a, b) in enumerate(zip(w, g)) if a != b)
        ref = model.jax_engine(cache_dtype="bf16", n_slots=1, max_seq=128,
                               prefill_buckets=(64,))
        ref.prefill(0, list(p) + w[:k])
        logits = np.asarray(ref._prefill_logits[0], np.float32)
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] <= MARGIN * np.abs(logits).max(), (p, w, g, k)
        ties += 1
    return ties


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_bf16_engine_streams_match_jax_engine(model, name):
    kw = ENGINES[name]
    prompts = _prompts(kw)
    want, jb = serve(model.jax_engine(cache_dtype="bf16", **kw), prompts, 12)
    eng = model.port_engine(cache_dtype="bf16", **kw)
    got, tb = serve(eng, prompts, 12)
    caches = eng.caches if isinstance(eng.caches, dict) else eng.caches[0]
    assert caches["k_pages" if "page_size" in kw else "k"].dtype == torch.bfloat16
    assert _hold_streams(model, prompts, want, got) <= 1
    if kw.get("n_pages"):
        assert tb.stats.preemptions >= 1 and tb.stats.preemptions == jb.stats.preemptions
    if kw.get("prefix_cache"):
        assert eng.pool.prefix_hit_pages == jb.engine.pool.prefix_hit_pages > 0


def test_bf16_prefill_logits_match_jax_engine(model):
    """The prefill logits of one prompt over bf16 strips and bf16 pages
    (1e-4, tests/test_torch_paged.py's bound), and the written cache rows
    bit for bit."""
    prompt = _prompts(STRIPS)[0]
    for kw in (STRIPS, PAGES):
        js, ts = model.jax_engine(cache_dtype="bf16", **kw), model.port_engine(cache_dtype="bf16",
                                                                              **kw)
        js.prefill(0, prompt)
        ts.prefill(0, prompt)
        np.testing.assert_allclose(np.asarray(ts._prefill_logits[0]),
                                   np.asarray(js._prefill_logits[0]), rtol=1e-4, atol=1e-4)
        name = "k_pages" if "page_size" in kw else "k"
        jk = np.asarray(js.caches[0][name].astype(jnp.float32))
        tk = ts.caches[0][name].float().numpy()
        if name == "k":
            jk, tk = jk[0, : len(prompt)], tk[0, : len(prompt)]
        else:
            pages = ts.pool.table[0][: ts.pool.pages_needed(len(prompt))]
            jk, tk = jk[pages], tk[pages]
        np.testing.assert_allclose(tk, jk, rtol=1e-2, atol=1e-2)
        assert np.mean(tk == jk) > 0.99  # rounded from f32 K that differs in the last bits

