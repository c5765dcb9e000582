"""Port parity: paged attention (`pb_llm_tpu_torch.ops.paged_attention`)
against the JAX Pallas kernel in interpret mode, and the paged cache write
and read of `models.attention` against `pb_llm_tpu.models.attention`.

Tolerance: rtol = atol = 2e-5, the JAX package's own oracle bound
(tests/test_paged.py); both sides compute in f32, in other orders.  The
int8 page write is exact: the same absmax quantizer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.models import attention as jattn
from pb_llm_tpu.ops.paged_attention import (paged_attention as jax_paged_attention,
                                            paged_attention_multi as jax_paged_attention_multi)
from pb_llm_tpu_torch.models import attention as tattn
from pb_llm_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(2)

T = torch.from_numpy
TOL = dict(rtol=2e-5, atol=2e-5)


def _pool(P, Hkv, PS, D, quantized, seed):
    r = np.random.default_rng(seed)
    if quantized:
        kq, vq = (r.integers(-127, 128, size=(P, Hkv, PS, D)).astype(np.int8) for _ in range(2))
        ks, vs = (r.uniform(0.005, 0.02, size=(P, Hkv, PS)).astype(np.float32) for _ in range(2))
        return kq, vq, ks, vs
    kp, vp = (r.standard_normal((P, Hkv, PS, D)).astype(np.float32) for _ in range(2))
    return kp, vp, None, None


def _both(arrs):
    return ([None if a is None else jnp.asarray(a) for a in arrs],
            [None if a is None else T(a) for a in arrs])


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 4)])
def test_decode_matches_jax_kernel(quantized, Hq, Hkv):
    """Lengths 0 (an empty slot), 1, mid-page and the full table, through a
    random table."""
    B, D, PS, MAXP, P = 4, 32, 8, 4, 20
    r = np.random.default_rng(Hq + quantized)
    q = r.standard_normal((B, Hq, D)).astype(np.float32)
    kp, vp, ks, vs = _pool(P, Hkv, PS, D, quantized, seed=Hkv)
    table = r.integers(0, P, size=(B, MAXP)).astype(np.int32)
    lengths = np.array([0, 1, 13, MAXP * PS], np.int32)
    (jq, jk, jv, jks, jvs, jt, jl), (tq, tk, tv, tks, tvs, tt, tl) = _both(
        [q, kp, vp, ks, vs, table, lengths])
    want = np.asarray(jax_paged_attention(jq, jk, jv, jt, jl, 0.3, PS, k_scale_pages=jks,
                                          v_scale_pages=jvs, interpret=True))
    got = tpa.paged_attention(tq, tk, tv, tt, tl, 0.3, PS, k_scale_pages=tks,
                              v_scale_pages=tvs).numpy()
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("t", [1, 5, 16])
def test_multi_query_windows_match_jax_kernel(quantized, t):
    """Windows of t rows at bases that make them cross page boundaries,
    GQA 2:1."""
    B, Hq, Hkv, D, PS, MAXP, P = 3, 4, 2, 32, 8, 6, 24
    r = np.random.default_rng(t)
    q = r.standard_normal((B, t, Hq, D)).astype(np.float32)
    kp, vp, ks, vs = _pool(P, Hkv, PS, D, quantized, seed=t + 7)
    table = r.integers(0, P, size=(B, MAXP)).astype(np.int32)
    base = np.array([6, 13, 0], np.int32)
    (jq, jk, jv, jks, jvs, jt, jb), (tq, tk, tv, tks, tvs, tt, tb) = _both(
        [q, kp, vp, ks, vs, table, base])
    want = np.asarray(jax_paged_attention_multi(jq, jk, jv, jt, jb, 0.25, PS, k_scale_pages=jks,
                                                v_scale_pages=jvs, interpret=True))
    got = tpa.paged_attention_multi(tq, tk, tv, tt, tb, 0.25, PS, k_scale_pages=tks,
                                    v_scale_pages=tvs).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_wrapper_is_the_plain_version_and_counts_nothing():
    B, Hq, Hkv, D, PS, P = 2, 4, 2, 16, 4, 9
    kp, vp, ks, vs = (T(a) for a in _pool(P, Hkv, PS, D, True, seed=3))
    q = torch.randn(B, 3, Hq, D, generator=torch.Generator().manual_seed(0))
    table = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    base = torch.tensor([2, 7])
    before = (tpa.launches, tpa.decode_launches, tpa.multi_launches)
    got = tpa.paged_attention_multi(q, kp, vp, table, base, 0.5, PS, ks, vs)
    want = tpa.paged_attention_plain(q, kp, vp, table, base, 0.5, PS, ks, vs)
    assert torch.equal(got, want)
    assert (tpa.launches, tpa.decode_launches, tpa.multi_launches) == before


def test_unread_keys_never_reach_the_output():
    """Pages past each row's limit (the trash page, stale pages) may hold
    anything, NaN included: the plain version reads none of it."""
    B, Hq, Hkv, D, PS, P = 2, 2, 2, 16, 4, 6
    kp, vp, _, _ = (None if a is None else T(a) for a in _pool(P, Hkv, PS, D, False, seed=4))
    kp[5], vp[5] = float("nan"), float("nan")  # the trash page
    kp[1, :, 2:], vp[1, :, 2:] = float("nan"), float("nan")  # past slot 1's length
    table = torch.tensor([[0, 5, 5], [1, 5, 5]], dtype=torch.int32)
    q = torch.randn(B, Hq, D, generator=torch.Generator().manual_seed(1))
    out = tpa.paged_attention(q, kp, vp, table, torch.tensor([4, 2]), 0.25, PS)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("bad", ["heads", "int8_without_scales", "scales_without_int8",
                                 "table_rows", "page_size", "scale_shape"])
def test_bad_operands_raise(bad):
    B, Hq, Hkv, D, PS, P = 2, 4, 2, 16, 4, 5
    kp, vp, ks, vs = (T(a) for a in _pool(P, Hkv, PS, D, True, seed=5))
    q = torch.zeros(B, 1, Hq, D)
    table = torch.zeros((B, 2), dtype=torch.int32)
    base = torch.zeros(B, dtype=torch.int32)
    kw = dict(k_scale_pages=ks, v_scale_pages=vs)
    if bad == "heads":
        q = torch.zeros(B, 1, 3, D)
    elif bad == "int8_without_scales":
        kw = {}
    elif bad == "scales_without_int8":
        kp, vp = kp.float(), vp.float()
    elif bad == "table_rows":
        table = torch.zeros((B + 1, 2), dtype=torch.int32)
    elif bad == "scale_shape":
        kw = dict(k_scale_pages=ks[:, :, :2], v_scale_pages=vs[:, :, :2])
    ps = 8 if bad == "page_size" else PS
    with pytest.raises(ValueError):
        tpa.paged_attention_multi(q, kp, vp, table, base, 0.1, ps, **kw)


def _paged_caches(quantized, P, H, PS, D, table):
    dt = np.int8 if quantized else np.float32
    c = {"k_pages": np.zeros((P, H, PS, D), dt), "v_pages": np.zeros((P, H, PS, D), dt),
         "table": table}
    if quantized:
        c["k_scale_pages"] = np.zeros((P, H, PS), np.float32)
        c["v_scale_pages"] = np.zeros((P, H, PS), np.float32)
    return c


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_cache_update_matches_jax(quantized):
    """The in-place page writes against JAX's functional ones, bit for bit:
    batched prefill through slot_pages, the t == 1 decode write through the
    table (a slot on the trash page included), and a multi-token window
    crossing a page, one slot parked at max_seq-1 (clamped)."""
    B, H, PS, D, MAXP = 3, 2, 4, 16, 3
    P = 10  # trash page 9
    r = np.random.default_rng(6)
    table = np.array([[2, 5, 7], [0, 1, 8], [9, 9, 9]], np.int32)
    cases = [
        (0, 8, {"slot_pages": table[:2]}),       # two prompts of 8 (2 pages each)
        (np.array([5, 3, 0], np.int32), 1, {}),  # decode; slot 2 released
        (np.array([2, 11, 0], np.int32), 3, {}),  # verify window; slot 1 parked at 11
    ]
    for pos, t, extra in cases:
        rows = 2 if "slot_pages" in extra else B
        k, v = (r.standard_normal((rows, t, H, D)).astype(np.float32) for _ in range(2))
        c = _paged_caches(quantized, P, H, PS, D, table)
        jc = jattn.cache_update({n: jnp.asarray(a) for n, a in {**c, **extra}.items()},
                                jnp.asarray(k), jnp.asarray(v),
                                pos if isinstance(pos, int) else jnp.asarray(pos))
        tc = tattn.cache_update({n: T(np.array(a)) for n, a in {**c, **extra}.items()},
                                T(k), T(v), pos if isinstance(pos, int) else T(pos))
        for name in c:
            if name == "table":
                continue
            if t == 3 and name.endswith("pages"):
                # the parked slot's clamped window writes one position three
                # times: JAX keeps the last write, CUDA any; compare elsewhere
                got, want = tc[name].numpy().copy(), np.asarray(jc[name]).copy()
                got[8, :, PS - 1], want[8, :, PS - 1] = 0, 0
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]),
                                              err_msg=name)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_cached_attention_matches_jax(quantized):
    """The read side: decode (vector pos, t == 1), a verify window (t > 1)
    and a chunk continuation ("chunk_table", scalar pos) over the same
    pool."""
    B, Hq, H, PS, D = 2, 4, 2, 4, 16
    r = np.random.default_rng(7)
    kp, vp, ks, vs = _pool(12, H, PS, D, quantized, seed=8)
    table = np.array([[3, 1, 4, 11], [5, 9, 2, 6]], np.int32)
    c = {"k_pages": kp, "v_pages": vp, "table": table}
    if quantized:
        c |= {"k_scale_pages": ks, "v_scale_pages": vs}
    for pos, t, extra in ((np.array([6, 13], np.int32), 1, {}),
                          (np.array([2, 9], np.int32), 4, {}),
                          (5, 8, {"chunk_table": table[:1]})):
        rows = 1 if extra else B
        q = r.standard_normal((rows, t, Hq, D)).astype(np.float32)
        jp = pos if isinstance(pos, int) else jnp.asarray(pos)
        tp = pos if isinstance(pos, int) else T(pos)
        want = np.asarray(jattn.cached_attention(
            {n: jnp.asarray(a) for n, a in {**c, **extra}.items()}, jnp.asarray(q), None, None,
            jp, 0.25))
        got = tattn.cached_attention({n: T(a) for n, a in {**c, **extra}.items()}, T(q), None,
                                     None, tp, 0.25).numpy()
        np.testing.assert_allclose(got, want, **TOL)


def _bf16_terms(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (f32) as the sum of n bf16 terms, each the bf16 rounding of what the
    earlier terms left (the f32 remainders are exact), summed in f64."""
    out, r = torch.zeros_like(x, dtype=torch.float64), x
    for _ in range(n):
        h = r.to(torch.bfloat16).float()
        out, r = out + h.double(), r - h
    return out


def _window_arm_emulated(q, k, v, ks, vs, lim, scale, terms):
    """The tensor-core window arm's arithmetic on dense keys [S, H, D]: q
    (scaled) and the weights (V scale folded in) enter the products as
    ``terms`` bf16 terms, the keys and values exactly, the sums in f64."""
    qf = (q * scale).float()
    s = torch.einsum("thd,shd->hts", _bf16_terms(qf, terms), k.double()).float()
    s = s * ks.t()[:, None, :]
    allowed = torch.arange(k.shape[0])[None, :] < lim[:, None]          # [t, S]
    s = torch.where(allowed[None], s, tpa.NEG_INF)
    p = torch.where(allowed[None], torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    pv = _bf16_terms(p * vs.t()[:, None, :], terms)
    out = torch.einsum("hts,shd->thd", pv, v.double()).float()
    return out * torch.where(l == 0, 1.0, 1.0 / l).permute(1, 0, 2)


@pytest.mark.parametrize("quantized", [True, False])
def test_window_arm_needs_two_bf16_terms(quantized):
    """Why the tensor-core arm splits q and p into two bf16 terms: with two
    the emulated arm stays within rtol = atol = 2e-5 of the plain version
    (and the CUDA-core arm's rtol 1e-4, atol 1e-5); with one it misses that
    bound by more than 10x.  Keys are int8 codes or bf16 elements, exact in
    bf16.  One slot, pages in order, a window of 16 rows at base 40."""
    t, H, D, PS, base = 16, 4, 128, 16, 40
    n = -(-(base + t) // PS)
    r = np.random.default_rng(11)
    q = torch.from_numpy(r.standard_normal((1, t, H, D)).astype(np.float32))
    if quantized:
        kp, vp, ks, vs = (T(a) for a in _pool(n, H, PS, D, True, 12))
    else:
        kp, vp = (T(r.standard_normal((n, H, PS, D)).astype(np.float32)).to(torch.bfloat16)
                  for _ in range(2))
        ks = vs = None
    table = torch.arange(n, dtype=torch.int32)[None]
    scale = D ** -0.5
    want = tpa.paged_attention_plain(q, kp, vp, table, torch.tensor([base]), scale, PS, ks, vs)[0]

    def dense(pages):
        return pages.transpose(1, 2).reshape(n * PS, *pages.shape[1:2], *pages.shape[3:]).float()

    k, v = dense(kp), dense(vp)
    ksd = dense(ks[..., None])[..., 0] if quantized else torch.ones(n * PS, H)
    vsd = dense(vs[..., None])[..., 0] if quantized else torch.ones(n * PS, H)
    lim = base + 1 + torch.arange(t)
    ratio = []
    for terms in (1, 2):
        got = _window_arm_emulated(q[0], k, v, ksd, vsd, lim, scale, terms)
        ratio.append(((got - want).abs() / (2e-5 + 2e-5 * want.abs())).max().item())
        if terms == 2:
            torch.testing.assert_close(got, want, **TOL)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert ratio[0] > 10 and ratio[1] <= 1, ratio
