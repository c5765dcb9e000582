"""Paged decode attention's arm "split" on the CPU
(`pb_llm_tpu_torch.ops.paged_attention`: `split_plain`, `split_keys`,
`n_splits`, `window_arm`): its arithmetic, per split of whole pages then
the merge in split order, held against the JAX Pallas kernel in interpret
mode at t = 1 (rtol = atol = 2e-5, the JAX oracle's bound,
tests/test_torch_paged_attention.py), quantized and not, MHA and GQA, two
page sizes; its grid follows the table's width, never the lengths; pages
past a slot's limit (stale pages, the trash page) never reach it, NaN
included; and the CPU wrapper launches nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.ops.paged_attention import paged_attention as jax_paged_attention
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


@pytest.mark.parametrize("page_size,maxp", [(8, 20), (16, 10)])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 4)])
def test_split_plain_matches_jax_kernel(quantized, Hq, Hkv, page_size, maxp):
    """Lengths 0 (an empty slot), 1, one split exactly, one key past a
    split, mid-table and the full table, through a random table: more than
    one split where the slot holds more than `split_keys` keys."""
    B, D, P = 6, 32, 70
    r = np.random.default_rng(Hq + 2 * quantized + page_size)
    q = r.standard_normal((B, Hq, D)).astype(np.float32)
    arrs = _pool(P, Hkv, page_size, D, quantized, seed=Hkv + page_size)
    table = r.integers(0, P, size=(B, maxp)).astype(np.int32)
    sk = tpa.split_keys(page_size)
    lengths = np.array([0, 1, sk, sk + 1, 77, maxp * page_size], np.int32)
    kp, vp, ks, vs = arrs
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), 0.3, page_size,
        k_scale_pages=None if ks is None else jnp.asarray(ks),
        v_scale_pages=None if vs is None else jnp.asarray(vs), interpret=True))
    got = tpa.split_plain(T(q), T(kp), T(vp), T(table), T(lengths), 0.3, page_size,
                          None if ks is None else T(ks), None if vs is None else T(vs))
    assert not got[0].any()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the two plain forms of the kernel's function: one softmax, or splits merged
    plain = tpa.paged_attention(T(q), T(kp), T(vp), T(table), T(lengths), 0.3, page_size,
                                None if ks is None else T(ks), None if vs is None else T(vs))
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6)


def test_split_count_follows_the_table_width_not_the_lengths():
    """Splits of whole pages (128 keys: 8 pages of 16; the most pages below
    128 keys for a page that does not divide 128; one page above 128),
    ceil(table width · page / split keys) of them a slot whatever the
    lengths are (a captured step's grid and workspace hold for every
    length); a split holds keys only up to its slot's length."""
    assert tpa.SPLIT_KEYS == 128 and tpa.DECODE_ARM == tpa.SPLIT
    for ps, sk in ((16, 128), (8, 128), (1, 128), (5, 125), (48, 96), (128, 128), (256, 256)):
        assert tpa.split_keys(ps) == sk and sk % ps == 0
    for maxp, ps, n in ((128, 16, 16), (10, 16, 2), (20, 5, 1), (4, 128, 4), (1, 16, 1)):
        assert tpa.n_splits(maxp, ps) == n
    g = torch.Generator().manual_seed(0)
    kp = torch.randn(12, 2, 16, 16, generator=g)
    vp = torch.randn(12, 2, 16, 16, generator=g)
    q = torch.randn(1, 2, 16, generator=g)
    table = torch.arange(1, 9, dtype=torch.int32)[None]
    for n in (0, 1, 63, 64, 65, 127, 128):
        lens = torch.tensor([n])
        torch.testing.assert_close(tpa.split_plain(q, kp, vp, table, lens, 0.25, 16),
                                   tpa.paged_attention(q, kp, vp, table, lens, 0.25, 16),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("quantized", [False, True])
def test_stale_and_trash_pages_never_reach_the_output(quantized):
    """Every page no key below a slot's length lives in, and the rows of the
    last live page past the length, hold NaN (the values, or an int8 page's
    scales); the table's entries past the last live page name the trash
    page or stale pages.  The split arm reads none of them: its output
    equals the one over a pool with those rows zeroed."""
    B, Hq, Hkv, D, PS, P = 3, 8, 4, 16, 8, 12
    kp, vp, ks, vs = (None if a is None else T(a) for a in _pool(P, Hkv, PS, D, quantized, 6))
    trash = P - 1
    table = torch.tensor([[0, 1, 2, trash, trash, trash], [3, 4, 5, 6, 7, 8],
                          [9, 10, trash, 2, 3, 4]], dtype=torch.int32)
    lengths = torch.tensor([19, 48, 9])
    live = torch.zeros(P, PS, dtype=torch.bool)
    for b, n in enumerate(lengths.tolist()):
        for key in range(n):
            live[table[b, key // PS], key % PS] = True
    dead = ~live[:, None, :].expand(P, Hkv, PS)

    def poisoned(fill):
        pools = [x.clone() if x is not None else None for x in (kp, vp, ks, vs)]
        targets = pools[2:] if quantized else pools[:2]
        for x in targets:
            x[dead] = fill
        return pools

    q = torch.randn(B, Hq, D, generator=torch.Generator().manual_seed(2))
    got = tpa.split_plain(q, *poisoned(float("nan"))[:2], table, lengths, 0.25, PS,
                          *poisoned(float("nan"))[2:])
    want = tpa.split_plain(q, *poisoned(0.0)[:2], table, lengths, 0.25, PS, *poisoned(0.0)[2:])
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_arm_rule_sends_decode_to_split():
    """Decode (t = 1) takes DECODE_ARM "split" over every page type where
    G <= SPLIT_MAX_ROWS and the head dim is a multiple of 8 up to 128, the
    CUDA cores otherwise; windows keep their arms (tensor cores over int8
    and bf16 pages, CUDA cores over f32 pages)."""
    for dt in (torch.int8, torch.bfloat16, torch.float32):
        assert tpa.window_arm(1, dt) == tpa.window_arm(1, dt, 8, 64) == tpa.SPLIT
        assert tpa.window_arm(1, dt, 16, 128) == tpa.window_arm(1, dt, 4, 12) == tpa.CUDA_CORES
        assert tpa.window_arm(1, dt, 1, 256) == tpa.CUDA_CORES
    assert tpa.window_arm(5, torch.int8) == tpa.window_arm(5, torch.bfloat16) == tpa.TENSOR_CORES
    assert tpa.window_arm(5, torch.float32) == tpa.CUDA_CORES
    assert tpa.split_ok(5, 128) and not tpa.split_ok(20, 128)
    assert tpa.ARMS == (tpa.SPLIT, tpa.TENSOR_CORES, tpa.CUDA_CORES)


def test_cpu_decode_is_the_plain_version_and_counts_nothing():
    B, Hq, Hkv, D, PS, P = 2, 4, 2, 16, 4, 9
    kp, vp, ks, vs = (T(a) for a in _pool(P, Hkv, PS, D, True, seed=3))
    q = torch.randn(B, Hq, D, generator=torch.Generator().manual_seed(0))
    table = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    lengths = torch.tensor([3, 12])
    names = ("launches", "decode_launches", "split_launches", "cores_launches")
    before = {k: getattr(tpa, k) for k in names}
    got = tpa.paged_attention(q, kp, vp, table, lengths, 0.5, PS, ks, vs)
    assert torch.equal(got, tpa.paged_attention_plain(q[:, None], kp, vp, table, lengths - 1,
                                                      0.5, PS, ks, vs)[:, 0])
    tpa.split_plain(q, kp, vp, table, lengths, 0.5, PS, ks, vs)
    assert {k: getattr(tpa, k) for k in names} == before
