"""The exact f32 kernel's decode arm "split" on the CPU: below F32_TC rows
`packed_matmul.pb_f32_matmul` (flat, any row groups) and
`pb_f32_matmul_stacked` run the dma kernel's "split" device code
(`csrc/pb_dma_v2.cu`, entry `pb_dma_v2_split`).

The emulation here does in plain PyTorch what that kernel does, by its own
index arithmetic (`tests/test_torch_tc_arms.py::_dma_split_emulated`,
widened to row groups): x and each row group's gathered x in three bf16
terms, each unit's term partials exact (float64) and rounded once to f32,
joined lo·2^-16, mid·2^-8, hi with single f32 roundings, the K ranges
summed apart and added in range order, each column reading its tile's row
group, the epilogue in the plain version's order.  Held against the JAX
package's `_planar_v2_kernel` (two row groups) and `_stacked_f32_kernel`
in interpret mode within rtol = atol = 1e-4 (the exact arm's bound), and
against the plain version; an identity x reads the plain version's y back
bit for bit; the arm rule and the K split read the layer alone; the CPU
wrappers launch nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.ops import pallas_pb
from pb_llm_tpu_torch.data.synthetic import random_packed_v2
from pb_llm_tpu_torch.models import stacking
from pb_llm_tpu_torch.ops import decode_arms as da
from pb_llm_tpu_torch.ops import packed_matmul as pm
from tests.test_torch_decode_arms import _make_v2

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _x(m, ic, seed):
    return np.random.default_rng(seed).standard_normal((m, ic)).astype(np.float32)


def _f32(a):
    return torch.as_tensor(a, dtype=torch.float64).float()


def _split_emulated(x: torch.Tensor, p) -> torch.Tensor:
    """Arm "split" on x [m, ic] and layout ``p`` (a flat layer or a stacked
    layer's views): its operands (`prepare_split`'s plain version), then
    per K range (`split_ranges`) and unit in order: a word group's A = 2·bit
    p (+16) of its 8 sign words; a sidecar chunk's A = each slot's code (its
    shard segment's nibble half), multiplied by the gathered x of each
    column's row group; each term's partial exact and rounded to f32, added
    lo·2^-16, mid·2^-8, hi; the ranges' sums in range order; the epilogue
    (ab·0.5 first, rsg of the column's group)."""
    ops = pm.prepare_split(x, p)
    assert ops.layout == "split"
    xp = ops.xp.double().numpy()                                     # [3, m, icp]
    xgp = ops.xgp.double().numpy()                                   # [3, n_rg, m, kst]
    m = xp.shape[1]
    ic, pb, oc = p.ic_local, p.pack_block_local, p.oc_local
    group = np.arange(oc) // p.col_tile
    sign = p.sign_packed.numpy().view(np.uint32).astype(np.int64)
    sign = np.concatenate([sign, np.zeros((8, oc), np.int64)])       # rows past the plane: zeros
    gf, nfull = pb // 32, ic // pb
    ngf = -(-gf // 8)
    ng = nfull * ngf + -(-((ic - nfull * pb) // 32) // 8)
    side = p.side_val.numpy().astype(np.int64)
    side = np.concatenate([side, np.zeros((p.k_pad + 64, oc), np.int64)])
    kps = p.k_pad_shard_local
    scale = (1.0, 2.0 ** -8, 2.0 ** -16)

    def unit_partials(u):
        if u < ng:
            blk = u // ngf if u < nfull * ngf else nfull
            s = u - blk * ngf
            words = sign[blk * gf + 8 * s + np.arange(8)]            # [8, oc]
            a = np.concatenate([np.stack([(words >> bp) & 1, (words >> (bp + 16)) & 1], 1)
                                .reshape(16, oc) for bp in range(16)]) * 2.0   # [256, oc]
            return [_f32(xp[t, :, 256 * u: 256 * u + 256] @ a) for t in range(3)], "b"
        j0 = (u - ng) * 64
        codes = []
        for j in range(j0, j0 + 64):
            if p.side_bits == 8:
                codes.append(side[j])
            else:
                j8, half = j - j % 8, kps // 2
                sh, r = j8 // kps, j8 % kps
                v = side[sh * half + r % half + j % 8]
                codes.append((v >> (4 if (j % kps) >= half else 0)) & 15)
        a = np.stack(codes).astype(np.float64)
        parts = []
        for t in range(3):
            y = np.zeros((m, oc))
            for g in range(p.n_row_groups):
                cols = group == g
                y[:, cols] = xgp[t, g, :, j0: j0 + 64] @ a[:, cols]
            parts.append(_f32(y))
        return parts, "v"

    sums = []
    for u0, u1 in pm.split_ranges(p):
        acc = {"b": torch.zeros((m, oc)), "v": torch.zeros((m, oc))}
        for u in range(u0, u1):
            parts, which = unit_partials(u)
            s = acc[which] + parts[2] * scale[2]
            s = s + parts[1] * scale[1]
            acc[which] = s + parts[0]
        sums.append(acc)
    ab, av = sums[0]["b"], sums[0]["v"]
    for r in sums[1:]:
        ab, av = ab + r["b"], av + r["v"]
    alpha2, beta, gamma, hs, bias = ops.f32.coef
    y = ops.f32.rs[:, None] * beta + (ab * 0.5) * alpha2
    y = y + av * hs
    y = y + ops.f32.rsg.t()[:, torch.as_tensor(group)] * gamma
    return y + bias


FLAT_JAX = {
    "512x256_groups2": dict(oc=256, ic=512, col_tile=128),
    "416x256_groups2_side4": dict(oc=256, ic=416, col_tile=128, high_bits=4, pack_block=128),
}


@pytest.fixture(scope="module")
def flat_jax():
    """Per layer: (port layer, x, JAX's `_planar_v2_kernel` y in interpret
    mode at 8 rows, decode_dot f32)."""
    out = {}
    for name, kw in FLAT_JAX.items():
        jp, tp = _make_v2(**kw)
        x = _x(8, jp.ic, 41)
        with jax.default_matmul_precision("float32"):
            want = np.asarray(pallas_pb.pb_matmul_pallas_v2(jnp.asarray(x), jp, interpret=True,
                                                            oc_tile=128, decode_dot="f32"))
        out[name] = tp, x, want
    return out


def _stack(n=2):
    layers = [_make_v2(256, 256, seed=s) for s in range(n)]
    jsp = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *[j for j, _ in layers])
    tsp = stacking.stack_layers({"layers": [{"w": t} for _, t in layers]})["layers_stacked"]["w"]
    return jsp, tsp


@pytest.fixture(scope="module")
def stacked_jax():
    """(port stack, x, [JAX's `_stacked_f32_kernel` y for each layer])."""
    jsp, tsp = _stack()
    x = _x(4, 256, 42)
    with jax.default_matmul_precision("float32"):
        want = [np.asarray(pallas_pb.pb_matmul_pallas_v2_stacked(
            jnp.asarray(x), jsp, jnp.int32(li), interpret=True, oc_tile=128, decode_dot="f32"))
            for li in range(2)]
    return tsp, x, want


def _marker(tsp, li):
    return stacking.StackedPackedLinearV2(tsp, li, torch.tensor([li], dtype=torch.int32))


@pytest.mark.parametrize("name", sorted(FLAT_JAX))
def test_split_emulation_matches_jax_planar_kernel_over_row_groups(flat_jax, name):
    tp, x, want = flat_jax[name]
    assert tp.n_row_groups == 2 and pm.f32_arm(8, tp) == "split"
    got = _split_emulated(torch.from_numpy(x), tp)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", sorted(FLAT_JAX))
def test_split_emulation_matches_the_plain_version(flat_jax, name):
    """The arm's order of sums moves y by f32 roundings only: within 1e-5 of
    max|y| of the plain version and of the plain version on its operands."""
    tp, x, _ = flat_jax[name]
    xt = torch.from_numpy(x)
    got = _split_emulated(xt, tp)
    for want in (pm.pb_f32_matmul_plain(xt, tp), pm.tc_matmul_plain(pm.prepare_split(xt, tp), tp),
                 pm.pb_f32_matmul(xt, tp)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("li", [0, 1])
def test_split_emulation_matches_jax_stacked_kernel(stacked_jax, li):
    """Layer li of the stack through the stacked entry's arm "split": its
    layer's views, the same emulation (one device code), against JAX's
    stacked f32 kernel; the CPU wrapper gives the plain version."""
    tsp, x, want = stacked_jax
    mk = _marker(tsp, li)
    lp = pm.stacked_layer(mk)
    assert pm.f32_arm(4, lp) == "split" and pm.stacked_supported_v2(tsp)
    got = _split_emulated(torch.from_numpy(x), lp)
    np.testing.assert_allclose(got.numpy(), want[li], **TOL)
    np.testing.assert_allclose(pm.pb_f32_matmul_stacked(torch.from_numpy(x), mk).numpy(),
                               want[li], **TOL)


@pytest.mark.parametrize("side_bits", [8, 4])
def test_split_emulation_reads_an_identity_back_bit_for_bit(side_bits):
    """An identity x over two row groups: every partial is exact (one
    nonzero product), so y equals the plain version's bit for bit."""
    p = random_packed_v2(1024, 256, torch.Generator().manual_seed(5), side_bits=side_bits,
                         bias=True, col_tile=128)
    assert p.n_row_groups == 2 and len(pm.split_ranges(p)) > 1
    for rows in (slice(0, 8), slice(500, 531)):
        x = torch.eye(1024)[rows].contiguous()
        assert torch.equal(_split_emulated(x, p), pm.pb_f32_matmul_plain(x, p))


def test_f32_arm_takes_split_exactly_below_f32_tc():
    """"split" for m < F32_TC (dot f32) on 1-bit lows where `tc_layout_ok`,
    "tc" from F32_TC, "cores" for dot bf16 below F32_TC, for layouts the
    tensor cores refuse and for 2-bit lows; the stacked entry reads the same
    rule on its layer's views."""
    g = torch.Generator().manual_seed(0)
    p = random_packed_v2(256, 256, g, col_tile=128)
    for m in range(1, pm.F32_TC):
        assert pm.f32_arm(m, p) == "split" and pm.f32_arm(m, p, torch.bfloat16) == "cores"
    assert pm.f32_arm(pm.F32_TC, p) == pm.f32_arm(pm.F32_TC, p, torch.bfloat16) == "tc"
    odd = random_packed_v2(256, 264, g)
    assert not pm.tc_layout_ok(odd) and pm.f32_arm(8, odd) == "cores"
    split_tile = random_packed_v2(256, 256, g, col_tile=64)
    assert not pm.tc_layout_ok(split_tile) and pm.f32_arm(8, split_tile) == "cores"
    low2 = dataclasses.replace(p, low_bits=2, sign_packed=torch.cat([p.sign_packed] * 2))
    assert pm.f32_arm(8, low2) == "cores"
    _, tsp = _stack()
    assert pm.f32_arm(8, pm.stacked_layer(_marker(tsp, 1))) == "split"
    assert pm.F32_ARMS == ("cores", "split", "tc") and pm.F32_DECODE_ARM == "split"


@pytest.mark.parametrize("ic,oc,ks", [(4096, 4096, 8), (4096, 11008, 4), (11008, 4096, 8),
                                      (4096, 12288, 4), (512, 256, 2)])
def test_split_ksplit_and_ranges_follow_the_shape_alone(ic, oc, ks):
    """The ranges read the layer's shape alone (no m, no row groups): the
    dma arm's rule, the same for the f32 arm, flat or stacked; they cut the
    units in order, none empty."""
    g = torch.Generator().manual_seed(1)
    p = random_packed_v2(ic, oc, g, low_frac=0.9)
    grouped = random_packed_v2(ic, oc, g, low_frac=0.9, col_tile=min(oc, 4096))
    assert pm.split_ksplit(p) == pm.split_ksplit(grouped) == da.dma_ksplit(p) == ks
    ranges = pm.split_ranges(p)
    assert ranges == da.dma_ranges(p) and len(ranges) == ks and ranges[0][0] == 0
    assert ranges[-1][1] == pm.split_units(p)
    assert all(a < b for a, b in ranges) and all(r[1] == s[0] for r, s in zip(ranges, ranges[1:]))


def test_cpu_wrappers_launch_nothing():
    """On a CPU tensor the flat and stacked wrappers run the plain versions
    and count no launch of any arm or of the x preparation."""
    names = ("f32_launches", "f32_tc_launches", "f32_split_launches", "stacked_f32_launches",
             "stacked_f32_tc_launches", "stacked_f32_split_launches", "split_prep_launches")
    before = {k: getattr(pm, k) for k in names}
    p = random_packed_v2(256, 256, torch.Generator().manual_seed(2), col_tile=128)
    x = torch.from_numpy(_x(5, 256, 3))
    assert torch.equal(pm.pb_f32_matmul(x, p), pm.pb_f32_matmul_plain(x, p))
    pm.prepare_split(x, p)
    _, tsp = _stack()
    mk = _marker(tsp, 1)
    assert torch.equal(pm.pb_f32_matmul_stacked(x, mk), pm.pb_f32_matmul_stacked_plain(x, mk))
    assert {k: getattr(pm, k) for k in names} == before
