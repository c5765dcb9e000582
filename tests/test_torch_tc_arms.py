"""The two redesigned decode arms on the bf16 tensor cores, fixed on the CPU:
the dma kernel's arm "split" (`ops.decode_arms`, `csrc/pb_dma_v2.cu`) and
the PBW-v1 planar kernel's arm "tc" (`ops.packed_matmul_v1`,
`csrc/pb_planar_v1.cu`).

Each arm's emulation here does in plain PyTorch what its kernel does, by
the kernel's own index arithmetic: x in three bf16 terms, each unit or
stage's term partials exact (float64) and rounded once to f32 (the tensor
cores' in-stage sum), the partials joined and folded in the kernel's order
with single f32 roundings, the K ranges summed apart and added in range
order, the epilogue in the plain version's order.  Held against the JAX
package's Pallas kernels in interpret mode (rtol = atol = 1e-4, the exact
arms' bound) and against the plain versions; an identity x reads the plain
version's y back bit for bit; the arm and K-split rules read the layer's
shape alone; and the CPU wrappers launch nothing.

The tensor cores' own f32 sums inside a unit (which truncate) are not
emulated: the card tests hold the kernels to the same bounds
(tests/test_torch_cuda_kernels.py).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.core import pbw as jpbw
from pb_llm_tpu.ops import pallas_pb
from pb_llm_tpu.quant.high_quant import high_calibrate, high_quantize
from pb_llm_tpu.quant.low_quant import low_calibrate, low_quantize
from pb_llm_tpu_torch.core import packing, pbw
from pb_llm_tpu_torch.data.synthetic import random_packed_v1, random_packed_v2
from pb_llm_tpu_torch.interop import packed_from_fields
from pb_llm_tpu_torch.ops import bf16_terms
from pb_llm_tpu_torch.ops import decode_arms as da
from pb_llm_tpu_torch.ops import packed_matmul as pm
from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _x(m, ic, seed):
    return np.random.default_rng(seed).standard_normal((m, ic)).astype(np.float32)


def _f32(a):
    return torch.as_tensor(a, dtype=torch.float64).float()


# ---------------------------------------------------------------------------
# dma, arm "split"
# ---------------------------------------------------------------------------

def _dma_split_emulated(x: torch.Tensor, p) -> torch.Tensor:
    """Arm "split" on x [m, ic]: its operands (`prepare_dma`'s plain
    version), then per K range (`dma_ranges`) and unit in order: a word
    group's A = 2·bit p (+16) of its 8 sign words, a sidecar chunk's A =
    the code of each slot (its shard segment's nibble half), each term's
    partial over the unit exact and rounded to f32, added lo·2^-16, mid·2^-8,
    hi; the ranges' sums in range order; the epilogue (ab·0.5 first)."""
    ops = da.prepare_dma(x, p, "split")
    xp = ops.xt.double().numpy()                                     # [3, m, icp]
    xgp = ops.xgp.double().numpy()[:, 0]                             # [3, m, kst]
    m = xp.shape[1]
    ic, pb, oc = p.ic_local, p.pack_block_local, p.oc_local
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
        return [_f32(xgp[t, :, j0: j0 + 64] @ a) for t in range(3)], "v"

    sums = []
    for u0, u1 in da.dma_ranges(p):
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
    y = y + ops.f32.rsg[0][:, None] * gamma
    return y + bias


def _make_v2(oc, ic, high_bits=8, seed=0, low_frac=0.9):
    """`tests/test_torch_decode_arms.py::_make_v2`: a JAX-packed layer (bias
    on, global selection) → (JAX layer, port layer)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((oc, ic)).astype(np.float32)
    w *= (1.0 + 3.0 * (rng.random(ic) < 0.1))[None, :]
    mask = np.asarray(jpbw.column_structured_mask(jnp.abs(jnp.asarray(w)), low_frac, 0))
    low = low_calibrate(jnp.asarray(w * mask), "xnor", -1)
    high = high_calibrate(jnp.asarray(w), bits=high_bits)
    w_q = np.where(mask, np.asarray(low_quantize(jnp.asarray(w), low, "xnor", -1)),
                   np.asarray(high_quantize(jnp.asarray(w), high)))
    b = jnp.asarray(rng.standard_normal(oc).astype(np.float32))
    jp, _ = jpbw.pack_linear_v2(jnp.asarray(w_q), jnp.asarray(mask), low, high, "xnor", bias=b)
    return jp, packed_from_fields(jp)


DMA_JAX = {"1024x256": dict(oc=256, ic=1024), "416x128_side4": dict(oc=128, ic=416, high_bits=4)}


@pytest.fixture(scope="module")
def dma_jax():
    """Per layer: (port layer, x, the JAX dma kernel's y in interpret mode)."""
    out = {}
    for name, kw in DMA_JAX.items():
        jp, tp = _make_v2(**kw)
        x = _x(8, jp.ic, 31)
        with jax.default_matmul_precision("float32"):
            want = np.asarray(pallas_pb.pb_matmul_pallas_v2(jnp.asarray(x), jp, interpret=True,
                                                            decode_dot="dma"))
        out[name] = tp, x, want
    return out


@pytest.mark.parametrize("name", sorted(DMA_JAX))
def test_dma_split_emulation_matches_jax_dma_kernel(dma_jax, name):
    tp, x, want = dma_jax[name]
    assert da.dma_arm(tp) == "split"
    got = _dma_split_emulated(torch.from_numpy(x), tp)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", sorted(DMA_JAX))
def test_dma_split_emulation_matches_the_plain_version(dma_jax, name):
    """The arm's order of sums moves y by f32 roundings only: within 1e-5 of
    max|y| of the plain version and of the plain version on its operands."""
    tp, x, _ = dma_jax[name]
    xt = torch.from_numpy(x)
    got = _dma_split_emulated(xt, tp)
    for want in (da.pb_dma_v2_plain(xt, tp), da.dma_matmul_plain(da.prepare_dma(xt, tp, "split"),
                                                                 tp)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("side_bits", [8, 4])
def test_dma_split_emulation_reads_an_identity_back_bit_for_bit(side_bits):
    """An identity x: every partial is exact (one nonzero product), so y
    equals the plain version's bit for bit."""
    p = random_packed_v2(1024, 256, torch.Generator().manual_seed(3), side_bits=side_bits,
                         bias=True)
    assert len(da.dma_ranges(p)) > 1
    for rows in (slice(0, 8), slice(500, 755)):
        x = torch.eye(1024)[rows].contiguous()
        assert torch.equal(_dma_split_emulated(x, p), da.pb_dma_v2_plain(x, p))


@pytest.mark.parametrize("ic,oc,ks", [(4096, 4096, 8), (4096, 11008, 4), (11008, 4096, 8),
                                      (1024, 256, 4), (256, 128, 2)])
def test_dma_ksplit_and_ranges_follow_the_shape_alone(ic, oc, ks):
    """The least power of two bringing the 128-column tiles to SPLIT_BLOCKS,
    at most 8 and at most the units; the ranges cut the units in order,
    none empty.  Neither reads m."""
    p = random_packed_v2(ic, oc, torch.Generator().manual_seed(0), low_frac=0.9)
    assert da.dma_ksplit(p) == ks
    ranges = da.dma_ranges(p)
    units = sum(-(-r // pm.TC_GROUP) for r in packing.block_sizes(ic, p.pack_block_local))
    units += -(-p.k_pad // pm.TC_SLOTS)
    assert len(ranges) == ks and ranges[0][0] == 0 and ranges[-1][1] == units
    assert all(a < b for a, b in ranges) and all(r[1] == s[0] for r, s in zip(ranges, ranges[1:]))


def test_dma_arm_follows_the_layout():
    """"split" (DMA_ARM) wherever the tensor cores take the layout, for every
    m; "cores" where they do not (oc not a multiple of 16)."""
    assert da.DMA_ARM == "split" and da.DMA_ARMS == ("cores", "split")
    p = random_packed_v2(256, 256, torch.Generator().manual_seed(0))
    assert da.dma_arm(p) == "split"
    odd = random_packed_v2(256, 264, torch.Generator().manual_seed(0))
    assert not pm.tc_layout_ok(odd) and da.dma_arm(odd) == "cores"


def test_dma_split_operands_carry_x_exactly():
    """The "split" operands' plain version: x's three terms in
    tc_pair_columns' order sum back to x, xg's to the gathered x (zeros
    past k_pad, to a multiple of 64 slots), and the operands' plain version
    equals the plain version of x."""
    p = random_packed_v2(416, 128, torch.Generator().manual_seed(1), side_bits=4, pack_block=128)
    x = torch.from_numpy(_x(5, 416, 2))
    ops = da.prepare_dma(x, p, "split")
    assert ops.layout == "split" and ops.xt.shape[0] == 3 and ops.xgp.shape[:3] == (3, 1, 5)
    assert torch.equal(pm.tc_x(pm.TcOperands(ops.xt, ops.xgp, ops.f32), p), x)
    xg = pm.join_terms(ops.xgp)[0]
    assert torch.equal(xg[..., :p.k_pad], pbw.gather_x_v2(x, p)[..., 0])
    assert not xg[..., p.k_pad:].any() and ops.xgp.shape[3] % pm.TC_SLOTS == 0
    assert torch.equal(da.dma_matmul_plain(ops, p), da.dma_matmul_plain(
        da.prepare_dma(x, p, "cores"), p))


# ---------------------------------------------------------------------------
# PBW-v1 planar, arm "tc"
# ---------------------------------------------------------------------------

def _planar_tc_emulated(x: torch.Tensor, p) -> torch.Tensor:
    """Arm "tc" on x [m, ic]: x in `tc_x_order` and three nearest-even bf16
    terms; per K range (`planar_ranges`) and PLANAR_STAGE-row stage in order: each
    plane's (C, M, V) term partials exact and rounded to f32, joined t2 +
    t1, then + t0; the stage's group (that of its first word) folds
    (rs·β + xc·2α) + xm·2γ, rs the stage row sum of
    `planar_stage_sums_plain`; the ranges' two sums in range order; then
    (total + xv·hs) + bias."""
    ic, oc, gs, G = p.ic_local, p.oc_local, p.groupsize_local, p.n_groups
    order = v1.tc_x_order(ic, p.pack_block_local)
    xs = bf16_terms.split(x.float()[:, order], 3).double()           # [3, m, ic]
    planes = [v1.low_code(p.sign_packed, p.low_bits, ic, p.pack_block_local)[order],
              packing.unpack_bits(p.mask_packed, ic, p.pack_block_local).float()[order],
              v1.sidecar_codes(p).float()[order]]
    planes = [pl.double() for pl in planes]
    rss = v1.planar_stage_sums_plain(x, p)                           # [n_st, m]
    coef = v1.planar_coef(p)
    g = min(ic, p.pack_block_local) // 32
    m = x.shape[0]
    sums = []
    for s0, s1 in v1.planar_ranges(p):
        tot, accv = torch.zeros((m, oc)), torch.zeros((m, oc))
        st = v1.PLANAR_STAGE
        for s in range(s0, s1):
            k = slice(st * s, st * s + st)
            joined = []
            for pl in planes:
                t = [_f32(xs[i][:, k] @ pl[k]) for i in range(3)]
                joined.append((t[2] + t[1]) + t[0])
            xc, xmask, xv = joined
            gi = min(((v1.PLANAR_WORDS * s) // g) * 32 * g // gs, G - 1)
            fold = (rss[s][:, None] * coef[G + gi] + xc * coef[gi]) + xmask * coef[2 * G + gi]
            tot, accv = tot + fold, accv + xv
        sums.append((tot, accv))
    tot, accv = sums[0]
    for t, v in sums[1:]:
        tot, accv = tot + t, accv + v
    return (tot + accv * coef[3 * G]) + coef[3 * G + 1]


def _packed_v1(oc, ic, groupsize=-1, seed=0, method="xnor", high_bits=8):
    """`tests/test_kernels.py::_packed` (bias on): JAX pack_linear of an
    element-wise mask → (JAX layer, port layer)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((oc, ic)).astype(np.float32)
    mask = np.abs(w) <= np.quantile(np.abs(w), 0.8)
    low = low_calibrate(jnp.asarray(w * mask), method, groupsize)
    high = high_calibrate(jnp.asarray(w), bits=high_bits)
    w_q = np.where(mask, np.asarray(low_quantize(jnp.asarray(w), low, method, groupsize)),
                   np.asarray(high_quantize(jnp.asarray(w), high)))
    b = jnp.asarray(rng.standard_normal(oc).astype(np.float32))
    jp, diag = jpbw.pack_linear(jnp.asarray(w_q), jnp.asarray(mask), low, high, method, groupsize,
                                bias=b)
    assert diag["pack_mismatch"] == 0.0
    return jp, packed_from_fields(jax.tree_util.tree_map(np.asarray, jp))


PLANAR_JAX = {
    "whole_row": dict(oc=256, ic=1024),
    "groups128": dict(oc=128, ic=512, groupsize=128),
    "groups128_low2_side4": dict(oc=128, ic=512, groupsize=128, method="2bit", high_bits=4),
}


@pytest.fixture(scope="module")
def planar_jax():
    """Per layer: (port layer, x, the JAX planar kernel's y in interpret mode)."""
    out = {}
    for name, kw in PLANAR_JAX.items():
        jp, tp = _packed_v1(**kw)
        x = _x(8, jp.ic, 41)
        with jax.default_matmul_precision("float32"):
            want = np.asarray(pallas_pb.pb_matmul_pallas(jnp.asarray(x), jp, interpret=True))
        out[name] = tp, x, want
    return out


@pytest.mark.parametrize("name", sorted(PLANAR_JAX))
def test_planar_tc_emulation_matches_jax_planar_kernel(planar_jax, name):
    tp, x, want = planar_jax[name]
    assert v1.use_planar(8, tp) and v1.planar_arm(tp) == "tc"
    got = _planar_tc_emulated(torch.from_numpy(x), tp)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", sorted(PLANAR_JAX))
def test_planar_tc_emulation_matches_the_plain_version(planar_jax, name):
    """Stage folds and K ranges move y by f32 roundings only: 1e-5 of max|y|."""
    tp, x, _ = planar_jax[name]
    got = _planar_tc_emulated(torch.from_numpy(x), tp)
    want = v1.pb_planar_v1_plain(torch.from_numpy(x), tp)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("kw", [dict(), dict(groupsize=128, sidecar_bits=4, low_bits=2),
                                dict(groupsize=128, low_bits=4)])
def test_planar_tc_emulation_reads_an_identity_back_bit_for_bit(kw):
    """An identity x is one exact term: its stage partials and row sums are
    exact, the other stages fold zeros, and y equals the plain version's
    bit for bit."""
    p = random_packed_v1(512, 256, torch.Generator().manual_seed(4), bias=True, **kw)
    assert len(v1.planar_ranges(p)) > 1
    x = torch.eye(512)[:255].contiguous()
    assert torch.equal(_planar_tc_emulated(x, p), v1.pb_planar_v1_plain(x, p))


def test_planar_stage_sums_add_each_stage_of_the_k_order():
    p = random_packed_v1(416, 128, torch.Generator().manual_seed(5), pack_block=416)
    x = torch.from_numpy(_x(3, 416, 6))
    sums = v1.planar_stage_sums_plain(x, p)
    order = v1.tc_x_order(416, 416)
    assert v1.PLANAR_STAGE == 128 and sums.shape == (4, 3)          # 13 words: the last stage one
    want = torch.nn.functional.pad(x[:, order].double(), (0, 96)).reshape(3, 4, 128).sum(-1).t()
    torch.testing.assert_close(sums.double(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("whole_row", dict(ic=512)),
    ("groups128_nibbles_low2", dict(ic=512, groupsize=128, sidecar_bits=4, low_bits=2)),
    ("groups128_blocks64", dict(ic=512, groupsize=128, pack_block=64)),
    ("odd_words", dict(ic=1376, low_bits=4)),                        # 43 words a block
])
def test_planar_tc_index_arithmetic_reads_the_planes(name, kw):
    """csrc/pb_planar_v1.cu's arm "tc" replayed in integers: the stage's
    group (that of its first word) holds every weight row of the stage; the code
    box of a column in a 256-column tile is its half c // 128 at c % 128; a
    stage's sign words [LOW_BITS][2][OCT] and mask words [2][OCT] are bit b
    of word W at weight row `tc_x_order`[32W + b]."""
    p = random_packed_v1(oc=256, generator=torch.Generator().manual_seed(7), **kw)
    assert v1.planar_tc_ok(p)
    ic, gs, G = p.ic_local, p.groupsize_local, p.n_groups
    g = min(ic, p.pack_block_local) // 32
    order = v1.tc_x_order(ic, p.pack_block_local)
    st = v1.PLANAR_STAGE
    for s in range(-(-ic // st)):
        gi = min(((v1.PLANAR_WORDS * s) // g) * 32 * g // gs, G - 1)
        rows = order[st * s: st * s + st]
        assert torch.equal(torch.clamp(rows // gs, max=G - 1), torch.full_like(rows, gi)), s
    col = torch.arange(256)
    half, c = col // 128, col % 128
    assert torch.equal(half * 128 + c, col)
    nwords = ic // 32
    k = torch.arange(ic)
    w, b = k // 32, k % 32
    sign = p.sign_packed.long() & 0xFFFFFFFF
    code = sum(((sign[j * nwords + w] >> b[:, None]) & 1) << j for j in range(p.low_bits))
    assert torch.equal(code.float(), v1.low_code(p.sign_packed, p.low_bits, ic,
                                                 p.pack_block_local)[order])
    mask = (p.mask_packed.long() & 0xFFFFFFFF)[w] >> b[:, None] & 1
    assert torch.equal(mask, packing.unpack_bits(p.mask_packed, ic, p.pack_block_local)[order].long())


def test_planar_tc_rule_takes_whole_stages():
    """"tc" (PLANAR_ARM) where a stage's words share a group (groups of a
    multiple of 128 rows, or one group), for every m; "cores" for groups of
    32 or 64 rows."""
    assert v1.PLANAR_ARM == "tc" and v1.PLANAR_ARMS == ("cores", "tc")
    for kw, arm in ((dict(), "tc"), (dict(groupsize=128), "tc"),
                    (dict(groupsize=128, pack_block=64), "tc"),
                    (dict(groupsize=64, pack_block=64), "cores"),
                    (dict(groupsize=32, pack_block=32), "cores")):
        p = random_packed_v1(512, 128, torch.Generator().manual_seed(0), **kw)
        assert v1.planar_arm(p) == arm, kw


@pytest.mark.parametrize("ic,oc,ks", [(2048, 2048, 8), (2048, 8192, 2), (8192, 2048, 8),
                                      (4096, 11008, 4), (512, 256, 4), (64, 128, 1),
                                      (8192, 8192, 8)])
def test_planar_ksplit_and_ranges_follow_the_shape(ic, oc, ks):
    """The K split reads the shape alone (least power of two bringing the
    128-column tiles to PLANAR_BLOCKS and the ranges to at most
    PLANAR_RANGE stages, at most 8 and the stages), not m; the ranges cut
    the stages in order."""
    p = types.SimpleNamespace(ic_local=ic, oc_local=oc)  # all the rule reads of a layer
    assert v1.planar_ksplit(p) == ks and v1.PLANAR_OC == 128
    ranges = v1.planar_ranges(p)
    assert ranges[0][0] == 0 and ranges[-1][1] == -(-ic // v1.PLANAR_STAGE) and len(ranges) == ks
    assert all(a < b for a, b in ranges) and all(r[1] == s[0] for r, s in zip(ranges, ranges[1:]))


def test_cpu_wrappers_launch_nothing():
    """On a CPU tensor the wrappers run the plain versions and count no
    launch of any arm or of the x preparation."""
    names = ("dma_launches", "dma_split_launches")
    before = {k: getattr(da, k) for k in names}
    before_prep = pm.split_prep_launches
    before_v1 = (v1.planar_launches, v1.planar_tc_launches)
    p2 = random_packed_v2(256, 128, torch.Generator().manual_seed(0))
    x2 = torch.from_numpy(_x(4, 256, 0))
    assert torch.equal(da.pb_dma_v2(x2, p2), da.pb_dma_v2_plain(x2, p2))
    da.prepare_dma(x2, p2, "split")
    p1 = random_packed_v1(256, 128, torch.Generator().manual_seed(0))
    x1 = torch.from_numpy(_x(4, 256, 1))
    assert torch.equal(v1.pb_planar_v1(x1, p1), v1.pb_planar_v1_plain(x1, p1))
    assert {k: getattr(da, k) for k in names} == before and pm.split_prep_launches == before_prep
    assert (v1.planar_launches, v1.planar_tc_launches) == before_v1
