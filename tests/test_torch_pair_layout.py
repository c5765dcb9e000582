"""The bf16 tensor-core arm's operand layout, its three-term split of x and
the pair / exact f32 arm rules, on the CPU.

The tensor-core arm of `csrc/pb_bf16_tc.cuh` (the pair kernel's "split" and
"tc" arms, the exact f32 kernel's "tc" arm) takes x in the TPU pair kernel's
order (`pallas_pb.pair_permute_x`) with each bit pair's run padded to a
multiple of 8 words and the runs' 16-value pieces grouped by word group
(`packed_matmul.tc_pair_columns`), in one bf16 term (pair, decode_dot bf16)
or three (`packed_matmul.split_terms`, exact for every finite f32).  Here:
the port's padded order, with its padding removed, equals JAX's bit for
bit, and the grouping only moves 16-value pieces; the split is exact; the
kernel's index arithmetic (word groups, bit pairs, the planes' scales in A,
the sidecar's 64-slot chunks and nibble halves), replayed in float64, gives
the products of the x it carries; the plain versions through either layout
and through the split agree with the JAX pair and f32 kernels in interpret
mode under the tolerances of `tests/test_torch_decode_arms.py` (1e-5 of
max|y|); and `pair_arm` / `f32_arm` pick by rows, low bits and layout.
"""

import dataclasses

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
from pb_llm_tpu_torch.data.synthetic import random_packed_v2
from pb_llm_tpu_torch.interop import packed_from_fields
from pb_llm_tpu_torch.models import stacking
from pb_llm_tpu_torch.ops import decode_arms as da
from pb_llm_tpu_torch.ops import packed_matmul as pm

torch.set_num_threads(2)

REL = 1e-5
PERMUTE_CASES = [(256, 256), (416, 128), (11008, 1376), (4096, 2048)]


@pytest.fixture(scope="module")
def jax_permuted():
    """JAX's pair_permute_x of one seeded f32 x per (ic, pack_block)."""
    out = {}
    for ic, pb in PERMUTE_CASES:
        x = np.random.default_rng(ic).standard_normal((3, ic)).astype(np.float32)
        out[ic, pb] = x, np.asarray(pallas_pb.pair_permute_x(jnp.asarray(x), ic, pb))
    return out


@pytest.mark.parametrize("ic,pb", PERMUTE_CASES)
def test_tc_layout_matches_jax_pair_permute_without_its_padding(jax_permuted, ic, pb):
    x, want = jax_permuted[ic, pb]
    x_aug = np.concatenate([x, np.zeros((3, 1), np.float32)], axis=1)
    padded = x_aug[:, pm.pair_padded_columns(ic, pb).numpy()]
    g8 = [-(-rows // 32 // 8) * 8 for rows in packing.block_sizes(ic, pb)]
    assert padded.shape == (3, 32 * sum(g8))
    cols = pm.pair_padded_columns(ic, pb)
    np.testing.assert_array_equal(padded[:, (cols < ic).numpy()], want)
    assert not padded[:, (cols == ic).numpy()].any()  # the padding is zeros
    tc = x_aug[:, pm.tc_pair_columns(ic, pb).numpy()]  # the arm's row: the same pieces, grouped
    assert tc.shape[1] % pm.TC_GROUP == 0
    np.testing.assert_array_equal(np.sort(tc.reshape(3, -1, 16), axis=1),
                                  np.sort(padded.reshape(3, -1, 16), axis=1))


def _sharded(side_bits):
    r = np.random.default_rng(3)
    w = r.standard_normal((128, 256)).astype(np.float32)
    mask = pbw.column_structured_mask(np.abs(w), 0.9, 0, ic_shards=2).numpy()
    maxq = 15.0 if side_bits == 4 else 255.0
    p, _ = pbw.pack_linear_v2(
        w, mask, {"mean": np.zeros((1, 128), np.float32), "scale": np.full((1, 128), 0.1, np.float32)},
        {"scale": np.full(128, 0.05, np.float32), "zero": np.full(128, maxq / 2, np.float32),
         "maxq": maxq}, "xnor", pack_block=128, ic_shards=2, k_multiple=16)
    return p


LAYERS = {
    "side8": dict(ic=256, oc=256),
    "side4": dict(ic=256, oc=256, side_bits=4),
    "rowgroups": dict(ic=256, oc=384, col_tile=128, bias=True),
    "side4_rowgroups": dict(ic=512, oc=256, col_tile=64, side_bits=4),
    "multiblock": dict(ic=416, oc=160, pack_block=128),
    "ragged": dict(ic=11008, oc=128, pack_block=1376),
}


@pytest.fixture(scope="module")
def layers():
    out = {n: random_packed_v2(generator=torch.Generator().manual_seed(1), **kw)
           for n, kw in LAYERS.items()}
    out["shards8"], out["shards4"] = _sharded(8), _sharded(4)
    return out


ALL = sorted(LAYERS) + ["shards8", "shards4"]
TC_OK = [n for n in ALL if n != "side4_rowgroups"]


def _x(m, ic, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((m, ic)).astype(np.float32))


SPLIT_CASES = {
    "normal": (-8, 8),
    "tiny": (-140, -100),
    "subnormal": (-149, -126),
    "huge": (100, 127),
    "everything": (-149, 127),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_three_term_split_is_exact(name):
    """hi + mid·2^-8 + lo·2^-16 == x exactly, each term a bf16 value, for
    f32 over the binades of the case, with ±0 and the extremes."""
    lo_e, hi_e = SPLIT_CASES[name]
    r = np.random.default_rng(len(name))
    mant = r.uniform(1.0, 2.0, 20000) * r.choice([-1.0, 1.0], 20000)
    with np.errstate(over="ignore"):
        x = (mant * np.exp2(r.integers(lo_e, hi_e + 1, 20000))).astype(np.float32)
    bits = r.integers(0, 2 ** 32, 2000, dtype=np.uint64).astype(np.uint32).view(np.float32)
    extremes = np.array([0.0, -0.0, np.finfo(np.float32).max, -np.finfo(np.float32).max,
                         np.finfo(np.float32).tiny, 2.0 ** -149, -(2.0 ** -149)], np.float32)
    x = np.concatenate([x, bits, extremes])
    x = torch.from_numpy(x[np.isfinite(x)])
    planes = pm.split_terms(x, 3)
    assert planes.dtype == torch.bfloat16 and planes.shape == (3, x.numel())
    total = planes[0].double() + planes[1].double() * 2.0 ** -8 + planes[2].double() * 2.0 ** -16
    assert torch.equal(total, x.double())
    assert torch.equal(pm.join_terms(planes), x)
    assert torch.equal(torch.signbit(planes[0]), torch.signbit(x))  # hi keeps the sign, ±0 too
    assert torch.equal(pm.split_terms(x, 1)[0], x.to(torch.bfloat16))  # one term: nearest even


def _tc_products(ops, p):
    """The kernel's two raw sums by its own index arithmetic, in float64:
    unit u < ng is word group u (values TC_GROUP·u.. of the x rows, 8 sign
    words from blk·g + 8s; bit pair p's A register ((w >> p) & 0x10001) ·
    the plane's one, against the 16 values at 16p), the rest 64-slot
    sidecar chunks (the code rows of each slot, the nibble half of its
    shard segment, the plane's scale); planes lo first.  Rows and columns
    past a tensor read as zeros.  Returns the sums of the {0, 1} planes."""
    terms, m, icp = ops.xp.shape
    sign = p.sign_packed.numpy().view(np.uint32).astype(np.int64)
    nwords, oc = sign.shape
    sign = np.concatenate([sign, np.zeros((8, oc), np.int64)])
    ic, pb = p.ic_local, p.pack_block_local
    gf, nfull = pb // 32, ic // pb
    ngf = -(-gf // 8)
    ng = nfull * ngf + -(-((ic - nfull * pb) // 32) // 8)
    assert icp == pm.TC_GROUP * ng
    xp = ops.xp.double().numpy()
    one = (2.0, 2.0 ** -7, 2.0 ** -15)
    acc_b = np.zeros((m, oc))
    for u in range(ng):
        blk = u // ngf if u < nfull * ngf else nfull
        s = u - blk * ngf
        words = sign[blk * gf + 8 * s + np.arange(8)]                # [8, oc]
        for pl in reversed(range(terms)):
            for bp in range(16):
                bits = np.stack([(words >> bp) & 1, (words >> (bp + 16)) & 1], 1)  # [8, 2, oc]
                a = bits.reshape(16, oc) * one[pl]                   # k = 2j + h
                acc_b += xp[pl, :, 256 * u + 16 * bp: 256 * u + 16 * bp + 16] @ a
    k_pad, kps = p.k_pad, p.k_pad_shard_local
    side = p.side_val.numpy().astype(np.int64)
    side = np.concatenate([side, np.zeros((k_pad + 64, oc), np.int64)])
    xgp = ops.xgp.double().numpy()                                   # [T, n_rg, m, kst]
    kst = xgp.shape[3]
    assert kst % pm.TC_SLOTS == 0 and kst - k_pad < pm.TC_SLOTS
    acc_v = np.zeros((m, oc))
    t = np.arange(oc) // p.col_tile
    scale = (1.0, 2.0 ** -8, 2.0 ** -16)
    for j in range(kst):
        if p.side_bits == 8:
            code = side[j]
        else:
            j8, half = j - j % 8, kps // 2
            sh, r = j8 // kps, j8 % kps
            v = side[sh * half + r % half + j % 8]
            code = (v >> (4 if (j % kps) >= half else 0)) & 15
        for pl in reversed(range(terms)):
            acc_v += xgp[pl][t, :, j].T * (code * scale[pl])[None, :]
    return acc_b * 0.5, acc_v


@pytest.mark.parametrize("terms", [1, 3])
@pytest.mark.parametrize("name", TC_OK)
def test_tensor_core_index_arithmetic_gives_the_products(layers, name, terms):
    p = layers[name]
    ops = pm.prepare_tc(_x(3, p.ic_local, 7), p, terms)
    acc_b, acc_v = _tc_products(ops, p)
    x = pm.tc_x(ops, p).double()
    bits = packing.unpack_bits(p.sign_packed, p.ic_local, p.pack_block_local).double()
    np.testing.assert_allclose(acc_b, (x @ bits).numpy(), rtol=1e-12, atol=1e-12)
    codes = pbw.unpack_side_codes(p.side_val, p.side_bits, p.shards_local).double()
    xg = pm.join_terms(ops.xgp)[..., :p.k_pad].double()
    group = torch.arange(p.oc_local) // p.col_tile
    want = torch.stack([xg[g] @ codes[:, c] for c, g in enumerate(group.tolist())], 1)
    np.testing.assert_allclose(acc_v, want.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ALL)
def test_plain_versions_give_the_same_bits_through_either_layout(layers, name):
    """The pair plain version on "mma" and "tc" operands, and the exact f32
    plain version on three-term "tc" operands, equal the plain versions of
    x bit for bit (the terms carry x exactly; one term is bf16(x))."""
    p = layers[name]
    x = _x(5, p.ic_local, 5)
    want = da.pb_pair_v2_plain(x, p)
    for layout in ("mma", "tc"):
        ops = da.prepare_pair(x, p, layout)
        assert ops.layout == layout
        assert torch.equal(da.pair_matmul_plain(ops, p), want), layout
    tc = da.prepare_pair(x, p, "tc")
    assert tc.xp.shape == (1, 5, pm.tc_pair_columns(p.ic_local, p.pack_block_local).numel())
    assert tc.xgp.shape[-1] % pm.TC_SLOTS == 0 and not tc.xgp[..., p.k_pad:].any()
    ops3 = pm.prepare_tc(x, p, 3)
    assert torch.equal(pm.tc_x(ops3, p), x)
    assert torch.equal(pm.tc_matmul_plain(ops3, p), pm.pb_f32_matmul_plain(x, p))
    ops1 = pm.prepare_tc(x, p, 1)
    assert torch.equal(pm.tc_matmul_plain(ops1, p), pm.pb_f32_matmul_plain(x, p, torch.bfloat16))


def _make_v2(oc, ic, col_tile=0, high_bits=8, seed=0, ic_shards=1, pack_block=None,
             k_multiple=32):
    """`tests/test_torch_decode_arms.py::_make_v2`: a JAX-packed layer →
    (JAX layer, port layer)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((oc, ic)).astype(np.float32)
    if ic_shards == 1:
        w *= (1.0 + 3.0 * (rng.random(ic) < 0.1))[None, :]
    mask = np.asarray(jpbw.column_structured_mask(jnp.abs(jnp.asarray(w)), 0.9, col_tile,
                                                  ic_shards=ic_shards))
    low = low_calibrate(jnp.asarray(w * mask), "xnor", -1)
    high = high_calibrate(jnp.asarray(w), bits=high_bits)
    w_q = np.where(mask, np.asarray(low_quantize(jnp.asarray(w), low, "xnor", -1)),
                   np.asarray(high_quantize(jnp.asarray(w), high)))
    b = jnp.asarray(rng.standard_normal(oc).astype(np.float32))
    jp, _ = jpbw.pack_linear_v2(jnp.asarray(w_q), jnp.asarray(mask), low, high, "xnor",
                                col_tile=col_tile, bias=b, ic_shards=ic_shards,
                                pack_block=pack_block, k_multiple=k_multiple)
    return jp, packed_from_fields(jp)


JAX_LAYERS = {
    "256x128": dict(oc=256, ic=128),
    "256x256_ct128": dict(oc=256, ic=256, col_tile=128),
    "128x416_side4": dict(oc=128, ic=416, high_bits=4),
    "sharded4": dict(oc=256, ic=256, ic_shards=4, pack_block=64, k_multiple=16, seed=21),
}


@pytest.fixture(scope="module")
def jax_layers():
    return {n: _make_v2(**kw) for n, kw in JAX_LAYERS.items()}


@pytest.fixture(scope="module")
def jax_outputs(jax_layers):
    """The JAX pair and f32 kernels (interpret mode) on one x per layer."""
    out = {}
    with jax.default_matmul_precision("float32"):
        for n, (jp, _) in jax_layers.items():
            x = np.random.default_rng(11).standard_normal((40, jp.ic)).astype(np.float32)
            for dot in ("pair", "f32"):
                out[n, dot] = x, np.asarray(pallas_pb.pb_matmul_pallas_v2(
                    jnp.asarray(x), jp, interpret=True, oc_tile=128, decode_dot=dot))
    return out


def _close(got, want):
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), err


@pytest.mark.parametrize("layout", ["mma", "tc"])
@pytest.mark.parametrize("name", sorted(JAX_LAYERS))
def test_pair_plain_on_either_layout_matches_jax_pair_kernel(jax_layers, jax_outputs, name,
                                                             layout):
    _, tp = jax_layers[name]
    x, want = jax_outputs[name, "pair"]
    ops = da.prepare_pair(torch.from_numpy(x), tp, layout)
    _close(da.pair_matmul_plain(ops, tp).numpy(), want)


@pytest.mark.parametrize("terms", [3, 1])
@pytest.mark.parametrize("name", sorted(JAX_LAYERS))
def test_tc_plain_through_the_split_matches_jax_kernels(jax_layers, jax_outputs, name, terms):
    """Three terms against JAX's exact f32 kernel, one against its pair
    kernel (bf16 x, the same function)."""
    _, tp = jax_layers[name]
    x, want = jax_outputs[name, "f32" if terms == 3 else "pair"]
    _close(pm.tc_matmul_plain(pm.prepare_tc(torch.from_numpy(x), tp, terms), tp).numpy(), want)


def test_pair_arm_picks_by_rows_and_layout(layers):
    """The pair rule: "tc" from PAIR_TC rows (128, set from the card's
    crossover), "split" below, where the tensor-core code takes the layout;
    "mma" otherwise."""
    assert da.PAIR_TC == 128
    p = layers["side8"]
    assert da.pair_arm(1, p) == da.pair_arm(da.PAIR_TC - 1, p) == "split"
    assert da.pair_arm(da.PAIR_TC, p) == da.pair_arm(255, p) == "tc"
    assert da.pair_arm(255, layers["rowgroups"]) == "tc"             # col_tile 128: a group a tile
    assert da.pair_arm(8, layers["side4_rowgroups"]) == "mma"        # col_tile 64 splits a tile
    assert da.pair_arm(255, layers["side4_rowgroups"]) == "mma"
    odd = random_packed_v2(256, 136, torch.Generator().manual_seed(0))
    assert da.pair_arm(8, odd) == "mma"                              # oc not a multiple of 16
    fused = pbw.merge_packed_linears_v2([random_packed_v2(4096, 4096, torch.Generator().manual_seed(s),
                                                          low_frac=0.99) for s in range(3)])
    assert fused.n_row_groups == 3 and da.pair_arm(8, fused) == "split"  # q|k|v: groups of 4096


def test_pair_ksplit_follows_the_shape_alone(layers):
    """The split arm's K ranges fill about SPLIT_BLOCKS blocks at most one
    range a unit, whatever m is (it reads no m)."""
    ragged = layers["ragged"]                        # 48 word groups + 18 sidecar chunks, 1 tile
    assert ragged.k_pad == 1120 and da.pair_ksplit(ragged) == 48 + 18
    wide = random_packed_v2(4096, 11008, torch.Generator().manual_seed(0), low_frac=0.9)
    assert da.pair_ksplit(wide) == -(-da.SPLIT_BLOCKS // 86)
    sq = random_packed_v2(4096, 4096, torch.Generator().manual_seed(0), low_frac=0.9)
    assert da.pair_ksplit(sq) == min(16 + 7, -(-da.SPLIT_BLOCKS // 32))


def test_f32_arm_picks_by_rows_low_bits_and_layout(layers):
    """The exact f32 rule: for 1-bit lows where the layout allows (col_tile
    256 qualifies) the tensor cores, "tc" from F32_TC rows (32, set from the
    card's crossover) and the dma kernel's "split" code below (dot f32; the
    CUDA cores for dot bf16 there); the CUDA cores for 2- and 4-bit lows
    and other layouts."""
    assert pm.F32_TC == 32 and pm.F32_DECODE_ARM == "split"
    p = layers["side8"]
    assert pm.f32_arm(pm.F32_TC - 1, p) == pm.f32_arm(1, p) == "split"
    assert pm.f32_arm(pm.F32_TC - 1, p, torch.bfloat16) == "cores"
    assert pm.f32_arm(pm.F32_TC, p) == pm.f32_arm(512, p) == "tc"
    ct256 = random_packed_v2(4096, 11008, torch.Generator().manual_seed(0), col_tile=256)
    assert ct256.n_row_groups == 43 and pm.f32_arm(512, ct256) == "tc"
    assert pm.f32_arm(512, layers["side4_rowgroups"]) == "cores"
    two = dataclasses.replace(p, low_bits=2, sign_packed=torch.cat([p.sign_packed] * 2))
    assert pm.f32_arm(512, two) == "cores"
    assert pm.terms_of(torch.float32) == 3 and pm.terms_of(torch.bfloat16) == 1


def test_stacked_f32_arm_follows_the_flat_rule():
    """The stacked entry takes `f32_arm` on layer li's views: m = 256 (the
    largest it serves) on the tensor cores, decode on the "split" code."""
    g = torch.Generator().manual_seed(3)
    ls = [random_packed_v2(512, 256, g, pack_block=128) for _ in range(2)]
    sp = stacking.stack_layers({"layers": [{"w": q} for q in ls]})["layers_stacked"]["w"]
    mk = stacking.StackedPackedLinearV2(sp, 1, torch.ones(1, dtype=torch.int32))
    lp = pm.stacked_layer(mk)
    assert pm.f32_arm(pm.STACKED_MAX_M, lp) == "tc" and pm.f32_arm(8, lp) == "split"
    x = _x(40, 512, 2)
    ops = pm.prepare_tc(x, lp, 3)
    assert torch.equal(pm.tc_matmul_plain(ops, lp), pm.pb_f32_matmul_stacked_plain(x, mk))


def test_cpu_wrappers_take_the_plain_versions(layers):
    """On a CPU tensor no arm launches: the wrappers run the plain versions."""
    p = layers["side8"]
    x = _x(40, p.ic_local, 9)
    before = {k: getattr(da, k) for k in ("pair_launches", "pair_split_launches", "pair_tc_launches")}
    before_f = (pm.f32_launches, pm.f32_tc_launches)
    assert torch.equal(da.pb_pair_v2(x, p), da.pb_pair_v2_plain(x, p))
    assert torch.equal(pm.pb_f32_matmul(x, p), pm.pb_f32_matmul_plain(x, p))
    assert {k: getattr(da, k) for k in before} == before
    assert (pm.f32_launches, pm.f32_tc_launches) == before_f
