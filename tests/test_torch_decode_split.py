"""The decode step's two split arms, emulated on the CPU against the JAX
package.

The int8 matmul's decode arm ("split", `csrc/pb_int8_matmul.cu`) cuts the
tensor-core arm's K stages (word groups of 8 sign words, then sidecar
chunks of 128 slots) of each 128-column tile into `int8_ksplit` ranges; a
cluster of blocks adds the ranges' int32 dots in range order and runs the
f32 epilogue.  Here: the ranges cover every stage once and follow the
layer's shape alone; the stages' integer dots, read from the arm's operand
layout by its own index arithmetic and added range by range, give the plain
version's y bit for bit, and JAX's int8 kernel's (flat and stacked, in
interpret mode) bit for bit where the epilogue is exact (integer x with
absmax 127, dyadic scales); `int8_arm` takes it below M_TC where the tensor
cores take the layout.

Strip decode attention's "split" arm cuts each slot's rows into splits of
SPLIT_ROWS, keeps a max, an exponential sum and an unnormalised P·V per
split, and merges the splits in order (`decode_attention.split_plain`).
Here: that arithmetic against JAX's `decode_attention` in interpret mode at
the JAX oracle's bounds (tests/test_decode_attention.py, test_torch_kv_arms:
5e-6 on f32 strips, 2e-2 on int8 and bf16, 5e-2 on q8) at lengths 0, 1, a
split boundary and max_seq.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.core import pbw as jpbw
from pb_llm_tpu.models import stacking as jstacking
from pb_llm_tpu.ops import pallas_pb
from pb_llm_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from pb_llm_tpu_torch.data.synthetic import random_packed_v2
from pb_llm_tpu_torch.interop import packed_from_fields
from pb_llm_tpu_torch.models import stacking
from pb_llm_tpu_torch.ops import decode_attention as tda
from pb_llm_tpu_torch.ops import packed_matmul as pm

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the int8 matmul's split arm
# ---------------------------------------------------------------------------

def _dyadic_layer(oc, ic, col_tile=0, side_bits=8, pack_block=0, seed=0):
    """A JAX-packed PBW-v2 layer whose scales, means and zero points are
    dyadic, so that at integer x with absmax 127 (sx = 1) every term of the
    int8 epilogue is exact in f32, whatever the order or FMA contraction."""
    r = np.random.default_rng(seed)
    w = r.standard_normal((oc, ic)).astype(np.float32)
    mask = np.asarray(jpbw.column_structured_mask(jnp.abs(jnp.asarray(w)), 0.9, col_tile))
    maxq = 15.0 if side_bits == 4 else 255.0
    low = {"mean": jnp.full((1, oc), 0.25, jnp.float32), "scale": jnp.full((1, oc), 0.125, jnp.float32)}
    high = {"scale": jnp.full((oc,), 0.0625, jnp.float32),
            "zero": jnp.full((oc,), 8.0 if side_bits == 4 else 128.0, jnp.float32),
            "maxq": maxq}
    kw = dict(pack_block=pack_block) if pack_block else {}
    jp, _ = jpbw.pack_linear_v2(jnp.asarray(w), jnp.asarray(mask), low, high, "xnor",
                                col_tile=col_tile, bias=jnp.full((oc,), 0.5, jnp.float32), **kw)
    return jp, packed_from_fields(jp)


# every tensor-core layout kind: 8-bit and nibble sidecars, row groups of
# one tile, several pack blocks, a ragged last block; "refused": row groups
# of 64 columns split a 128-column tile (the dp4a arm takes it)
SPLIT_LAYERS = {
    "side8": dict(oc=256, ic=256),
    "side4": dict(oc=256, ic=256, side_bits=4),
    "rowgroups": dict(oc=384, ic=256, col_tile=128),
    "side4_rowgroups": dict(oc=256, ic=512, col_tile=128, side_bits=4),
    "multiblock": dict(oc=128, ic=416, pack_block=128),
    "ragged": dict(oc=128, ic=1376 + 352, pack_block=1376),
}


@pytest.fixture(scope="module")
def dyadic():
    out = {n: _dyadic_layer(**kw) for n, kw in SPLIT_LAYERS.items()}
    out["refused"] = _dyadic_layer(256, 256, col_tile=64)
    return out


def _unit_x(m, ic, seed):
    """Integer x with every row's absmax 127: sx = 1, exact row sums."""
    x = np.random.default_rng(seed).integers(-127, 128, size=(m, ic)).astype(np.float32)
    x[:, 0] = 127.0
    return x


def _stage_dots(ops, p, st, m):
    """Stage st's integer dots in the split arm's operand layout, by the
    kernel's index arithmetic (`tc_stages`' order: word group st is bytes
    256st.. of x8's rows against 8 sign-word rows from blk*g + 8s, bit b's
    A register (word >> b) & 0x01010101 against the run's 32 bytes at 32b;
    then sidecar chunk st - groups: slots 128c.. of xg8 against their code
    rows, xor 0x80 for 8-bit codes, the nibble half of the shard segment for
    4-bit ones).  Rows and columns past a tensor read as zeros."""
    groups, _ = pm.tc_stages(p)
    sign = p.sign_packed.numpy().view(np.uint32).astype(np.int64)
    oc = sign.shape[1]
    ic, pb = p.ic_local, p.pack_block_local
    acc_b = np.zeros((m, oc), np.int64)
    acc_v = np.zeros((m, oc), np.int64)
    if st < groups:
        gf, nfull = pb // 32, ic // pb
        ngf = -(-gf // 8)
        blk = st // ngf if st < nfull * ngf else nfull
        s = st - blk * ngf
        rows = blk * gf + 8 * s + np.arange(8)
        words = np.where((rows < sign.shape[0])[:, None], sign[np.minimum(rows, sign.shape[0] - 1)], 0)
        x8 = ops.x8.numpy().astype(np.int64)
        for b in range(8):
            xs = x8[:, 256 * st + 32 * b: 256 * st + 32 * b + 32]       # [m, 32]
            a = (words >> b) & 0x01010101
            abytes = np.stack([(a >> (8 * j)) & 0xFF for j in range(4)], 1).reshape(32, oc)
            acc_b += xs @ abytes
        return acc_b, acc_v
    k_pad, kps = p.k_pad, p.k_pad_shard_local
    side = p.side_val.numpy().astype(np.int64)
    xg8 = ops.xg8.numpy().astype(np.int64)
    t = np.arange(oc) // p.col_tile
    j0 = (st - groups) * pm.SPLIT_SK
    for j in range(j0, min(j0 + pm.SPLIT_SK, xg8.shape[2])):  # slots past kst: zeros
        if p.side_bits == 8:
            code = (side[j] ^ 0x80).astype(np.int8).astype(np.int64) if j < side.shape[0] else 0
        else:
            sh, r, half = j // kps, j % kps, kps // 2
            row = sh * half + r % half
            v = side[row] if row < side.shape[0] else np.zeros(oc, np.int64)
            code = (v >> (4 if r >= half else 0)) & 15
        acc_v += xg8[t, :, j].T * code
    return acc_b, acc_v


def _split_y(ops, p, m):
    """The split arm's y: each range's stage dots, the ranges added in
    order (each sum within int32), the plain version's f32 epilogue."""
    acc_b = np.zeros((m, p.oc_local), np.int64)
    acc_v = np.zeros_like(acc_b)
    for s0, s1 in pm.int8_ranges(p):
        rb, rv = np.zeros_like(acc_b), np.zeros_like(acc_v)
        for st in range(s0, s1):
            b, v = _stage_dots(ops, p, st, m)
            rb, rv = rb + b, rv + v
        acc_b, acc_v = acc_b + rb, acc_v + rv
        assert np.abs(acc_b).max() < 2 ** 31 and np.abs(acc_v).max() < 2 ** 31
    return pm._epilogue(torch.from_numpy(acc_b).float(), torch.from_numpy(acc_v).float(), ops, p)


@pytest.mark.parametrize("ic,oc,pack_block,stages,ks", [
    (4096, 4096, 2048, (16, 4), 8),      # llama-7b q/k/v/o: 32 tiles
    (4096, 11008, 2048, (16, 4), 4),     # gate/up: 86 tiles
    (11008, 4096, 1376, (48, 9), 8),     # down: 1376-row blocks of 43 words, 6 groups each
    (256, 256, 256, (1, 1), 2),          # two stages: two ranges of one
    (256, 128, 256, (1, 1), 2),
])
def test_int8_ranges_cover_every_stage_once_by_shape(ic, oc, pack_block, stages, ks):
    """The ranges are contiguous, cover stages 0..n-1 once, number a power
    of two up to 8 (a portable cluster) with at least one stage each, and
    come from the layer's shape alone: layers of the same shape drawn from
    other seeds give the same ranges."""
    layers = [random_packed_v2(ic, oc, torch.Generator().manual_seed(s), low_frac=0.9,
                               pack_block=pack_block) for s in (0, 1)]
    p = layers[0]
    assert pm.tc_stages(p) == stages and pm.int8_ksplit(p) == ks
    ranges = pm.int8_ranges(p)
    assert ranges == pm.int8_ranges(layers[1]) and len(ranges) == ks
    assert ranges[0][0] == 0 and ranges[-1][1] == sum(stages)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(s1 > s0 for s0, s1 in ranges)
    tiles = -(-oc // pm.TC_OC)
    assert ks == 8 or ks * tiles >= pm.SPLIT_BLOCKS or 2 * ks > sum(stages)


@pytest.mark.parametrize("name", sorted(SPLIT_LAYERS))
@pytest.mark.parametrize("m", [1, 8, 15])
def test_split_emulation_equals_the_plain_version_bit_for_bit(dyadic, name, m):
    """Random x (not at unit scale): the split arm's range-by-range integer
    dots give the plain version's y bit for bit."""
    _, p = dyadic[name]
    x = torch.from_numpy(np.random.default_rng(m).standard_normal((m, p.ic_local)).astype(np.float32))
    ops = pm.prepare_int8_plain(x, p, pm.layout_of("split"))
    assert torch.equal(_split_y(ops, p, m), pm.int8_matmul_plain(ops, p))


@pytest.mark.parametrize("name", sorted(SPLIT_LAYERS))
@pytest.mark.parametrize("m", [1, 8])
def test_split_emulation_equals_jax_int8_kernel_bit_for_bit(dyadic, name, m):
    jp, p = dyadic[name]
    x = _unit_x(m, p.ic_local, seed=m)
    ops = pm.prepare_int8_plain(torch.from_numpy(x), p, "tc")
    assert float(ops.sx.max()) == float(ops.sx.min()) == 1.0
    with jax.default_matmul_precision("float32"):
        want = np.asarray(pallas_pb.pb_matmul_pallas_v2(
            jnp.asarray(x), jp, interpret=True, decode_dot="int8"))
    np.testing.assert_array_equal(_split_y(ops, p, m).numpy(), want)


@pytest.mark.parametrize("side_bits", [8, 4])
def test_split_emulation_equals_jax_stacked_kernel_bit_for_bit(side_bits):
    """Layer li of a JAX-stacked pair of dyadic layers: JAX's stacked int8
    kernel (interpret mode) against the split arm's emulation on the port's
    views of the same layer."""
    layers = [_dyadic_layer(256, 512, side_bits=side_bits, seed=s) for s in (3, 4)]
    jsp = jstacking.stack_layers({"layers": [{"w": jp} for jp, _ in layers]})["layers_stacked"]["w"]
    tsp = stacking.stack_layers({"layers": [{"w": tp} for _, tp in layers]})["layers_stacked"]["w"]
    assert pm.stacked_supported_v2(tsp)
    x = _unit_x(8, 512, seed=side_bits)
    for li in range(2):
        mk = stacking.StackedPackedLinearV2(tsp, li, torch.tensor([li], dtype=torch.int32))
        p = pm.stacked_layer(mk)
        assert pm.int8_arm(8, p) == "split"
        ops = pm.prepare_int8_plain(torch.from_numpy(x), p, "tc")
        with jax.default_matmul_precision("float32"):
            want = np.asarray(pallas_pb.pb_matmul_pallas_v2_stacked(
                jnp.asarray(x), jsp, jnp.int32(li), interpret=True, decode_dot="int8"))
        np.testing.assert_array_equal(_split_y(ops, p, 8).numpy(), want)


def test_int8_arm_takes_split_below_m_tc_where_the_tensor_cores_take_the_layout(dyadic):
    """The rule: "split" (DECODE_ARM) for 1..M_TC-1 rows, "tc" from M_TC,
    on every tensor-core layout; the refused layout (64-column row groups:
    a 128-column tile would span two groups) takes "dp4a" at every m, and
    its operands cannot launch the split arm."""
    for name in SPLIT_LAYERS:
        p = dyadic[name][1]
        assert pm.tc_layout_ok(p), name
        assert {pm.int8_arm(m, p) for m in range(1, pm.M_TC)} == {"split"}
        assert pm.int8_arm(pm.M_TC, p) == "tc"
    p = dyadic["refused"][1]
    assert not pm.tc_layout_ok(p)
    assert {pm.int8_arm(m, p) for m in (1, 8, 15, 16, 512)} == {"dp4a"}
    ops = pm.prepare_int8_plain(torch.zeros((8, p.ic_local)), p, "tc")
    with pytest.raises(ValueError, match="does not take"):
        pm.launch_int8(ops, p, "split")
    assert pm.layout_of("split") == pm.layout_of("tc") == "tc" and pm.layout_of("dp4a") == "dp4a"
    with pytest.raises(ValueError, match="unknown int8 arm"):
        pm.layout_of("mma")


# ---------------------------------------------------------------------------
# strip decode attention's split arm
# ---------------------------------------------------------------------------

def _quant(x):
    sc = np.maximum(np.abs(x).max(-1, keepdims=True) / 127.0, 1e-8).astype(np.float32)
    return np.clip(np.round(x / sc), -127, 127).astype(np.int8), sc


# S = 128 (max_seq), splits of 64 rows: empty, one row, one split, a split
# boundary either side, max_seq
ATTN_LENGTHS = np.array([0, 1, 64, 65, 127, 128], np.int32)
ATTN_TOL = {"f32": 5e-6, "bf16": 2e-2, "int8": 2e-2, "q8": 5e-2}


@pytest.fixture(scope="module")
def attn_cases():
    """Per arm: the inputs (numpy) and JAX's output in interpret mode."""
    B, S, Hq, Hkv, D = len(ATTN_LENGTHS), 128, 8, 2, 64
    r = np.random.default_rng(11)
    q = r.standard_normal((B, Hq, D)).astype(np.float32)
    k = r.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = r.standard_normal((B, S, Hkv, D)).astype(np.float32)
    (ki, ks), (vi, vs) = _quant(k), _quant(v)
    out = {}
    for arm in ATTN_TOL:
        if arm == "f32":
            inputs, kw = (k, v), {}
        elif arm == "bf16":
            inputs, kw = (k, v), {}
        else:
            inputs, kw = (ki, vi), dict(k_scale=ks, v_scale=vs)
        jk, jv = (jnp.asarray(t) for t in inputs)
        if arm == "bf16":
            jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        want = np.asarray(jax_decode_attention(
            jnp.asarray(q), jk, jv, jnp.asarray(ATTN_LENGTHS), 0.125, block_s=32,
            interpret=True, q_int8=arm == "q8", **{n: jnp.asarray(t) for n, t in kw.items()}))
        out[arm] = q, inputs, kw, want
    return out


@pytest.mark.parametrize("arm", sorted(ATTN_TOL))
def test_split_attention_matches_jax_kernel(attn_cases, arm):
    q, (k, v), kw, want = attn_cases[arm]
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if arm == "bf16":
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    tkw = {n: torch.from_numpy(t) for n, t in kw.items()}
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(ATTN_LENGTHS), 0.125)
    got = tda.split_plain(*args, **tkw, q_int8=arm == "q8")
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL[arm])
    assert not got[0].any()  # the empty slot
    # the two plain forms of the kernel's function: one softmax, or splits merged
    plain = tda.decode_attention_plain(*args, **tkw, q_int8=arm == "q8")
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6)


def test_split_count_follows_max_seq_not_lengths():
    """The split arm's grid: ceil(max_seq / SPLIT_ROWS) splits whatever the
    lengths are (a captured step's grid holds for every length); a split
    holds rows only up to its slot's length."""
    assert tda.SPLIT_ROWS == 64 and tda.ARMS == ("split", "slot")
    for s, n in ((128, 2), (2048, 32), (100, 2), (64, 1)):
        assert -(-s // tda.SPLIT_ROWS) == n
    q = torch.randn(1, 2, 16)
    kv = torch.randn(1, 130, 2, 16)
    for n in (0, 1, 64, 65, 130):
        lens = torch.tensor([n])
        torch.testing.assert_close(tda.split_plain(q, kv, kv, lens, 0.25),
                                   tda.decode_attention_plain(q, kv, kv, lens, 0.25),
                                   rtol=1e-5, atol=1e-6)
