"""The int8 matmul's tensor-core operand layout and its arm choice, on the CPU.

The tensor-core arm of `csrc/pb_int8_matmul.cu` takes x8 in the TPU
kernel's byte order (`pallas_pb.byte_permute_x`) with each bit run padded
to a multiple of 8 words and the runs' 32-byte pieces grouped by word group
(`packed_matmul.tc_x_columns`), and xg8 padded to a multiple of 32 slots.
Here: the port's permutation, with its padding removed, equals JAX's bit for
bit, and the grouping only moves 32-byte pieces;
the plain version gives the same bits on either layout; the kernel's index
arithmetic (word groups, padded runs, the sidecar gather with its nibble
halves), replayed in integers, gives the plain version's integer dots
exactly; and `int8_arm` picks the arm by rows and layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu.ops import pallas_pb
from pb_llm_tpu_torch.core import packing, pbw
from pb_llm_tpu_torch.data.synthetic import random_packed_v2
from pb_llm_tpu_torch.ops import packed_matmul as pm

torch.set_num_threads(2)

PERMUTE_CASES = [(256, 256), (416, 128), (11008, 1376), (4096, 2048)]


@pytest.fixture(scope="module")
def jax_permuted():
    """JAX's byte_permute_x of one seeded int8 x per (ic, pack_block)."""
    out = {}
    for ic, pb in PERMUTE_CASES:
        x = np.random.default_rng(ic).integers(-127, 128, size=(3, ic)).astype(np.int8)
        out[ic, pb] = x, np.asarray(pallas_pb.byte_permute_x(jnp.asarray(x), ic, pb))
    return out


@pytest.mark.parametrize("ic,pb", PERMUTE_CASES)
def test_byte_permute_x_matches_jax_without_its_padding(jax_permuted, ic, pb):
    x, want = jax_permuted[ic, pb]
    got = pm.byte_permute_x(torch.from_numpy(x), ic, pb)
    cols = pm.padded_columns(ic, pb)
    g8 = [-(-rows // 32 // 8) * 8 for rows in packing.block_sizes(ic, pb)]
    assert got.shape == (3, 32 * sum(g8))
    np.testing.assert_array_equal(got[:, cols < ic].numpy(), want)
    assert not got[:, cols == ic].any()  # the padding is zeros
    tc = pm.group_runs(got, ic, pb)  # the arm's row: the same 32-byte pieces, grouped
    x_aug = torch.cat([torch.from_numpy(x), torch.zeros((3, 1), dtype=torch.int8)], dim=1)
    assert torch.equal(tc, x_aug[:, pm.tc_x_columns(ic, pb)])
    assert torch.equal(tc.reshape(3, -1, 32).sort(dim=1).values,
                       got.reshape(3, -1, 32).sort(dim=1).values)
    assert torch.equal(pm._from_tc_x(tc, ic, pb), torch.from_numpy(x))


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


@pytest.mark.parametrize("name", ALL)
def test_plain_version_gives_the_same_bits_on_either_layout(layers, name):
    p = layers[name]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((5, p.ic_local)).astype(np.float32))
    nat = pm.prepare_int8_plain(x, p)
    tc = pm.prepare_int8_plain(x, p, "tc")
    assert tc.layout == "tc" and nat.layout == "dp4a"
    pb = p.pack_block_local
    assert tc.x8.shape == (5, pm.tc_x_columns(p.ic_local, pb).numel())
    assert tc.xg8.shape[2] % 32 == 0 and not tc.xg8[..., p.k_pad:].any()
    assert torch.equal(tc.x8, pm.group_runs(pm.byte_permute_x(nat.x8, p.ic_local, pb),
                                            p.ic_local, pb))
    assert torch.equal(pm.to_layout(tc, p, "dp4a").x8, nat.x8)
    assert torch.equal(pm.int8_matmul_plain(tc, p), pm.int8_matmul_plain(nat, p))
    assert torch.equal(pm.prepare_int8(x, p, "tc").x8, tc.x8)  # the CPU wrapper


def _tc_dots(ops, p, m):
    """The tensor-core kernel's integer dots, by its own index arithmetic
    (the stages' TMA coordinates; rows and columns past a tensor read as
    zeros): word group st is bytes 256st.. of the x rows and 8 word rows
    from blk*g + 8s; for bit b the A register (word >> b) & 0x01010101
    against the run's 32 bytes at 32b; the sidecar in stages of 128 slots,
    its code rows per slot (xor 0x80, or the nibble half of the shard
    segment, 8 packed rows a box) against xg8, padded to 32 slots."""
    sign = p.sign_packed.numpy().view(np.uint32).astype(np.int64)
    nwords, oc = sign.shape
    sign = np.concatenate([sign, np.zeros((8, oc), np.int64)])    # rows past: zeros
    ic, pb = p.ic_local, p.pack_block_local
    gf, nfull = pb // 32, ic // pb
    gl = (ic - nfull * pb) // 32
    g8f, g8l = -(-gf // 8) * 8, -(-gl // 8) * 8
    ng = nfull * (g8f // 8) + g8l // 8
    x8 = ops.x8.numpy().astype(np.int64)
    assert x8.shape == (m, 256 * ng)
    acc_b = np.zeros((m, oc), np.int64)
    for st in range(ng):
        blk = st // (g8f // 8) if st < nfull * (g8f // 8) else nfull
        s = st - blk * (g8f // 8)
        words = sign[blk * gf + 8 * s + np.arange(8)]                  # [8, oc]
        for b in range(8):
            xs = x8[:, 256 * st + 32 * b: 256 * st + 32 * b + 32]       # [m, 32]
            a = (words >> b) & 0x01010101
            abytes = np.stack([(a >> (8 * j)) & 0xFF for j in range(4)], 1).reshape(32, oc)
            acc_b += xs @ abytes
    k_pad, kps = p.k_pad, p.k_pad_shard_local
    side = p.side_val.numpy().astype(np.int64)
    side = np.concatenate([side, np.zeros((k_pad + 128, oc), np.int64)])  # rows past: zeros
    xg8 = ops.xg8.numpy().astype(np.int64)
    kst = xg8.shape[2]
    assert kst == -(-k_pad // 32) * 32
    acc_v = np.zeros_like(acc_b)
    t = np.arange(oc) // p.col_tile
    for j in range(-(-kst // 128) * 128):  # whole stages; slots past kst: zeros
        if p.side_bits == 8:
            code = (side[j] ^ 0x80).astype(np.int8).astype(np.int64)
        else:
            j8, half = j - j % 8, kps // 2
            sh, r = j8 // kps, j8 % kps
            v = side[sh * half + r % half + j % 8]
            code = (v >> (4 if (j % kps) >= half else 0)) & 15
        if j < kst:
            acc_v += xg8[t, :, j].T * code[None, :]
    return acc_b, acc_v


@pytest.mark.parametrize("name", ALL)
def test_tensor_core_index_arithmetic_gives_the_exact_dots(layers, name):
    p = layers[name]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((3, p.ic_local)).astype(np.float32))
    ops = pm.prepare_int8_plain(x, p, "tc")
    acc_b, acc_v = _tc_dots(ops, p, 3)
    nat = pm.prepare_int8_plain(x, p)
    bits = packing.unpack_bits(p.sign_packed, p.ic_local, p.pack_block_local).long()
    np.testing.assert_array_equal(acc_b, (nat.x8.long() @ bits).numpy())
    codes = pbw.unpack_side_codes(p.side_val, p.side_bits, p.shards_local).long()
    if p.side_bits == 8:
        codes = codes - 128
    group = torch.arange(p.oc_local) // p.col_tile
    want = torch.stack([nat.xg8[g].long() @ codes[:, c] for c, g in enumerate(group.tolist())], 1)
    np.testing.assert_array_equal(acc_v, want.numpy())


def test_int8_arm_picks_by_rows_and_layout(layers):
    """The arm rule: where the layout allows, the tensor cores from M_TC
    rows (16, set from the card's crossover) and below it DECODE_ARM (the
    arm the graphed decode step ran faster: the tensor cores' K-split arm);
    the dp4a arm otherwise."""
    assert pm.M_TC == 16 and pm.DECODE_ARM == "split"
    p = layers["side8"]
    assert pm.int8_arm(1, p) == pm.int8_arm(pm.M_TC - 1, p) == "split"
    assert pm.int8_arm(pm.M_TC, p) == pm.int8_arm(1024, p) == "tc"
    assert pm.int8_arm(1024, layers["rowgroups"]) == "tc"       # col_tile 128: one group a tile
    assert pm.int8_arm(1024, layers["side4_rowgroups"]) == "dp4a"  # col_tile 64 splits a tile
    assert pm.int8_arm(8, layers["side4_rowgroups"]) == "dp4a"
    odd = random_packed_v2(256, 136, torch.Generator().manual_seed(0))
    assert pm.int8_arm(1024, odd) == pm.int8_arm(8, odd) == "dp4a"  # oc not a multiple of 16
    assert pm.tc_layout_ok(layers["multiblock"]) and pm.tc_layout_ok(layers["ragged"])


def test_a_layout_the_tensor_cores_cannot_take_raises(layers):
    """Operands laid out for the tensor cores on a layout the arm does not
    take raise before anything launches: no silent fallback."""
    p = layers["side4_rowgroups"]
    ops = pm.prepare_int8_plain(torch.zeros((4, p.ic_local)), p, "tc")
    with pytest.raises(ValueError, match="tensor-core arm does not take"):
        pm.launch_int8(ops, p)
    with pytest.raises(ValueError, match="unknown layout"):
        pm.prepare_int8(torch.zeros((4, p.ic_local)), p, "permuted")
