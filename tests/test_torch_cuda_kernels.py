"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so every test here carries the `cuda` marker
and skips without a card.  The file imports no JAX (the machine with the
card has none), so it runs there without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the int8 matmul accumulates exactly in int32 and its f32
epilogue rounds once per operation in the plain version's order, so the two
agree bit for bit; so does the dequant kernel (one rounded multiply and add
per value).  Decode attention sums in another order than the plain version
(online softmax over warps): rtol 1e-4, atol 1e-5, on every arm (bf16
strips widen each element to f32 as the plain version does; the q8 arm's
scores are exact int32 dots on both sides, and a test reads them back
exactly at unit scales).  The exact f32 matmul
and flash attention sum their products in another order than the plain
versions' torch.matmul: rtol 1e-4, atol 1e-4, the JAX package's bounds for
those kernels.  Paged attention, like decode attention, sums its online
softmax in another order: rtol 1e-4, atol 1e-5.  The PBW-v1 planar and
select kernels sum their products in another order than the plain
versions' torch.matmul: rtol 1e-4, atol 1e-4 (the JAX package's bound for
its f32 kernels), on both select arms (the tensor-core arm's f32 dot takes
x and w in three bf16 terms each, six products); the select kernel's bf16
dot keeps the same bound, since a product of two bf16 values is exact in
f32 and only the f32 summation order differs.  Flash attention's
tensor-core arm keeps the CUDA-core arm's bounds (q and k in three bf16
terms, p and v in two).  Each tensor-core arm's first launch writes its
bf16 terms bit for bit as their plain version.  The pair kernel rounds x and xg to bf16 as its plain
version does, the products are exact in f32 and only the f32 summation
order differs: 1e-5 of max|y|.  The dma and stacked f32 kernels sum in
another order than the plain version: rtol 1e-4, atol 1e-4.  The stacked
int8 kernel, like the flat one, equals its plain version on the same
operands bit for bit, and each stacked kernel equals its flat kernel bit
for bit on the same layer (the same device code and tiling).  The int8
kernel's arms (dp4a, the tensor cores, and their K-split decode arm
"split") sum the same integers exactly and share the epilogue, so they
equal each other bit for bit on the same operands, each in its layout.
Decode attention's two kernel arms ("split", "slot") keep its bounds; the
split arm, captured in a CUDA graph and replayed with new lengths, equals
an eager launch bit for bit (its merge adds the splits in a fixed order).  The
x-preparation kernel's codes and scales equal its plain version's bit for
bit (IEEE division, rounding half to even); its row sums (f64, rounded
once) lie within `packed_matmul.sum_bound` of the plain f32 sums, and x
through both kernels within 1e-6 of max|y| of the plain versions
(chip_smoke.py's MATMUL_TOL).  Paged attention's tensor-core window arm keeps rtol =
atol = 2e-5 (the JAX oracle's bound) and the CUDA-core arm's rtol 1e-4,
atol 1e-5.  The graphed decode step and the graphed strip prefill equal
the eager ones bit for bit (the same kernels on the same inputs).
"""

import contextlib

import numpy as np
import pytest
import torch

from pb_llm_tpu_torch.core import pbw
from pb_llm_tpu_torch.data.synthetic import random_packed_v2
from pb_llm_tpu_torch.ops import decode_attention as tda
from pb_llm_tpu_torch.ops import flash_attention as tfa
from pb_llm_tpu_torch.ops import packed_matmul, prefill

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _sharded_layer(ic, oc, side_bits, shards, seed):
    """A shard-major sidecar layout, packed by the port's own packer."""
    r = np.random.default_rng(seed)
    w = r.standard_normal((oc, ic)).astype(np.float32)
    mask = pbw.column_structured_mask(np.abs(w), 0.9, 0, ic_shards=shards).numpy()
    low = {"mean": np.zeros((1, oc), np.float32), "scale": np.full((1, oc), 0.1, np.float32)}
    maxq = 15.0 if side_bits == 4 else 255.0
    high = {"scale": np.full(oc, 0.05, np.float32), "zero": np.full(oc, maxq / 2, np.float32),
            "maxq": maxq}
    p, _ = pbw.pack_linear_v2(w, mask, low, high, "xnor", pack_block=ic // shards,
                              ic_shards=shards, k_multiple=16)
    return p


LAYERS = {
    "side8": dict(ic=256, oc=256),
    "side4": dict(ic=256, oc=256, side_bits=4),
    "rowgroups": dict(ic=256, oc=384, col_tile=128, bias=True),
    "side4_rowgroups": dict(ic=512, oc=256, col_tile=64, side_bits=4),
    "multiblock": dict(ic=416, oc=160, pack_block=128),
}


def _layer(name, dev):
    if name.startswith("shards"):
        return _sharded_layer(256, 128, 4 if name.endswith("4") else 8, 2, seed=3).to(dev)
    return random_packed_v2(generator=torch.Generator(device=dev).manual_seed(1), **LAYERS[name])


# rows of x: decode, both sides of the arms' crossover M_TC, prefill
INT8_MS = sorted({1, 8, packed_matmul.M_TC - 1, packed_matmul.M_TC, 256, 300, 513, 1024})
_ARM_COUNTER = {"dp4a": "launches", "tc": "tc_launches", "split": "split_launches"}


def _arms_for(p, m):
    """The int8 arms that take layout ``p`` at ``m`` rows."""
    return [a for a in packed_matmul.ARMS
            if (a == "dp4a" or packed_matmul.tc_layout_ok(p))
            and (a != "split" or m <= packed_matmul.SPLIT_MAX_M)]


def _int8_arms_agree(p, x):
    """The flat kernel through the arm `int8_arm` picks (one launch of that
    arm), against the plain version on the same operands bit for bit, and
    every other arm that takes the layout and the rows on the same operands
    (moved to its layout) bit for bit.  Returns the kernel's y."""
    arm = packed_matmul.int8_arm(x.shape[0], p)
    counter = _ARM_COUNTER[arm]
    before = getattr(packed_matmul, counter)
    got = packed_matmul.pb_int8_matmul(x, p)
    torch.cuda.synchronize()
    assert getattr(packed_matmul, counter) == before + 1, arm
    ops = packed_matmul.prepare_int8(x, p, packed_matmul.layout_of(arm))
    plain = packed_matmul.int8_matmul_plain(ops, p)
    assert torch.equal(got, plain), (got - plain).abs().max()
    for other in _arms_for(p, x.shape[0]):
        y = packed_matmul.launch_int8(
            packed_matmul.to_layout(ops, p, packed_matmul.layout_of(other)), p, other)
        assert torch.equal(y, got), (other, (y - got).abs().max())
    want = packed_matmul.pb_int8_matmul_plain(x, p)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LAYERS) + ["shards8", "shards4"])
@pytest.mark.parametrize("m", INT8_MS)
def test_int8_matmul_kernel_matches_plain(cuda, name, m):
    p = _layer(name, cuda)
    x = torch.randn((m, p.ic), generator=torch.Generator(device=cuda).manual_seed(m), device=cuda)
    _int8_arms_agree(p, x)


@pytest.mark.cuda
def test_int8_matmul_tensor_cores_at_llama_ragged_pack_block(cuda):
    """llama-7b's ic = 11008 packs in blocks of 1376 (g = 43 words, bit runs
    padded to 48): the tensor-core arm at prefill rows, bit for bit."""
    p = random_packed_v2(11008, 128, torch.Generator(device=cuda).manual_seed(9),
                         pack_block=1376)
    assert packed_matmul.int8_arm(300, p) == "tc"
    x = torch.randn((300, 11008), generator=torch.Generator(device=cuda).manual_seed(3),
                    device=cuda)
    _int8_arms_agree(p, x)


_LLAMA_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
_llama_cache = {}


def _llama_stack(ic, oc, side_bits):
    """Two random llama-7b-width layers (low_frac 0.9) and their stacked
    markers, on the card, made once per module."""
    from pb_llm_tpu_torch.models import stacking

    key = (ic, oc, side_bits)
    if key not in _llama_cache:
        g = torch.Generator(device="cuda").manual_seed(ic + oc + side_bits)
        layers = [random_packed_v2(ic, oc, g, low_frac=0.9, side_bits=side_bits) for _ in range(2)]
        sp = stacking.stack_layers({"layers": [{"w": p} for p in layers]})["layers_stacked"]["w"]
        idx = torch.arange(2, dtype=torch.int32, device="cuda")
        _llama_cache.clear()  # one shape at a time on the card
        _llama_cache[key] = layers, [stacking.StackedPackedLinearV2(sp, li, idx[li:li + 1])
                                     for li in range(2)]
    return _llama_cache[key]


@pytest.mark.cuda
@pytest.mark.parametrize("ic,oc", _LLAMA_SHAPES)
@pytest.mark.parametrize("side_bits", [8, 4])
@pytest.mark.parametrize("m", range(1, packed_matmul.SPLIT_MAX_M))
def test_int8_split_arm_at_llama_width_is_bit_exact(cuda, ic, oc, side_bits, m):
    """The decode arm ("split": the tensor cores with the K split of
    `int8_ksplit` over a cluster) at m = 1..15 on llama-7b's three shapes:
    flat and stacked (layer 1 of 2), 8-bit and nibble sidecars, bit for bit
    with the plain version and with the dp4a arm on the same operands."""
    layers, markers = _llama_stack(ic, oc, side_bits)
    p, mk = layers[1], markers[1]
    x = torch.randn((m, ic), generator=torch.Generator(device=cuda).manual_seed(m), device=cuda)
    ops = packed_matmul.prepare_int8(x, p, "tc")
    before = (packed_matmul.split_launches, packed_matmul.stacked_split_launches)
    got = packed_matmul.launch_int8(ops, p, "split")
    stacked = packed_matmul.launch_int8_stacked(ops, mk, "split")
    dp4a = packed_matmul.launch_int8(packed_matmul.to_layout(ops, p, "dp4a"), p, "dp4a")
    torch.cuda.synchronize()
    assert (packed_matmul.split_launches, packed_matmul.stacked_split_launches) == (
        before[0] + 1, before[1] + 1)
    plain = packed_matmul.int8_matmul_plain(ops, p)
    assert torch.equal(got, plain), (got - plain).abs().max()
    assert torch.equal(stacked, got) and torch.equal(dp4a, got)


@pytest.mark.cuda
def test_int8_split_arm_refuses_what_it_cannot_take(cuda):
    """More rows than its tile, operands in the dp4a layout, a layout the
    tensor cores do not take: each raises before anything launches."""
    p = _layer("side8", cuda)
    x = torch.randn((packed_matmul.SPLIT_MAX_M + 1, p.ic), device=cuda)
    with pytest.raises(ValueError, match="at most"):
        packed_matmul.launch_int8(packed_matmul.prepare_int8(x, p, "tc"), p, "split")
    with pytest.raises(ValueError, match="layout"):
        packed_matmul.launch_int8(packed_matmul.prepare_int8(x[:8], p, "dp4a"), p, "split")
    q = _layer("side4_rowgroups", cuda)
    assert packed_matmul.int8_arm(8, q) == "dp4a"
    with pytest.raises(ValueError, match="does not take"):
        packed_matmul.launch_int8(packed_matmul.prepare_int8(
            torch.randn((8, q.ic), device=cuda), q, "tc"), q, "split")


@pytest.mark.cuda
def test_int8_matmul_kernel_matches_dense_at_unit_scale(cuda):
    """Integer x with absmax 127 per row: the int8 path is exact, so it
    equals x @ dequantize_v2(p) up to f32 rounding."""
    p = _layer("side8", cuda)
    x = torch.randint(-127, 128, (8, p.ic), device=cuda).float()
    x[:, 0] = 127.0
    got = packed_matmul.pb_int8_matmul(x, p)
    want = (x.double() @ pbw.dequantize_v2(p).double()).float()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


def _quant(x):
    sc = torch.clamp(x.abs().amax(-1, keepdim=True) / 127.0, min=1e-8)
    return torch.clamp(torch.round(x / sc), -127, 127).to(torch.int8), sc


@pytest.mark.cuda
@pytest.mark.parametrize("arm", tda.ARMS)
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 128), (4, 4, 64), (6, 1, 96)])
def test_decode_attention_kernel_matches_plain(cuda, quantized, hq, hkv, d, arm):
    b, s = 4, 256
    g = torch.Generator(device=cuda).manual_seed(hq * d)
    q, k, v = (torch.randn(shape, generator=g, device=cuda)
               for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    lengths = torch.tensor([0, 1, 100, 256], dtype=torch.int32, device=cuda)
    kw = {}
    if quantized:
        (k, ks), (v, vs) = _quant(k), _quant(v)
        kw = dict(k_scale=ks, v_scale=vs)
    args = (q, k, v, lengths, d ** -0.5)
    before = (tda.launches, tda.split_launches)
    got = tda.decode_attention(*args, **kw, arm=arm)
    torch.cuda.synchronize()
    assert (tda.launches, tda.split_launches) == (before[0] + 1, before[1] + (arm == "split"))
    want = tda.decode_attention_plain(*args, **kw)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel_arm", tda.ARMS)
@pytest.mark.parametrize("arm", ["bf16", "q8"])
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 128), (4, 4, 64), (6, 1, 96), (32, 32, 128)])
def test_decode_attention_bf16_and_q8_arms_match_plain(cuda, arm, hq, hkv, d, kernel_arm):
    """bf16 strips, and the q8 arm over int8 strips, against their plain
    versions on the same card tensors, in both kernel arms; each launch
    counts on its arm."""
    b, s = 4, 256
    g = torch.Generator(device=cuda).manual_seed(hq * d + len(arm))
    q, k, v = (torch.randn(shape, generator=g, device=cuda)
               for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    lengths = torch.tensor([0, 1, 100, 256], dtype=torch.int32, device=cuda)
    if arm == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        kw = {}
    else:
        (k, ks), (v, vs) = _quant(k), _quant(v)
        kw = dict(k_scale=ks, v_scale=vs, q_int8=True)
    args = (q, k, v, lengths, d ** -0.5)
    before = (tda.launches, tda.bf16_launches, tda.q8_launches)
    got = tda.decode_attention(*args, **kw, arm=kernel_arm)
    torch.cuda.synchronize()
    assert (tda.launches, tda.bf16_launches, tda.q8_launches) == (
        before[0] + 1, before[1] + (arm == "bf16"), before[2] + (arm == "q8"))
    want = tda.decode_attention_plain(*args, **kw)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", tda.ARMS)
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_decode_attention_q8_scores_are_exact_at_unit_scales(cuda, hq, hkv, arm):
    """The q8 arm's int32 scores, read back exactly.  q holds integers with
    max|q| = 127 (qsc = 1, codes = q), K and V unit scales, and V row r is
    the unit vector e_r, so out[h, r] = softmax(s)_r: log(out_r / out_0)
    rounds to the integer s_r - s_0, which must equal the int64 dots of q
    and K.  A slip in the packing of q's codes against the key words
    changes some s_r by at least 1."""
    b, s, d, n = 2, 128, 128, 90
    g = torch.Generator(device=cuda).manual_seed(hq)
    q = torch.randint(-3, 4, (b, hq, d), generator=g, device=cuda).float()
    q[:, :, 5] = 127.0  # k[..., 5] = 0 below: max|q| = 127 adds nothing to a score
    k = torch.randint(-1, 2, (b, s, hkv, d), generator=g, device=cuda).to(torch.int8)
    k[..., 5] = 0
    k[..., 16:] = 0  # scores of a few tens: exp keeps every weight a normal f32
    v = torch.zeros((b, s, hkv, d), dtype=torch.int8, device=cuda)
    v[:, torch.arange(d), :, torch.arange(d)] = 1
    ones = torch.ones((b, s, hkv, 1), device=cuda)
    lengths = torch.full((b,), n, dtype=torch.int32, device=cuda)
    out = tda.decode_attention(q, k, v, lengths, 1.0, k_scale=ones, v_scale=ones, q_int8=True,
                               arm=arm)
    torch.cuda.synchronize()
    want = torch.einsum("bkgd,bskd->bkgs", q.double().reshape(b, hkv, hq // hkv, d),
                        k[:, :n].double()).reshape(b, hq, n)
    got = torch.log(out[..., :n].double() / out[..., :1].double())
    assert torch.equal(torch.round(got), want - want[..., :1])
    assert (got - torch.round(got)).abs().max() < 1e-2


# the split arm at its split boundaries (SPLIT_ROWS = 64) and max_seq 256
_SPLIT_LENGTHS = ([0, 1, 64, 256], [63, 65, 128, 129], [256, 0, 2, 192])


def _attn_case(dev, kind, b=4, s=256, hq=8, hkv=2, d=128, seed=0):
    """q, k, v and the keyword arguments of one cache arm."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=dev)
               for shape in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    if kind == "bf16":
        return q, k.to(torch.bfloat16), v.to(torch.bfloat16), {}
    if kind == "f32":
        return q, k, v, {}
    (k, ks), (v, vs) = _quant(k), _quant(v)
    return q, k, v, dict(k_scale=ks, v_scale=vs, q_int8=kind == "q8")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "q8"])
def test_decode_attention_split_arm_under_a_graph_whose_lengths_change(cuda, kind):
    """The split arm captured once in a CUDA graph (its grid follows
    max_seq alone), replayed with new lengths on the device each time: each
    replay equals an eager launch bit for bit (a fixed merge order, no
    atomics) and the plain version within the kernel's bounds; empty slots
    give zeros."""
    q, k, v, kw = _attn_case(cuda, kind)
    lengths = torch.tensor(_SPLIT_LENGTHS[0], dtype=torch.int32, device=cuda)
    tda.decode_attention(q, k, v, lengths, 0.088, **kw)  # built and warm before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tda.decode_attention(q, k, v, lengths, 0.088, **kw)
    for lens in _SPLIT_LENGTHS:
        lengths.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        eager = tda.decode_attention(q, k, v, lengths, 0.088, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), lens
        want = tda.decode_attention_plain(q, k, v, lengths, 0.088, **kw)
        torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-5)
        for i, n in enumerate(lens):
            if n == 0:
                assert torch.equal(out[i], torch.zeros_like(out[i]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_decode_attention_split_arm_at_the_serving_shape(cuda, kind):
    """8 slots of max_seq 2048, 32 heads of 128, lengths up to 2048: both
    kernel arms against the plain version and each other."""
    q, k, v, kw = _attn_case(cuda, kind, b=8, s=2048, hq=32, hkv=32, seed=5)
    lengths = torch.tensor([512, 134, 56, 153, 212, 417, 2048, 0], dtype=torch.int32, device=cuda)
    split = tda.decode_attention(q, k, v, lengths, 0.088, **kw)
    slot = tda.decode_attention(q, k, v, lengths, 0.088, **kw, arm="slot")
    torch.cuda.synchronize()
    want = tda.decode_attention_plain(q, k, v, lengths, 0.088, **kw)
    torch.testing.assert_close(split, want, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(slot, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_decode_attention_refuses_an_unknown_arm(cuda):
    q, k, v, kw = _attn_case(cuda, "f32")
    with pytest.raises(ValueError, match="unknown arm"):
        tda.decode_attention(q, k, v, torch.ones(4, dtype=torch.int32, device=cuda), 0.1,
                             arm="flash")


@pytest.mark.cuda
def test_bf16_head_dims_the_kernels_cannot_take_raise(cuda):
    """bf16 rows load 8 elements a lane: decode takes d % 8 == 0 up to
    256, paged attention d % 8 == 0 up to 128; others raise."""
    from pb_llm_tpu_torch.ops import paged_attention as tpa

    lengths = torch.tensor([3], device=cuda)
    for d in (100, 264):
        kv = torch.zeros((1, 8, 1, d), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            tda.decode_attention(torch.zeros((1, 1, d), device=cuda), kv, kv, lengths, 0.1)
    kv = torch.zeros((1, 8, 1, 256), dtype=torch.bfloat16, device=cuda)
    tda.decode_attention(torch.zeros((1, 1, 256), device=cuda), kv, kv, lengths, 0.1)
    for d in (36, 136):
        kp = torch.zeros((4, 1, 16, d), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            tpa.paged_attention(torch.zeros((1, 1, d), device=cuda), kp, kp,
                                torch.zeros((1, 2), dtype=torch.int32, device=cuda), lengths,
                                0.1, 16)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["decode_bf16", "decode_q8", "paged_bf16"])
def test_new_arms_raise_rather_than_fall_back(cuda, monkeypatch, arm):
    """On a CUDA tensor the bf16 and q8 arms launch their kernel or raise:
    with the build failing, the call raises and no plain version runs."""
    from pb_llm_tpu_torch.ops import _build
    from pb_llm_tpu_torch.ops import paged_attention as tpa

    def broken(name):
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu")

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(_build, "load", broken)
    monkeypatch.setattr(tda, "decode_attention_plain", refuse)
    monkeypatch.setattr(tpa, "paged_attention_plain", refuse)
    lengths = torch.tensor([3, 9], device=cuda)
    q = torch.randn((2, 4, 64), device=cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        if arm == "paged_bf16":
            kp = torch.zeros((8, 2, 16, 64), dtype=torch.bfloat16, device=cuda)
            table = torch.arange(8, dtype=torch.int32, device=cuda).reshape(2, 4)
            tpa.paged_attention(q, kp, kp, table, lengths, 0.1, 16)
        elif arm == "decode_bf16":
            kv = torch.zeros((2, 16, 2, 64), dtype=torch.bfloat16, device=cuda)
            tda.decode_attention(q, kv, kv, lengths, 0.1)
        else:
            kv, sc = _quant(torch.randn((2, 16, 2, 64), device=cuda))
            tda.decode_attention(q, kv, kv, lengths, 0.1, k_scale=sc, v_scale=sc, q_int8=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16_strips", "bf16_pages", "int8_strips_q8"])
def test_bf16_and_q8_engines_on_the_card_match_the_cpu(cuda, kv):
    """A tiny llama (GQA 2:1) on the card (kernels) and on the CPU (plain
    versions) over bf16 strips, bf16 pages of 16 (a chunked prefill, then
    decode), and int8 strips with decode_attention "pallas_q8":
    the same prefill logits (1e-3 of max|logit|) and teacher-forced NLL
    (rtol 2e-3, chip_smoke.py's bound), with the arm's kernel launched."""
    from pb_llm_tpu_torch.models.llama import LlamaConfig, init_params
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.ops import paged_attention as tpa
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg = LlamaConfig(vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    kw = dict(cache_dtype=torch.int8 if kv.startswith("int8") else torch.bfloat16)
    if kv == "bf16_pages":
        kw.update(page_size=16, prefill_chunk=32)
    r = np.random.default_rng(1)
    prompt, forced = r.integers(0, 128, 70).tolist(), r.integers(0, 128, 6).tolist()
    counters = (lambda: tda.q8_launches) if kv.endswith("q8") else (
        (lambda: tpa.bf16_launches) if kv == "bf16_pages" else (lambda: tda.bf16_launches))
    before = counters()
    logits, nll = [], []
    for dev, decode in ((cuda, "auto"), ("cpu", "pallas_interpret")):
        # on the CPU "pallas_q8" takes the wrapper, which runs the plain q8 arm
        kernels = KernelConfig(decode_attention="pallas_q8" if kv.endswith("q8") else decode)
        eng = Engine(params, cfg, family_for("llama"),
                     EngineConfig(n_slots=2, max_seq=128, prefill_buckets=(32, 128),
                                  kernels=kernels, **kw), device=dev)
        if kv == "bf16_pages":
            eng.start_chunked_prefill(0, prompt)
            while eng.prefill_chunk_step(0) is None:
                pass
        else:
            eng.prefill(0, prompt)
        logits.append(eng._prefill_logits[0].float().cpu())
        nll.append(eng.forced_decode_nll(0, forced))
    assert counters() > before
    assert (logits[0] - logits[1]).abs().max() <= 1e-3 * logits[1].abs().max()
    assert abs(nll[0] - nll[1]) <= 2e-3 * abs(nll[1])


def _lowbit_layer(ic, oc, low_bits, dev, seed=7):
    """A 2- or 4-bit low layer: random code planes, scale and zero point."""
    g = torch.Generator(device=dev).manual_seed(seed)
    p = random_packed_v2(ic, oc, g, low_frac=0.9)
    planes = [p.sign_packed] + [random_packed_v2(ic, oc, g, low_frac=0.9).sign_packed
                                for _ in range(low_bits - 1)]
    return pbw.PackedLinearV2(
        sign_packed=torch.cat(planes, dim=0).contiguous(), side_val=p.side_val,
        side_idx=p.side_idx, low_scale=torch.rand((1, oc), generator=g, device=dev) * 0.02,
        low_mean=torch.full((1, oc), 2.0 ** (low_bits - 1), device=dev),
        high_scale=p.high_scale, high_zero=p.high_zero, bias=None, ic=ic, oc=oc,
        col_tile=p.col_tile, pack_block=p.pack_block, k_pad_shard=p.k_pad_shard,
        side_bits=8, low_bits=low_bits)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(LAYERS) + ["low2", "low4"])
def test_dequant_kernel_matches_plain_bit_for_bit(cuda, name, dtype):
    p = _lowbit_layer(256, 384, int(name[-1]), cuda) if name.startswith("low") else _layer(name, cuda)
    before = prefill.launches
    got = prefill.dequant_v2_binary(p, dtype)
    torch.cuda.synchronize()
    assert prefill.launches == before + 1
    want = prefill.dequant_v2_binary_plain(p, dtype)
    assert got.dtype == dtype and torch.equal(got, want)


_F32_COUNTER = {"cores": "f32_launches", "tc": "f32_tc_launches", "split": "f32_split_launches"}


@pytest.mark.cuda
@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(LAYERS) + ["shards8", "shards4", "low2", "low4"])
@pytest.mark.parametrize("m", [1, 8, 300])
def test_f32_matmul_kernel_matches_plain(cuda, name, m, dot_dtype):
    p = _lowbit_layer(256, 384, int(name[-1]), cuda) if name.startswith("low") else _layer(name, cuda)
    x = torch.randn((m, p.ic), generator=torch.Generator(device=cuda).manual_seed(m), device=cuda)
    counter = _F32_COUNTER[packed_matmul.f32_arm(m, p, dot_dtype)]
    before = getattr(packed_matmul, counter)
    got = packed_matmul.pb_f32_matmul(x, p, dot_dtype=dot_dtype)
    torch.cuda.synchronize()
    assert getattr(packed_matmul, counter) == before + 1
    want = packed_matmul.pb_f32_matmul_plain(x, p, dot_dtype=dot_dtype)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("gather", ["take", "dot"])
def test_hybrid_prefill_on_the_card_matches_plain(cuda, gather):
    p = _layer("side8", cuda)
    x = torch.randn((300, p.ic), generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    got = prefill.v2_prefill(x, p, gather=gather)
    want = prefill.v2_prefill(x.cpu(), p.to("cpu"), gather=gather)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_hybrid_bf16_prefill_on_the_card_matches_plain(cuda):
    """"hybrid_bf16": bf16 GEMMs with f32 output on the card against the
    bf16-rounded operands multiplied in f32 on the CPU; the products are
    exact either way, only the f32 sums run in another order."""
    p = _layer("side8", cuda)
    x = torch.randn((300, p.ic), generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    got = prefill.v2_prefill(x, p, dot_dtype=torch.bfloat16)
    want = prefill.v2_prefill(x.cpu(), p.to("cpu"), dot_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


FLASH_KERNEL_CASES = [
    (2, 128, 128, 4, 128, True, None),
    (1, 100, 100, 2, 64, True, None),     # T not a multiple of the tile
    (2, 77, 130, 3, 96, False, 101),      # non-causal, kv_len masking
    (1, 64, 64, 2, 32, True, 0),          # no allowed key: zeros
    (1, 150, 150, 2, 40, True, None),     # a head dim the tc arm pads to 64
    (1, 2048, 2048, 2, 128, True, None),  # an eval window: 32 key tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["tc", "cores"])
@pytest.mark.parametrize("dots_bf16", [False, True])
@pytest.mark.parametrize("b,t,s,h,d,causal,kv_len", FLASH_KERNEL_CASES)
def test_flash_attention_kernel_matches_plain(cuda, b, t, s, h, d, causal, kv_len, dots_bf16,
                                              arm):
    g = torch.Generator(device=cuda).manual_seed(t + d)
    q = torch.randn((b, t, h, d), generator=g, device=cuda)
    k, v = (torch.randn((b, s, h, d), generator=g, device=cuda) for _ in range(2))
    args = (q, k, v, d ** -0.5)
    kw = dict(causal=causal, kv_len=kv_len, dots_bf16=dots_bf16, return_residuals=True)
    before = (tfa.launches, tfa.tc_launches)
    out, m, l = tfa.flash_attention(*args, **kw, arm=arm)
    torch.cuda.synchronize()
    assert (tfa.launches, tfa.tc_launches) == (before[0] + (arm == "cores"),
                                               before[1] + (arm == "tc"))
    w_out, w_m, w_l = tfa.flash_attention_plain(*args, **kw)
    assert torch.isfinite(out).all()
    if kv_len == 0:
        assert torch.equal(out, torch.zeros_like(out))
    # bf16 weights round relative to the kernel's running max: bf16 precision
    tol = 1e-2 if dots_bf16 else 1e-4
    torch.testing.assert_close(out, w_out, rtol=tol, atol=tol)
    torch.testing.assert_close(m, w_m, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, w_l, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dots_bf16", [False, True])
def test_flash_tc_terms_match_their_plain_version(cuda, dots_bf16):
    """Arm "tc"'s first launch writes q's, k's and v's bf16 terms (head dim
    padded, v transposed, keys padded) bit for bit as `tc_terms_plain`."""
    g = torch.Generator(device=cuda).manual_seed(3)
    b, t, s, h, d = 2, 70, 75, 3, 40
    q = torch.randn((b, t, h, d), generator=g, device=cuda)
    k, v = (torch.randn((b, s, h, d), generator=g, device=cuda) for _ in range(2))
    scratch = [torch.full(sh, float("nan"), dtype=torch.bfloat16, device=cuda)
               for sh in tfa.tc_scratch(b, t, s, h, d, dots_bf16)]
    tfa.flash_attention(q, k, v, d ** -0.5, dots_bf16=dots_bf16, arm="tc", scratch=scratch)
    torch.cuda.synchronize()
    for got, want in zip(scratch, tfa.tc_terms_plain(q, k, v, dots_bf16)):
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_flash_dispatch_takes_tc_and_refuses_unknown_arms(cuda):
    q = torch.randn((1, 64, 2, 64), device=cuda)
    before = (tfa.launches, tfa.tc_launches)
    tfa.flash_attention(q, q, q, 0.125)
    torch.cuda.synchronize()
    assert (tfa.launches, tfa.tc_launches) == (before[0], before[1] + 1)
    with pytest.raises(ValueError, match="arm"):
        tfa.flash_attention(q, q, q, 0.125, arm="plain")


@pytest.mark.cuda
def test_auto_attention_takes_flash_on_the_card(cuda):
    """"auto" picks the kernel for windows of 1024 or more on a CUDA tensor,
    GQA heads repeated first, as the JAX package does on its chip."""
    from pb_llm_tpu_torch.models import attention as tattn
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig, use_kernels

    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((1, 1024, 4, 64), generator=g, device=cuda)
    k, v = (torch.randn((1, 1024, 2, 64), generator=g, device=cuda) for _ in range(2))
    before = tfa.tc_launches
    with use_kernels(KernelConfig()):
        got = tattn.full_causal_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert tfa.tc_launches == before + 1
    with use_kernels(KernelConfig(attention="xla")):
        want = tattn.full_causal_attention(q, k, v, 0.125)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_auto_attention_raises_for_a_head_dim_the_kernel_cannot_take(cuda):
    """A head dim of 256 is flash-eligible, as in the JAX package; the
    kernel takes at most 128, so "auto" raises instead of quietly taking
    the masked softmax."""
    from pb_llm_tpu_torch.models import attention as tattn
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig, use_kernels

    q = torch.zeros((1, 1024, 2, 256), device=cuda)
    with use_kernels(KernelConfig()), pytest.raises(ValueError, match="head_dim 256"):
        tattn.full_causal_attention(q, q, q, 0.0625)


def _paged_pool(n_pages, hkv, ps, d, kind, g):
    """(k, v, k scales, v scales) pages of ``kind`` "int8", "f32" or "bf16"."""
    kv = [torch.randn((n_pages + 1, hkv, ps, d), generator=g, device=g.device) for _ in range(2)]
    if kind != "int8":
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        return kv[0].to(dt), kv[1].to(dt), None, None
    (k, ks), (v, vs) = _quant(kv[0]), _quant(kv[1])
    return k, v, ks[..., 0].contiguous(), vs[..., 0].contiguous()


PAGED_CASES = {
    # name: (B, t, Hq, Hkv, D, page, n_pages, maxp, bases, pages)
    "decode_int8": (8, 1, 32, 32, 128, 16, 1024, 128, "len<=512", "int8"),
    "decode_f32": (8, 1, 32, 32, 128, 16, 1024, 128, "len<=512", "f32"),
    "verify_t5_int8": (8, 5, 32, 32, 128, 16, 1024, 128, "len<=512", "int8"),
    "chunk_t256_int8": (2, 256, 32, 32, 128, 16, 1024, 128, (1024, 512), "int8"),
    "gqa_decode_int8": (8, 1, 32, 8, 128, 16, 1024, 128, "len<=512", "int8"),
    "empty_slot_t1": (3, 1, 4, 4, 64, 16, 40, 8, (-1, 0, 70), "int8"),
    "t17_gqa4_page8": (3, 17, 8, 2, 64, 8, 60, 16, (0, 9, 100), "int8"),
    "t17_f32_page8": (2, 17, 4, 1, 32, 8, 30, 12, (3, 50), "f32"),
    "decode_bf16": (8, 1, 32, 32, 128, 16, 1024, 128, "len<=512", "bf16"),
    "verify_t5_bf16": (8, 5, 32, 32, 128, 16, 1024, 128, "len<=512", "bf16"),
    "chunk_t256_bf16": (2, 256, 32, 32, 128, 16, 1024, 128, (1024, 512), "bf16"),
    "gqa_decode_bf16": (8, 1, 32, 8, 128, 16, 1024, 128, "len<=512", "bf16"),
    "t5_gqa4_bf16_page8_d40": (3, 5, 8, 2, 40, 8, 60, 16, (2, 9, 100), "bf16"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_paged_attention_kernel_matches_plain(cuda, name):
    """The paged kernel against its plain version at chip_smoke.py's phase-2
    shapes and at odd ones: an empty slot (base -1), t = 1 and 17, GQA 4:1,
    pages of 8; shuffled tables over pools whose other pages hold NaN."""
    from pb_llm_tpu_torch.ops import paged_attention as tpa

    b, t, hq, hkv, d, ps, n_pages, maxp, bases, kind = PAGED_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(len(name))
    kp, vp, ks, vs = _paged_pool(n_pages, hkv, ps, d, kind, g)
    table = torch.randperm(n_pages, generator=g, device=cuda)[: b * maxp].reshape(b, maxp)
    if bases == "len<=512":
        base = torch.randint(0, 512 - t + 1, (b,), generator=g, device=cuda)
        base[0] = 512 - t
    else:
        base = torch.tensor(bases, device=cuda)
    limit = int((base + t).max())
    used = table[:, : -(-limit // ps)].reshape(-1)
    unused = torch.ones(n_pages + 1, dtype=torch.bool, device=cuda)
    unused[used] = False
    if kind != "int8":  # no key past a limit is read: poison the others
        kp[unused], vp[unused] = float("nan"), float("nan")
    q = torch.randn((b, t, hq, d), generator=g, device=cuda)
    before = (tpa.launches, tpa.multi_launches, tpa.bf16_launches)
    got = tpa.paged_attention_multi(q, kp, vp, table.to(torch.int32), base, d ** -0.5, ps, ks, vs)
    torch.cuda.synchronize()
    assert (tpa.launches, tpa.multi_launches, tpa.bf16_launches) == (
        before[0] + 1, before[1] + 1, before[2] + (kind == "bf16"))
    want = tpa.paged_attention_plain(q, kp, vp, table, base, d ** -0.5, ps, ks, vs)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    if (base < 0).any():
        assert torch.equal(got[base < 0], torch.zeros_like(got[base < 0]))
    if t == 1:
        dec = tpa.paged_attention(q[:, 0], kp, vp, table, base + 1, d ** -0.5, ps, ks, vs)
        torch.testing.assert_close(dec, got[:, 0], rtol=0, atol=0)


@pytest.mark.cuda
def test_paged_attention_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    from pb_llm_tpu_torch.ops import paged_attention as tpa

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(tpa, "paged_attention_plain", refuse)
    g = torch.Generator(device=cuda).manual_seed(0)
    kp, vp, ks, vs = _paged_pool(8, 2, 16, 64, "int8", g)
    table = torch.arange(8, device=cuda, dtype=torch.int32).reshape(2, 4)
    before = tpa.decode_launches
    out = tpa.paged_attention(torch.randn((2, 4, 64), device=cuda), kp, vp, table,
                              torch.tensor([5, 64], device=cuda), 0.125, 16, ks, vs)
    torch.cuda.synchronize()
    assert out.shape == (2, 4, 64) and tpa.decode_launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["f16_pages", "head_dim", "strided", "table_on_cpu"])
def test_paged_attention_kernel_refuses_what_it_cannot_take(cuda, bad):
    from pb_llm_tpu_torch.ops import paged_attention as tpa

    g = torch.Generator(device=cuda).manual_seed(1)
    d = 24 if bad == "head_dim" else 64  # int8 rows load 16 bytes at a time
    kp, vp, ks, vs = _paged_pool(8, 2, 16, d, "int8", g)
    table = torch.arange(8, device=cuda, dtype=torch.int32).reshape(2, 4)
    q = torch.randn((2, 1, 4, d), device=cuda)
    if bad == "f16_pages":
        kp, vp, ks, vs = kp.half(), vp.half(), None, None
    elif bad == "strided":
        kp = torch.cat([kp, kp], dim=3)[..., :d]
    elif bad == "table_on_cpu":
        table = table.cpu()
    with pytest.raises(ValueError):
        tpa.paged_attention_multi(q, kp, vp, table, torch.tensor([3, 9], device=cuda), 0.1, 16,
                                  ks, vs)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(page_size=16), dict(page_size=16, spec_gamma=3),
                                dict(page_size=16, prefill_chunk=32)])
def test_paged_engine_on_the_card_matches_the_cpu(cuda, kw):
    """A tiny f32-page llama engine on the card (kernels) and on the CPU
    (plain versions): the same greedy streams, through both kernel modes."""
    from pb_llm_tpu_torch.models.llama import LlamaConfig, init_params
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.ops import paged_attention as tpa
    from pb_llm_tpu_torch.runtime.batching import ContinuousBatcher, Request
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg = LlamaConfig(vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    r = np.random.default_rng(0)
    prompts = [r.integers(0, 128, n).tolist() for n in (5, 40, 12, 70)]
    streams = []
    before = (tpa.decode_launches, tpa.multi_launches)
    for dev in (cuda, "cpu"):
        eng = Engine(params, cfg, family_for("llama"),
                     EngineConfig(n_slots=2, max_seq=128, prefill_buckets=(32, 128),
                                  cache_dtype=torch.float32, **kw), device=dev)
        reqs = [Request(request_id=i, prompt_ids=p, max_new_tokens=10)
                for i, p in enumerate(prompts)]
        ContinuousBatcher(eng).run(reqs)
        streams.append([q.output_ids for q in reqs])
    assert streams[0] == streams[1]
    if kw.get("spec_gamma") or kw.get("prefill_chunk"):
        assert tpa.multi_launches > before[1]
    else:
        assert tpa.decode_launches > before[0]


# ---------------------------------------------------------------------------
# PBW v1: the planar and select kernels
# ---------------------------------------------------------------------------

V1_LAYERS = {
    "whole_row": dict(ic=512, oc=256),
    "groups128_oc384": dict(ic=512, oc=384, groupsize=128, bias=True),  # oc not a multiple of 512
    "nibbles": dict(ic=1024, oc=256, sidecar_bits=4),
    "groups128_nibbles_low2": dict(ic=512, oc=256, groupsize=128, sidecar_bits=4, low_bits=2,
                                   bias=True),
    "low4_oc640": dict(ic=256, oc=640, low_bits=4),
    "short_ic": dict(ic=64, oc=128, bias=True),
    "wide_groups": dict(ic=2048, oc=128, groupsize=128, low_bits=2),
}
# the select kernel also takes scale groups inside a pack block (the planar one does not)
V1_SELECT_LAYERS = {**V1_LAYERS, "groups64_in_blocks512": dict(
    ic=1024, oc=256, groupsize=64, pack_block=512, sidecar_bits=4, bias=True)}


def _v1_layer(name, dev):
    from pb_llm_tpu_torch.data.synthetic import random_packed_v1

    return random_packed_v1(generator=torch.Generator(device=dev).manual_seed(5),
                            **V1_SELECT_LAYERS[name])


def _close(got, want, rtol=1e-4, atol=1e-4):
    err = (got - want).abs()
    assert torch.isfinite(got).all() and torch.all(err <= atol + rtol * want.abs()), err.max()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(V1_LAYERS))
@pytest.mark.parametrize("m", [1, 8, 255])
def test_planar_v1_kernel_matches_plain(cuda, name, m):
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

    p = _v1_layer(name, cuda)
    x = torch.randn((m, p.ic), generator=torch.Generator(device=cuda).manual_seed(m), device=cuda)
    counter = _PLANAR_COUNTER[v1.planar_arm(p)]
    before = getattr(v1, counter)
    got = v1.pb_planar_v1(x, p)
    torch.cuda.synchronize()
    assert getattr(v1, counter) == before + 1
    _close(got, v1.pb_planar_v1_plain(x, p))


_PLANAR_COUNTER = {"cores": "planar_launches", "tc": "planar_tc_launches"}
# arm "tc"'s layouts: low_bits 1/2/4, nibble codes, whole-row and 128-row
# groups, oc a multiple of 256 or not, ic below a pack block
PLANAR_TC_LAYERS = ["whole_row", "groups128_oc384", "nibbles", "groups128_nibbles_low2",
                    "low4_oc640", "short_ic", "wide_groups"]
PLANAR_TC_MS = [1, 2, 7, 8, 9, 16, 17, 64, 100, 255]


@pytest.mark.cuda
@pytest.mark.parametrize("name", PLANAR_TC_LAYERS)
@pytest.mark.parametrize("m", PLANAR_TC_MS)
def test_planar_v1_tc_arm_matches_plain_and_cores(cuda, name, m):
    """Arm "tc" (x in three bf16 terms, C, M, V exact in bf16, a fold a
    stage, a K split in a cluster) within rtol = atol = 1e-4 of the plain
    version and of arm "cores"."""
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

    p = _v1_layer(name, cuda)
    assert v1.planar_arm(p) == "tc"
    x = torch.randn((m, p.ic), generator=torch.Generator(device=cuda).manual_seed(m), device=cuda)
    want = v1.pb_planar_v1_plain(x, p)
    cores = v1.launch_planar(x, p, "cores")
    before = v1.planar_tc_launches
    got = v1.launch_planar(x, p, "tc")
    torch.cuda.synchronize()
    assert v1.planar_tc_launches == before + 1
    _close(got, want)
    _close(got, cores)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["whole_row", "groups128_nibbles_low2", "low4_oc640"])
def test_planar_v1_tc_reads_an_identity_back_bit_for_bit(cuda, name):
    """An identity x is one exact term with one weight row a row of y:
    every product and row sum is exact, the other stages fold zeros, and y
    equals the plain version's bit for bit, at 8 rows a block and at 16."""
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

    p = _v1_layer(name, cuda)
    m = min(p.ic, 255)
    x = torch.eye(p.ic, device=cuda)[:m].contiguous()
    want = v1.pb_planar_v1_plain(x, p)
    assert torch.equal(v1.launch_planar(x, p, "tc"), want)
    assert torch.equal(v1.launch_planar(x[:8].contiguous(), p, "tc"), want[:8])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["whole_row", "groups128_oc384", "nibbles"])
def test_planar_v1_tc_rows_do_not_depend_on_m_or_the_tile(cuda, name):
    """The K split is fixed by the shape: a row gets the same bits at m =
    1, 8 (8 rows a block), 9 and 100 (16 rows a block)."""
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

    p = _v1_layer(name, cuda)
    x = torch.randn((100, p.ic), generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    full = v1.launch_planar(x, p, "tc")
    for m in (1, 8, 9):
        xm = x[:m].contiguous()
        assert torch.equal(v1.launch_planar(xm, p, "tc"), full[:m]), m


@pytest.mark.cuda
def test_planar_v1_tc_terms_and_sums_match_their_plain_versions(cuda):
    """The terms launch writes select "tc"'s terms bit for bit, and the
    stage row sums of `planar_stage_sums_plain` (the same tree of pairs)."""
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

    p = _v1_layer("groups128_oc384", cuda)
    x = torch.randn((9, p.ic), generator=torch.Generator(device=cuda).manual_seed(4), device=cuda)
    xt, sums = v1.planar_tc_scratch(x, p)
    xt.fill_(float("nan"))
    sums.fill_(float("nan"))
    out = torch.empty((9, p.oc), device=cuda)
    v1._planar_tc_call(x, p, v1.planar_coef(p), out, xt, sums,
                       torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert torch.equal(xt, v1.select_x_terms_plain(x, p))
    assert torch.equal(sums, v1.planar_stage_sums_plain(x, p))


@pytest.mark.cuda
def test_planar_v1_tc_under_a_graph_equals_eager(cuda):
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

    p = _v1_layer("groups128_oc384", cuda)
    x = torch.randn((8, p.ic), generator=torch.Generator(device=cuda).manual_seed(5), device=cuda)
    eager = v1.pb_planar_v1(x, p)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            captured = v1.pb_planar_v1(x, p)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(eager, captured)


@pytest.mark.cuda
@pytest.mark.parametrize("ic,oc", [(2048, 2048), (2048, 8192), (8192, 2048), (4096, 11008)])
@pytest.mark.parametrize("groupsize", [-1, 128])
def test_planar_v1_tc_at_full_width(cuda, ic, oc, groupsize):
    """OPT-1.3B's shapes and llama-7b's MLP at decode rows and the most
    the planar dispatch sends (255)."""
    from pb_llm_tpu_torch.data.synthetic import random_packed_v1
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

    g = torch.Generator(device=cuda).manual_seed(ic + oc)
    p = random_packed_v1(ic, oc, g, low_frac=0.9, groupsize=groupsize, bias=True)
    for m in (1, 8, 255):
        x = torch.randn((m, ic), generator=g, device=cuda)
        assert v1.planar_arm(p) == "tc"
        _close(v1.pb_planar_v1(x, p), v1.pb_planar_v1_plain(x, p))


@pytest.mark.cuda
def test_planar_v1_tc_refuses_what_it_cannot_take(cuda):
    """Groups of 32 rows split a 128-row stage: the rule keeps "cores", and
    the arm, asked by name, raises before anything launches."""
    from pb_llm_tpu_torch.data.synthetic import random_packed_v1
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

    p = random_packed_v1(256, 128, torch.Generator(device=cuda).manual_seed(0), groupsize=32,
                         pack_block=32)
    x = torch.randn((8, 256), device=cuda)
    assert v1.planar_arm(p) == "cores"
    with pytest.raises(ValueError, match="128-row stages"):
        v1.pb_planar_v1(x, p, arm="tc")
    _close(v1.pb_planar_v1(x, p), v1.pb_planar_v1_plain(x, p))


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["tc", "cores"])
@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(V1_SELECT_LAYERS))
@pytest.mark.parametrize("m", [256, 512, 1000])
def test_select_v1_kernel_matches_plain(cuda, name, m, dot_dtype, arm):
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

    p = _v1_layer(name, cuda)
    x = torch.randn((m, p.ic), generator=torch.Generator(device=cuda).manual_seed(m), device=cuda)
    before = (v1.select_launches, v1.select_tc_launches)
    got = v1.pb_select_v1(x, p, dot_dtype, arm=arm)
    torch.cuda.synchronize()
    assert (v1.select_launches, v1.select_tc_launches) == (before[0] + (arm == "cores"),
                                                           before[1] + (arm == "tc"))
    _close(got, v1.pb_select_v1_plain(x, p, dot_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["nibbles", "groups64_in_blocks512", "short_ic"])
def test_select_v1_tc_terms_match_their_plain_version(cuda, name, dot_dtype):
    """Arm "tc"'s first launch writes x's bf16 terms in its word-by-word
    column order bit for bit as `select_x_terms_plain`."""
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

    p = _v1_layer(name, cuda)
    x = torch.randn((37, p.ic), generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    want = v1.select_x_terms_plain(x, p, dot_dtype)
    scratch = torch.full(want.shape, float("nan"), dtype=torch.bfloat16, device=cuda)
    v1.launch_select(x, p, dot_dtype, "tc", scratch=scratch)
    torch.cuda.synchronize()
    assert torch.equal(scratch.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_select_v1_kernel_rebuilds_the_plain_weight_bit_for_bit(cuda):
    """An identity x reads the rebuilt weight rows out one by one: the
    kernel's blend is the plain version's, bit for bit."""
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

    for name in ("groups128_nibbles_low2", "whole_row"):
        p = _v1_layer(name, cuda)
        p.bias = None
        eye = torch.eye(p.ic, device=cuda)
        assert torch.equal(v1.pb_select_v1(eye, p), v1.select_weight(p))


@pytest.mark.cuda
def test_v1_dispatch_on_the_card_takes_the_kernels(cuda):
    """"auto" on a CUDA tensor: planar below 256 rows on the arm
    `planar_arm` picks, select from 256 on the arm `select_arm` picks; an
    unknown arm raises."""
    from pb_llm_tpu_torch.ops import binary_matmul
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

    p = _v1_layer("groups128_oc384", cuda)

    def counts():
        return {"planar": v1.planar_launches, "planar_tc": v1.planar_tc_launches,
                "cores": v1.select_launches, "tc": v1.select_tc_launches}

    planar = "planar_tc" if v1.planar_arm(p) == "tc" else "planar"
    for m in (8, 300):
        arm = planar if m < v1.V1_PLANAR_M else v1.select_arm(m, p)
        x = torch.randn((m, p.ic), device=cuda)
        before = counts()
        got = binary_matmul.pb_matmul(x, p)
        torch.cuda.synchronize()
        assert counts() == {k: n + (k == arm) for k, n in before.items()}
        _close(got, pbw.matmul_reference(x, p))
    with pytest.raises(ValueError, match="arm"):
        v1.pb_select_v1(torch.zeros((300, p.ic), device=cuda), p, arm="plain")


@pytest.mark.cuda
def test_v1_wrappers_refuse_planes_off_the_card(cuda):
    """A CUDA x with CPU planes raises; nothing falls back to the plain
    version."""
    from pb_llm_tpu_torch.data.synthetic import random_packed_v1
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1

    p = random_packed_v1(256, 128, torch.Generator().manual_seed(0))
    for fn, m in ((v1.pb_planar_v1, 8), (v1.pb_select_v1, 300)):
        with pytest.raises(ValueError, match="device"):
            fn(torch.zeros((m, 256), device=cuda), p)


@pytest.mark.cuda
def test_opt_v1_engine_on_the_card_matches_the_cpu(cuda):
    """A tiny PBW-v1 OPT (groups of 64) on the card (kernels) and on the
    CPU (plain versions, f32 strips): the same prefill logits (5e-3 of
    max|logit|) and greedy streams; both kernels launch."""
    from pb_llm_tpu_torch.data.synthetic import random_packed_opt
    from pb_llm_tpu_torch.models.opt import OPTConfig
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig
    from pb_llm_tpu_torch.runtime.batching import ContinuousBatcher, Request
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg = OPTConfig(vocab_size=256, hidden_size=128, ffn_dim=256, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=512)
    params = random_packed_opt(cfg, torch.Generator().manual_seed(0), groupsize=64)
    r = np.random.default_rng(0)
    prompts = [r.integers(0, 256, n).tolist() for n in (5, 300, 12, 70)]
    streams, logits = [], []
    before = (v1.planar_launches, v1.select_launches + v1.select_tc_launches)
    for dev, kernels in ((cuda, None), ("cpu", KernelConfig(backend="pallas_interpret"))):
        eng = Engine(params, cfg, family_for("opt"),
                     EngineConfig(n_slots=2, max_seq=512, prefill_buckets=(32, 512),
                                  cache_dtype=torch.float32, kernels=kernels), device=dev)
        eng.prefill(0, prompts[1])
        logits.append(eng._prefill_logits[0].float().cpu())
        eng.release(0)
        reqs = [Request(request_id=i, prompt_ids=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        ContinuousBatcher(eng).run(reqs)
        streams.append([q.output_ids for q in reqs])
    assert (logits[0] - logits[1]).abs().max() <= 5e-3 * logits[1].abs().max()
    assert streams[0] == streams[1]
    assert v1.planar_launches > before[0]
    assert v1.select_launches + v1.select_tc_launches > before[1]


# ---------------------------------------------------------------------------
# the pair and dma decode arms, the stacked kernels (scan_layers)
# ---------------------------------------------------------------------------

def _arm_layer(name, dev):
    if name == "fused3":
        g = torch.Generator(device=dev).manual_seed(5)
        return pbw.merge_packed_linears_v2([random_packed_v2(512, 256, g, bias=True)
                                            for _ in range(3)])
    if name == "wide_kpad":  # more code rows than the dma kernel keeps in shared memory
        return random_packed_v2(8192, 128, torch.Generator(device=dev).manual_seed(6),
                                low_frac=0.4)
    return _layer(name, dev)


_PAIR_COUNTER = {"mma": "pair_launches", "split": "pair_split_launches",
                 "tc": "pair_tc_launches"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LAYERS) + ["shards8", "shards4", "fused3"])
@pytest.mark.parametrize("m", [1, 8, 100, 255])
def test_pair_kernel_matches_plain(cuda, name, m):
    from pb_llm_tpu_torch.ops import decode_arms

    p = _arm_layer(name, cuda)
    x = torch.randn((m, p.ic), generator=torch.Generator(device=cuda).manual_seed(m), device=cuda)
    counter = _PAIR_COUNTER[decode_arms.pair_arm(m, p)]
    before = getattr(decode_arms, counter)
    got = decode_arms.pb_pair_v2(x, p)
    torch.cuda.synchronize()
    assert getattr(decode_arms, counter) == before + 1
    want = decode_arms.pb_pair_v2_plain(x, p)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["side8", "side4", "multiblock", "shards8", "shards4",
                                  "wide_kpad"])
@pytest.mark.parametrize("m", [1, 8, 100, 256])
def test_dma_kernel_matches_plain(cuda, name, m):
    from pb_llm_tpu_torch.ops import decode_arms

    p = _arm_layer(name, cuda)
    x = torch.randn((m, p.ic), generator=torch.Generator(device=cuda).manual_seed(m), device=cuda)
    counter = _DMA_COUNTER[decode_arms.dma_arm(p)]
    before = getattr(decode_arms, counter)
    got = decode_arms.pb_dma_v2(x, p)
    torch.cuda.synchronize()
    assert getattr(decode_arms, counter) == before + 1
    torch.testing.assert_close(got, decode_arms.pb_dma_v2_plain(x, p), rtol=1e-4, atol=1e-4)


_DMA_COUNTER = {"cores": "dma_launches", "split": "dma_split_launches"}
DMA_SPLIT_MS = [1, 2, 7, 8, 9, 15, 16, 17, 64, 100, 255]


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("side_bits", [8, 4])
@pytest.mark.parametrize("m", DMA_SPLIT_MS)
def test_dma_split_arm_matches_plain_and_cores(cuda, side_bits, bias, m):
    """Arm "split" (x in three exact bf16 terms, the K split in a cluster)
    within rtol = atol = 1e-4 of the plain version, of the plain version on
    its own operands and of arm "cores", with 8- and 4-bit codes."""
    from pb_llm_tpu_torch.ops import decode_arms

    g = torch.Generator(device=cuda).manual_seed(side_bits + m)
    p = random_packed_v2(512, 384, g, side_bits=side_bits, pack_block=128, bias=bias)
    assert decode_arms.dma_arm(p) == "split"
    x = torch.randn((m, 512), generator=g, device=cuda)
    ops = decode_arms.prepare_dma(x, p, "split")
    before = decode_arms.dma_split_launches
    got = decode_arms.launch_dma(ops, p)
    torch.cuda.synchronize()
    assert decode_arms.dma_split_launches == before + 1
    tol = dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, decode_arms.pb_dma_v2_plain(x, p), **tol)
    torch.testing.assert_close(got, decode_arms.dma_matmul_plain(ops, p), **tol)
    cores = decode_arms.launch_dma(decode_arms.prepare_dma(x, p, "cores"), p)
    torch.testing.assert_close(got, cores, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("ic,oc", [(4096, 4096), (4096, 11008), (11008, 4096)])
@pytest.mark.parametrize("side_bits", [8, 4])
def test_dma_split_arm_at_llama_width(cuda, ic, oc, side_bits):
    """llama-7b's three shapes (ic = 11008 packs in blocks of 1376) at the
    rows phase 2 times: the plain version within 1e-4, every run the same bits."""
    from pb_llm_tpu_torch.ops import decode_arms

    g = torch.Generator(device=cuda).manual_seed(ic + oc + side_bits)
    p = random_packed_v2(ic, oc, g, low_frac=0.9, side_bits=side_bits)
    for m in (1, 8, 15, 64, 255):
        x = torch.randn((m, ic), generator=g, device=cuda)
        got = decode_arms.pb_dma_v2(x, p)
        again = decode_arms.pb_dma_v2(x, p)
        torch.testing.assert_close(got, decode_arms.pb_dma_v2_plain(x, p), rtol=1e-4, atol=1e-4)
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["side8", "side4", "shards4", "multiblock"])
def test_dma_prep_matches_its_plain_version(cuda, name):
    """pb_prep_dma's terms equal `packed_matmul.prepare_tc`'s bit for bit;
    its row sums lie within `sum_bound` of the plain f32 sums."""
    from pb_llm_tpu_torch.ops import decode_arms

    p = _arm_layer(name, cuda)
    x = torch.randn((11, p.ic), generator=torch.Generator(device=cuda).manual_seed(7), device=cuda)
    x[0, 0] = 1e-40  # a subnormal splits exactly too
    x[1, 1] = 3.0e38
    before = packed_matmul.split_prep_launches
    got = decode_arms.prepare_dma(x, p, "split")
    torch.cuda.synchronize()
    assert packed_matmul.split_prep_launches == before + 1
    want = packed_matmul.prepare_tc(x, p, 3)
    assert torch.equal(got.xt, want.xp) and torch.equal(got.xgp, want.xgp)
    assert torch.all((got.f32.rs - want.f32.rs).abs() <= packed_matmul.sum_bound(x, 1))
    xg = want.f32.xg
    assert torch.all((got.f32.rsg - want.f32.rsg).abs() <= packed_matmul.sum_bound(xg, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("side_bits", [8, 4])
def test_dma_split_reads_an_identity_back_bit_for_bit(cuda, side_bits):
    """An identity x: every product, partial and row sum is exact, so y
    equals the plain version's bit for bit (a row of the layer's weight, its
    epilogue in the plain version's order)."""
    from pb_llm_tpu_torch.ops import decode_arms

    p = random_packed_v2(256, 384, torch.Generator(device=cuda).manual_seed(9),
                         side_bits=side_bits, bias=True)
    for rows in (slice(0, 8), slice(0, 255), slice(200, 256)):
        x = torch.eye(256, device=cuda)[rows].contiguous()
        assert torch.equal(decode_arms.pb_dma_v2(x, p), decode_arms.pb_dma_v2_plain(x, p))


@pytest.mark.cuda
def test_dma_split_rows_do_not_depend_on_m(cuda):
    """The K split is fixed by the shape: a row gets the same bits at m =
    1, 8 (8 rows a block), 9 and 100 (16 rows a block)."""
    from pb_llm_tpu_torch.ops import decode_arms

    g = torch.Generator(device=cuda).manual_seed(12)
    p = random_packed_v2(4096, 4096, g, low_frac=0.9)
    assert decode_arms.dma_ksplit(p) > 1
    x = torch.randn((100, 4096), generator=g, device=cuda)
    full = decode_arms.pb_dma_v2(x, p)
    for m in (1, 8, 9):
        assert torch.equal(decode_arms.pb_dma_v2(x[:m].contiguous(), p), full[:m]), m


@pytest.mark.cuda
def test_dma_split_under_a_graph_equals_eager(cuda):
    from pb_llm_tpu_torch.ops import decode_arms

    p = random_packed_v2(1024, 512, torch.Generator(device=cuda).manual_seed(13), side_bits=4)
    x = torch.randn((8, 1024), generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    eager = decode_arms.pb_dma_v2(x, p)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            captured = decode_arms.pb_dma_v2(x, p)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(eager, captured)


@pytest.mark.cuda
def test_dma_split_refuses_what_it_cannot_take(cuda):
    """A layout the tensor cores do not take keeps "cores" by rule, and
    "split" operands meet no other arm: no silent fallback."""
    from pb_llm_tpu_torch.ops import decode_arms

    p = random_packed_v2(256, 264, torch.Generator(device=cuda).manual_seed(0))  # oc % 16 != 0
    x = torch.randn((8, 256), device=cuda)
    assert decode_arms.dma_arm(p) == "cores"
    with pytest.raises(ValueError, match="split arm does not take"):
        decode_arms.launch_dma(decode_arms.prepare_dma(x, p, "split"), p)
    q = random_packed_v2(256, 256, torch.Generator(device=cuda).manual_seed(0))
    ops = decode_arms.prepare_dma(x, q, "split")._replace(layout="mma")
    with pytest.raises(ValueError, match="no arm takes"):
        decode_arms.launch_dma(ops, q)


def _stacked(dev, side_bits=8, n=3):
    from pb_llm_tpu_torch.models import stacking

    g = torch.Generator(device=dev).manual_seed(side_bits)
    layers = [random_packed_v2(512, 256, g, side_bits=side_bits, pack_block=128, bias=True)
              for _ in range(n)]
    sp = stacking.stack_layers({"layers": [{"w": p} for p in layers]})["layers_stacked"]["w"]
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    return layers, [stacking.StackedPackedLinearV2(sp, li, idx[li : li + 1]) for li in range(n)]


_STACKED_COUNTER = {"dp4a": "stacked_launches", "tc": "stacked_tc_launches",
                    "split": "stacked_split_launches"}
_STACKED_F32_COUNTER = {"cores": "stacked_f32_launches", "tc": "stacked_f32_tc_launches",
                        "split": "stacked_f32_split_launches"}


@pytest.mark.cuda
@pytest.mark.parametrize("side_bits", [8, 4])
@pytest.mark.parametrize("m", [m for m in INT8_MS if m <= packed_matmul.STACKED_MAX_M])
def test_stacked_kernels_match_plain_and_the_flat_kernels(cuda, side_bits, m):
    layers, markers = _stacked(cuda, side_bits)
    x = torch.randn((m, 512), generator=torch.Generator(device=cuda).manual_seed(m), device=cuda)
    for p, mk in zip(layers, markers):
        arm = packed_matmul.int8_arm(m, p)
        counter = _STACKED_COUNTER[arm]
        f32_counter = _STACKED_F32_COUNTER[packed_matmul.f32_arm(m, p)]
        before = (getattr(packed_matmul, counter), getattr(packed_matmul, f32_counter))
        i8 = packed_matmul.pb_int8_matmul_stacked(x, mk)
        f32 = packed_matmul.pb_f32_matmul_stacked(x, mk)
        torch.cuda.synchronize()
        assert (getattr(packed_matmul, counter), getattr(packed_matmul, f32_counter)) == (
            before[0] + 1, before[1] + 1)
        ops = packed_matmul.prepare_int8(x, p, packed_matmul.layout_of(arm))
        assert torch.equal(i8, packed_matmul.int8_matmul_plain(ops, p))
        # stacked = flat, same operands
        assert torch.equal(i8, packed_matmul.launch_int8(ops, p, arm))
        for other in _arms_for(p, m):  # every arm of the stacked entry, the same bits
            assert torch.equal(i8, packed_matmul.launch_int8_stacked(
                packed_matmul.to_layout(ops, p, packed_matmul.layout_of(other)), mk, other)), other
        want = packed_matmul.pb_int8_matmul_stacked_plain(x, mk)
        assert (i8 - want).abs().max() <= 1e-6 * want.abs().max()
        torch.testing.assert_close(f32, packed_matmul.pb_f32_matmul_stacked_plain(x, mk),
                                   rtol=1e-4, atol=1e-4)
        assert torch.equal(f32, packed_matmul.pb_f32_matmul(x, p))


@pytest.mark.cuda
def test_decode_arms_and_stacked_dispatch_on_the_card_take_the_kernels(cuda):
    """decode_dot pair / dma on a CUDA tensor launch their kernels (pair at
    8 rows its "split" arm, dma its "split" arm); a stacked marker launches the stacked int8
    kernel on "int8" (8 rows: the arm `int8_arm` picks) and the stacked f32
    kernel on the other arms (8 rows: its "split" arm), at m <= 256."""
    from pb_llm_tpu_torch.ops import binary_matmul, decode_arms
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig, use_kernels

    p = _layer("side8", cuda)
    x = torch.randn((8, p.ic), device=cuda)
    _, markers = _stacked(cuda)
    xs = torch.randn((8, 512), device=cuda)

    stacked = _STACKED_COUNTER[packed_matmul.int8_arm(8, packed_matmul.stacked_layer(markers[1]))]

    assert decode_arms.dma_arm(p) == "split"

    def counts():
        return (decode_arms.pair_split_launches, decode_arms.dma_split_launches,
                getattr(packed_matmul, stacked), packed_matmul.stacked_f32_split_launches)

    for arm, want in (("pair", (1, 0, 0, 1)), ("dma", (0, 1, 0, 1)), ("int8", (0, 0, 1, 0))):
        before = counts()
        with use_kernels(KernelConfig(decode_dot=arm)):
            binary_matmul.pb_matmul(x, p) if arm != "int8" else None
            binary_matmul.pb_matmul_stacked(xs, markers[1])
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(counts(), before)) == want, arm


@pytest.mark.cuda
def test_new_wrappers_refuse_planes_off_the_card(cuda):
    from pb_llm_tpu_torch.ops import decode_arms

    p = random_packed_v2(256, 128, torch.Generator().manual_seed(0))
    for fn in (decode_arms.pb_pair_v2, decode_arms.pb_dma_v2):
        with pytest.raises(ValueError, match="on cpu, x on cuda"):
            fn(torch.zeros((8, 256), device=cuda), p)
    _, markers = _stacked(torch.device("cpu"))
    for fn in (packed_matmul.pb_int8_matmul_stacked, packed_matmul.pb_f32_matmul_stacked):
        with pytest.raises(ValueError, match="on cpu, x on cuda"):
            fn(torch.zeros((8, 512), device=cuda), markers[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(scan_layers=True),
                                dict(scan_layers=True, fuse_linears=True, decode_dot="pair"),
                                dict(fuse_linears=True, decode_dot="dma", page_size=16)])
def test_scan_fuse_engine_on_the_card_matches_the_cpu(cuda, kw):
    """A tiny PBW-v2 llama (hidden 256) on the card (kernels) and on the CPU
    (plain versions, f32 strips or pages), exact f32 prefill: the same
    prefill logits (5e-3 of max|logit|) and greedy streams."""
    from pb_llm_tpu_torch.data.synthetic import random_packed_llama
    from pb_llm_tpu_torch.models.llama import LlamaConfig
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig
    from pb_llm_tpu_torch.runtime.batching import ContinuousBatcher, Request
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    kw = dict(kw)
    arm = dict(decode_dot=kw.pop("decode_dot", "f32"), prefill="hybrid")
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=512)
    params = random_packed_llama(cfg, torch.Generator().manual_seed(0))
    r = np.random.default_rng(0)
    prompts = [r.integers(0, 256, n).tolist() for n in (5, 300, 12, 70)]
    streams, logits = [], []
    for dev, kernels in ((cuda, KernelConfig(**arm)),
                         ("cpu", KernelConfig(backend="pallas_interpret", **arm))):
        eng = Engine(params, cfg, family_for("llama"),
                     EngineConfig(n_slots=2, max_seq=512, prefill_buckets=(32, 512),
                                  cache_dtype=torch.float32, kernels=kernels, **kw), device=dev)
        eng.prefill(0, prompts[1])
        logits.append(eng._prefill_logits[0].float().cpu())
        eng.release(0)
        reqs = [Request(request_id=i, prompt_ids=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        ContinuousBatcher(eng).run(reqs)
        streams.append([q.output_ids for q in reqs])
    assert (logits[0] - logits[1]).abs().max() <= 5e-3 * logits[1].abs().max()
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# the x preparation of the int8 path (csrc/pb_prep_int8.cu)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LAYERS) + ["shards8", "shards4", "fused3"])
@pytest.mark.parametrize("m", [1, 8, 300])
@pytest.mark.parametrize("layout", ["dp4a", "tc"])
def test_prep_int8_kernel_matches_plain_bit_for_bit(cuda, name, m, layout):
    """Codes and scales bit for bit (IEEE division, rint half to even), in
    either int8 arm's layout; the f64 row sums, rounded once to f32, within
    `sum_bound` of the plain f32 sums."""
    p = _arm_layer(name, cuda)
    x = torch.randn((m, p.ic), generator=torch.Generator(device=cuda).manual_seed(m), device=cuda)
    x[0, :7] = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 0.0, 3.0], device=cuda)  # ties at sx = 1/42.33
    if m > 1:
        x[1] = 0.0  # an all-zero row: sx = 1e-30 / 127
    before = packed_matmul.prep_launches
    got = packed_matmul.prepare_int8(x, p, layout)
    torch.cuda.synchronize()
    assert packed_matmul.prep_launches == before + 1
    want = packed_matmul.prepare_int8_plain(x, p, layout)
    for f in ("x8", "sx", "xg8"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    xg = pbw.gather_x_v2(x, p).permute(2, 0, 1)
    assert torch.all((got.rs - want.rs).abs() <= packed_matmul.sum_bound(x, 1))
    assert torch.all((got.rsg - want.rsg).abs() <= packed_matmul.sum_bound(xg, 2))


@pytest.mark.cuda
def test_prep_int8_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(packed_matmul, "prepare_int8_plain", refuse)
    p = _layer("side8", cuda)

    def counts():
        return (packed_matmul.prep_launches, packed_matmul.launches + packed_matmul.tc_launches
                + packed_matmul.split_launches)

    for m in (4, 300):  # both arms
        before = counts()
        y = packed_matmul.pb_int8_matmul(torch.randn((m, p.ic), device=cuda), p)
        torch.cuda.synchronize()
        assert y.shape == (m, p.oc)
        assert counts() == (before[0] + 1, before[1] + 1)


# ---------------------------------------------------------------------------
# paged attention's window arm on the tensor cores
# ---------------------------------------------------------------------------

WINDOW_CASES = {
    # name: (t, Hq, Hkv, D, page, bases)
    "verify_t5": (5, 32, 32, 128, 16, (507, 0, -1, 31, 256)),
    "chunk_t256": (256, 8, 8, 128, 16, (1024, 256, -1)),
    "gqa4_t17": (17, 16, 4, 128, 16, (64, 15, -1, 300)),
    "gqa8_t64_page8": (64, 32, 4, 64, 8, (0, 7, 127, -1)),
    "t3_d48_page8": (3, 4, 2, 48, 8, (16, 3, -1)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("name", sorted(WINDOW_CASES))
def test_paged_window_tensor_core_arm_matches_plain(cuda, name, kind):
    """The tensor-core arm against the plain version (rtol = atol = 2e-5,
    the JAX oracle's bound, and the CUDA-core arm's rtol 1e-4, atol 1e-5)
    over ragged bases (an empty slot at -1, windows that start on a page
    boundary), with every table entry past a slot's limit naming the trash
    page, whose rows (and every page no window reads) hold NaN."""
    from pb_llm_tpu_torch.ops import paged_attention as tpa

    t, hq, hkv, d, ps, bases = WINDOW_CASES[name]
    if kind == "int8" and d % 16:
        pytest.skip("int8 pages take head dims that are multiples of 16")
    b, n_pages = len(bases), 400
    maxp = -(-(max(bases) + t) // ps) + 2
    g = torch.Generator(device=cuda).manual_seed(t + d)
    kp, vp, ks, vs = _paged_pool(n_pages, hkv, ps, d, kind, g)
    trash = n_pages
    table = torch.full((b, maxp), trash, dtype=torch.int32, device=cuda)
    perm = torch.randperm(n_pages, generator=g, device=cuda).to(torch.int32)
    used = 0
    for i, bs in enumerate(bases):
        n = -(-(bs + t) // ps) if bs + t > 0 else 0
        table[i, :n] = perm[used : used + n]
        used += n
    unused = torch.ones(n_pages + 1, dtype=torch.bool, device=cuda)
    unused[perm[:used].long()] = False
    if kind == "int8":
        ks[unused], vs[unused] = float("nan"), float("nan")
    else:
        kp[unused], vp[unused] = float("nan"), float("nan")
    base = torch.tensor(bases, device=cuda)
    q = torch.randn((b, t, hq, d), generator=g, device=cuda)
    qs, bs = (q * d ** -0.5).contiguous(), base.to(torch.int32)
    before = tpa.window_launches
    got = tpa.launch(qs, kp, vp, table, bs, ks, vs, _arm_for_timing=tpa.TENSOR_CORES)
    torch.cuda.synchronize()
    assert tpa.window_launches == before + 1
    want = tpa.paged_attention_plain(q, kp, vp, table, base, d ** -0.5, ps, ks, vs)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got[base < 0][:, 0], torch.zeros_like(got[base < 0][:, 0]))
    old = tpa.launch(qs, kp, vp, table, bs, ks, vs, _arm_for_timing=tpa.CUDA_CORES)
    torch.testing.assert_close(got, old, rtol=2e-5, atol=2e-5)
    before = (tpa.window_launches, tpa.multi_launches)
    routed = tpa.paged_attention_multi(q, kp, vp, table, base, d ** -0.5, ps, ks, vs)
    tc = tpa.window_arm(t, kp.dtype) == tpa.TENSOR_CORES
    assert (tpa.window_launches, tpa.multi_launches) == (before[0] + tc, before[1] + 1)
    assert torch.equal(routed, got if tc else old)


@pytest.mark.cuda
def test_window_arm_follows_the_rule(cuda):
    from pb_llm_tpu_torch.ops import paged_attention as tpa

    assert tpa.window_arm(5, torch.int8) == tpa.window_arm(256, torch.bfloat16) == tpa.TENSOR_CORES
    for dt in (torch.int8, torch.bfloat16, torch.float32):
        assert tpa.window_arm(1, dt) == tpa.window_arm(1, dt, 8, 64) == tpa.SPLIT
        assert tpa.window_arm(1, dt, 16) == tpa.window_arm(1, dt, 1, 12) == tpa.CUDA_CORES
    assert tpa.window_arm(5, torch.float32) == tpa.CUDA_CORES
    g = torch.Generator(device=cuda).manual_seed(3)
    kp, vp, ks, vs = _paged_pool(8, 2, 16, 64, "f32", g)
    table = torch.arange(8, device=cuda, dtype=torch.int32).reshape(2, 4)
    before = tpa.window_launches
    tpa.paged_attention_multi(torch.randn((2, 3, 4, 64), device=cuda), kp, vp, table,
                              torch.tensor([3, 9], device=cuda), 0.1, 16, ks, vs)
    torch.cuda.synchronize()
    assert tpa.window_launches == before


# ---------------------------------------------------------------------------
# the decode step as one CUDA graph (runtime/step_graph.py)
# ---------------------------------------------------------------------------

GRAPH_CASES = {
    "int8_strips": dict(),
    "q8_strips": dict(decode_attention="pallas_q8"),
    "bf16_strips": dict(cache_dtype=torch.bfloat16),
    "f32_strips_f32_arm": dict(cache_dtype=torch.float32, decode_dot="f32"),
    "int8_pages_prefix": dict(page_size=16, prefix_cache=True),
    "bf16_pages": dict(page_size=16, cache_dtype=torch.bfloat16),
    "scan": dict(scan_layers=True),
    "scan_pages": dict(scan_layers=True, page_size=16),
    "fuse_pair": dict(fuse_linears=True, decode_dot="pair"),
    "dma": dict(decode_dot="dma"),
}


def _graph_run(cuda, kw, mode):
    """A scripted run on a tiny PBW-v2 llama: slots admitted and released
    between decode steps.  Returns (tokens, per-step logits, launches)."""
    from pb_llm_tpu_torch.data.synthetic import random_packed_llama
    from pb_llm_tpu_torch.models.llama import LlamaConfig
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.ops import counters
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig
    from pb_llm_tpu_torch.runtime import step_graph
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    kw = dict(kw)
    arms = {k: kw.pop(k) for k in ("decode_dot", "decode_attention") if k in kw}
    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=512)
    params = random_packed_llama(cfg, torch.Generator().manual_seed(0))
    eng = Engine(params, cfg, family_for("llama"),
                 EngineConfig(n_slots=3, max_seq=256, prefill_buckets=(32, 128),
                              kernels=KernelConfig(**arms), **kw), device=cuda)
    r = np.random.default_rng(1)
    prefix = r.integers(0, 256, 32).tolist()
    prompts = [prefix + r.integers(0, 256, n).tolist() for n in (5, 40, 12, 70, 20)]
    toks, logits = [], []
    step = eng._step_logits

    def recorded():  # each decode step's active rows, copied before the next step
        out = step()
        logits.append(out.cpu()[torch.from_numpy(eng.active)])
        return out

    eng._step_logits = recorded
    plan = [("admit", 0, 0), ("admit", 1, 1), ("steps", 5), ("release", 0), ("admit", 0, 2),
            ("steps", 6), ("release", 1), ("admit", 2, 3), ("steps", 4), ("release", 2),
            ("admit", 1, 4), ("steps", 3)]
    before = counters.read()
    with step_graph.eager() if mode == "eager" else contextlib.nullcontext():
        for op in plan:
            if op[0] == "admit":
                toks.append({op[1]: eng.prefill(op[1], prompts[op[2]])})
            elif op[0] == "release":
                eng.release(op[1])
            else:
                toks += [eng.decode_step() for _ in range(op[1])]
    torch.cuda.synchronize()
    after = counters.read()
    return toks, logits, {k: after[k] - before[k] for k in after}, eng._step.replays


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAPH_CASES))
def test_step_graph_equals_eager(cuda, name):
    """The graphed decode step against `step_graph.eager()`: the same greedy
    tokens, bitwise-equal logits of the active slots (an inactive slot's
    row reads the trash page, where inactive slots' duplicate writes land
    in no fixed order), the same launches by kind."""
    got = _graph_run(cuda, GRAPH_CASES[name], "graph")
    want = _graph_run(cuda, GRAPH_CASES[name], "eager")
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert got[2] == want[2]
    assert got[3] > 0 and want[3] == 0


@pytest.mark.cuda
def test_step_graph_capture_that_meets_a_host_sync_raises(cuda, monkeypatch):
    """A decode forward that reads a device value on the host cannot be
    captured: the capture raises, and no step falls back to eager."""
    from pb_llm_tpu_torch.models import llama
    from pb_llm_tpu_torch.models.llama import LlamaConfig, init_params
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg = LlamaConfig(vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                      num_attention_heads=4, max_position_embeddings=256)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(params, cfg, family_for("llama"),
                 EngineConfig(n_slots=2, max_seq=128, prefill_buckets=(32, 128)), device=cuda)
    eng.prefill(0, [1, 2, 3])
    norm = llama.rms_norm

    def syncing(x, w, eps):
        if float(x.abs().max()) < 0:  # a host read of a device value
            raise AssertionError
        return norm(x, w, eps)

    monkeypatch.setattr(llama, "rms_norm", syncing)
    eng.decode_step()  # the eager first step: a host read is allowed there
    with pytest.raises(RuntimeError):
        eng.decode_step()  # captures
    assert eng._step.graph is None


PREFILL_SHAPES = [(bucket, k) for bucket in (32, 128, 512) for k in (1, 3, 4)]


def _padded_bytes(t: torch.Tensor) -> int:
    return -(-t.numel() * t.element_size() // 512) * 512  # the allocator's 512-byte blocks


@pytest.mark.cuda
def test_prefill_graphs_equal_eager(cuda):
    """Each bucket x K = 1, 3, 4 of the strip prefill on a PBW-v2 llama with
    int8 strips: the shape's second call, a replay of the graph its first
    call captured, against the same prompts under `step_graph.eager()`:
    the same first tokens, strip rows and scales, logits bit for bit (the
    same kernels on the same inputs).  The captures leave allocated no more
    than the shapes' static buffers and outputs."""
    from pb_llm_tpu_torch.data.synthetic import random_packed_llama
    from pb_llm_tpu_torch.models.llama import LlamaConfig
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.runtime import step_graph
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    cfg = LlamaConfig(vocab_size=256, hidden_size=512, intermediate_size=1024,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
                      max_position_embeddings=1024)  # GQA 4:1, head dim 128, as Mistral's
    params = random_packed_llama(cfg, torch.Generator().manual_seed(0))
    eng = Engine(params, cfg, family_for("llama"),
                 EngineConfig(n_slots=4, max_seq=1024, prefill_buckets=(32, 128, 512)),
                 device=cuda)
    assert eng.cache_dtype == torch.int8
    r = np.random.default_rng(3)

    def pairs(bucket, k):
        lens = r.integers(bucket // 4 + 1, bucket + 1, k)
        return [(int(s), r.integers(0, 256, int(n)).tolist())
                for s, n in zip(r.permutation(4)[:k], lens)]

    def run(call):
        toks = eng.prefill_batch(call)
        bucket = eng._bucket(max(len(p) for _, p in call))
        logits = {s: eng._prefill_logits[s].cpu() for s, _ in call}
        rows = {s: [{n: c[n][s, :bucket].cpu() for n in c} for c in eng.caches] for s, _ in call}
        for s, _ in call:
            eng.release(s)
        return toks, logits, rows

    calls = {shape: (pairs(*shape), pairs(*shape)) for shape in PREFILL_SHAPES}
    with step_graph.eager():
        want = {shape: run(calls[shape][1]) for shape in PREFILL_SHAPES}
    assert eng.counts.graph_captures == 0 and not eng._prefill.shapes
    # a process's first captures allocate what every later one shares (the
    # CUDA generator's graph-safe seed and offset, cuBLAS's workspace on the
    # capture stream, 32 MiB): make them here
    first, a = torch.cuda.CUDAGraph(), torch.ones((2, 8, 8), device=cuda)
    with torch.cuda.graph(first):
        torch.bmm(a, a) @ a[0]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    got = {}
    for shape in PREFILL_SHAPES:
        run(calls[shape][0])  # eager, then captured
        got[shape] = run(calls[shape][1])  # replayed
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated(cuda) - before
    assert eng.counts.graph_captures == eng.counts.prefill_replays == len(PREFILL_SHAPES)
    for shape in PREFILL_SHAPES:
        (gt, gl, gr), (wt, wl, wr) = got[shape], want[shape]
        assert gt == wt, shape
        assert all(torch.equal(gl[s], wl[s]) for s in wl), shape
        assert all(torch.equal(g[n], w[n]) for s in wr for g, w in zip(gr[s], wr[s]) for n in w)
    static = sum(_padded_bytes(s.buf) + _padded_bytes(s.logits)
                 for s in eng._prefill.shapes.values())
    assert 0 < grown <= static, (grown, static)


# ---------------------------------------------------------------------------
# the bf16 tensor-core arms of the pair and exact f32 kernels (pb_bf16_tc.cuh)
# ---------------------------------------------------------------------------

TC_LAYERS = ["side8", "side4", "rowgroups", "multiblock", "shards8", "shards4", "fused3"]


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["split", "tc"])
@pytest.mark.parametrize("name", TC_LAYERS)
@pytest.mark.parametrize("m", [1, 8, 16, 17, 100, 255])
def test_pair_tensor_core_arms_match_plain(cuda, name, m, arm):
    """Either tensor-core arm on "tc" operands: within 1e-5 of max|y| of
    the plain version on the same operands and of the plain version of x
    (x rounds to bf16 on both sides; only the f32 sum order differs)."""
    from pb_llm_tpu_torch.ops import decode_arms

    p = _arm_layer(name, cuda)
    x = torch.randn((m, p.ic), generator=torch.Generator(device=cuda).manual_seed(m), device=cuda)
    ops = decode_arms.prepare_pair(x, p, "tc")
    counter = _PAIR_COUNTER[arm]
    before = getattr(decode_arms, counter)
    got = decode_arms.launch_pair(ops, p, arm)
    torch.cuda.synchronize()
    assert getattr(decode_arms, counter) == before + 1
    want = decode_arms.pb_pair_v2_plain(x, p)
    assert torch.isfinite(got).all()
    assert (got - decode_arms.pair_matmul_plain(ops, p)).abs().max() <= 1e-5 * want.abs().max()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("ic,oc", [(4096, 11008), (11008, 4096)])
@pytest.mark.parametrize("m", [8, 128, 255])
def test_pair_arms_at_llama_width(cuda, ic, oc, m):
    """llama-7b's MLP shapes (ic = 11008 packs in blocks of 1376): the
    three arms against the plain version, and the split arm the same bits
    on two runs."""
    from pb_llm_tpu_torch.ops import decode_arms

    g = torch.Generator(device=cuda).manual_seed(ic + m)
    p = random_packed_v2(ic, oc, g, low_frac=0.9)
    x = torch.randn((m, ic), generator=g, device=cuda)
    want = decode_arms.pb_pair_v2_plain(x, p)
    tc = decode_arms.prepare_pair(x, p, "tc")
    outs = {"mma": decode_arms.launch_pair(decode_arms.prepare_pair(x, p), p),
            "split": decode_arms.launch_pair(tc, p, "split"),
            "tc": decode_arms.launch_pair(tc, p, "tc")}
    again = decode_arms.launch_pair(tc, p, "split")
    torch.cuda.synchronize()
    for arm, got in outs.items():
        assert (got - want).abs().max() <= 1e-5 * want.abs().max(), arm
    assert torch.equal(outs["split"], again)


@pytest.mark.cuda
def test_pair_split_arm_is_deterministic_and_graph_safe(cuda):
    """The split arm's ranges add in a fixed order: the same bits on every
    run, and under a CUDA graph's replay."""
    from pb_llm_tpu_torch.ops import decode_arms

    p = _arm_layer("fused3", cuda)
    x = torch.randn((8, p.ic), generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    first = decode_arms.pb_pair_v2(x, p)
    assert decode_arms.pair_arm(8, p) == "split" and decode_arms.pair_ksplit(p) > 1
    runs = [decode_arms.pb_pair_v2(x, p) for _ in range(5)]
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            captured = decode_arms.pb_pair_v2(x, p)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(first, r) for r in runs)
    assert torch.equal(first, captured)


@pytest.mark.cuda
@pytest.mark.parametrize("dot_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", TC_LAYERS[:-1])
@pytest.mark.parametrize("m", [32, 100, 256, 300, 513])
def test_f32_tensor_core_arm_matches_plain(cuda, name, m, dot_dtype):
    """The tensor-core arm (three bf16 terms for f32, one for bf16) through
    the wrapper from F32_TC rows on: within rtol = atol = 1e-4 of the plain
    version, the JAX package's bound for its f32 kernel."""
    p = _layer(name, cuda)
    x = torch.randn((m, p.ic), generator=torch.Generator(device=cuda).manual_seed(m), device=cuda)
    assert packed_matmul.f32_arm(m, p) == "tc"
    before = packed_matmul.f32_tc_launches
    got = packed_matmul.pb_f32_matmul(x, p, dot_dtype=dot_dtype)
    torch.cuda.synchronize()
    assert packed_matmul.f32_tc_launches == before + 1
    ops = packed_matmul.prepare_tc(x, p, packed_matmul.terms_of(dot_dtype))
    torch.testing.assert_close(got, packed_matmul.tc_matmul_plain(ops, p), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, packed_matmul.pb_f32_matmul_plain(x, p, dot_dtype=dot_dtype),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("col_tile", [0, 256])
@pytest.mark.parametrize("ic,oc", [(4096, 4096), (4096, 11008), (11008, 4096)])
def test_f32_tensor_core_arm_at_llama_width(cuda, ic, oc, col_tile):
    """m = 512 on llama-7b's shapes, global selection and row groups of 256."""
    g = torch.Generator(device=cuda).manual_seed(ic + oc + col_tile)
    p = random_packed_v2(ic, oc, g, low_frac=0.9, col_tile=col_tile)
    x = torch.randn((512, ic), generator=g, device=cuda)
    assert packed_matmul.f32_arm(512, p) == "tc"
    got = packed_matmul.pb_f32_matmul(x, p)
    torch.testing.assert_close(got, packed_matmul.pb_f32_matmul_plain(x, p), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("side_bits", [8, 4])
@pytest.mark.parametrize("m", [32, 100, 256])
def test_stacked_f32_tensor_core_arm_equals_flat(cuda, side_bits, m):
    """The stacked entry's tensor-core arm on every layer: the flat arm's
    bits on the same operands, and the plain version within 1e-4."""
    layers, markers = _stacked(cuda, side_bits)
    x = torch.randn((m, 512), generator=torch.Generator(device=cuda).manual_seed(m), device=cuda)
    for p, mk in zip(layers, markers):
        ops = packed_matmul.prepare_tc(x, p, 3)
        before = packed_matmul.stacked_f32_tc_launches
        got = packed_matmul.launch_f32_stacked(ops, mk)
        torch.cuda.synchronize()
        assert packed_matmul.stacked_f32_tc_launches == before + 1
        assert torch.equal(got, packed_matmul.launch_f32_tc(ops, p))
        torch.testing.assert_close(got, packed_matmul.pb_f32_matmul_stacked_plain(x, mk),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_tensor_core_arms_refuse_what_they_cannot_take(cuda):
    """Tensor-core operands on a layout the arms do not take raise before
    anything launches: no silent fallback."""
    from pb_llm_tpu_torch.ops import decode_arms

    p = _layer("side4_rowgroups", cuda)  # col_tile 64 splits a 128-column tile
    x = torch.randn((40, p.ic), device=cuda)
    assert decode_arms.pair_arm(40, p) == "mma" and packed_matmul.f32_arm(40, p) == "cores"
    with pytest.raises(ValueError, match="tensor-core arm does not take"):
        decode_arms.launch_pair(decode_arms.prepare_pair(x, p, "tc"), p, "tc")
    with pytest.raises(ValueError, match="tensor-core arm does not take"):
        packed_matmul.launch_f32_tc(packed_matmul.prepare_tc(x, p, 3), p)
    low2 = _lowbit_layer(256, 384, 2, cuda)
    with pytest.raises(ValueError, match="tensor-core arm does not take"):
        packed_matmul.launch_f32_tc(packed_matmul.prepare_tc(torch.randn((40, 256), device=cuda),
                                                             low2, 3), low2)
    with pytest.raises(ValueError, match="does not take"):
        decode_arms.launch_pair(decode_arms.prepare_pair(x, p), p, "tc")
    with pytest.raises(ValueError, match="tensor-core arm does not take"):
        packed_matmul.launch_f32_split(packed_matmul.prepare_split(x[:8].contiguous(), p), p)


# ---------------------------------------------------------------------------
# paged decode's arm "split" and the exact f32 arm "split" (dma's device code)
# ---------------------------------------------------------------------------

# name: (B, Hq, Hkv, D, page, n_pages, maxp, bases)
SPLIT_CASES = {
    "mha_page16": (8, 32, 32, 128, 16, 1024, 128, "len<=512"),
    "gqa4_page16": (8, 32, 8, 128, 16, 1024, 128, "len<=512"),
    "gqa2_page8_d64": (4, 8, 4, 64, 8, 200, 40, (-1, 0, 63, 319)),
    "g3_page128_d96": (3, 6, 2, 96, 128, 12, 4, (511, 128, 5)),  # 64-key chunks in a page
    "g8_page5_d40": (3, 16, 2, 40, 5, 90, 20, (99, 4, 60)),      # 25 pages of 5 a split
}


def _split_operands(name, kind, dev):
    """A shuffled table over a pool whose every page no slot reads, and
    each slot's table entries past its last live page (the trash page),
    hold NaN (values, or the scales of int8 pages)."""
    b, hq, hkv, d, ps, n_pages, maxp, bases = SPLIT_CASES[name]
    g = torch.Generator(device=dev).manual_seed(len(name) + len(kind))
    kp, vp, ks, vs = _paged_pool(n_pages, hkv, ps, d, kind, g)
    if bases == "len<=512":
        base = torch.randint(0, 512, (b,), generator=g, device=dev)
        base[0] = 511
    else:
        base = torch.tensor(bases, device=dev)
    table = torch.full((b, maxp), n_pages, dtype=torch.int32, device=dev)  # the trash page
    perm = torch.randperm(n_pages, generator=g, device=dev).to(torch.int32)
    used = 0
    for i, bs in enumerate(base.tolist()):
        n = -(-(bs + 1) // ps) if bs >= 0 else 0
        table[i, :n] = perm[used: used + n]
        used += n
    unused = torch.ones(n_pages + 1, dtype=torch.bool, device=dev)
    unused[perm[:used].long()] = False
    if kind == "int8":
        ks[unused], vs[unused] = float("nan"), float("nan")
    else:
        kp[unused], vp[unused] = float("nan"), float("nan")
    q = torch.randn((b, hq, d), generator=g, device=dev)
    return q, kp, vp, ks, vs, table, base, ps


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_paged_split_arm_matches_plain(cuda, name, kind):
    """The decode arm "split" against `split_plain` and the
    window plain version (rtol 1e-4, atol 1e-5, the paged kernel's bound),
    on every page type, MHA and GQA (G 1-8), pages of 5-128 keys, an empty
    slot (length 0), with NaN in every page past a slot's last live key's
    page; the routed decode call takes the arm and equals it bit for bit."""
    from pb_llm_tpu_torch.ops import paged_attention as tpa

    q, kp, vp, ks, vs, table, base, ps = _split_operands(name, kind, cuda)
    if kind == "int8" and q.shape[2] % 16:
        pytest.skip("int8 pages take head dims that are multiples of 16")
    scale = q.shape[2] ** -0.5
    qs = (q[:, None] * scale).contiguous()
    before = (tpa.split_launches, tpa.decode_launches)
    got = tpa.launch(qs, kp, vp, table, base.to(torch.int32), ks, vs, decode=True,
                     _arm_for_timing=tpa.SPLIT)[:, 0]
    torch.cuda.synchronize()
    assert (tpa.split_launches, tpa.decode_launches) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(got).all()
    want = tpa.split_plain(q, kp, vp, table, base + 1, scale, ps, ks, vs)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    plain = tpa.paged_attention_plain(q[:, None], kp, vp, table, base, scale, ps, ks, vs)[:, 0]
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-5)
    if (base < 0).any():
        assert not got[base < 0].any()
    assert tpa.window_arm(1, kp.dtype, q.shape[1] // kp.shape[1], q.shape[2]) == tpa.SPLIT
    routed = tpa.paged_attention(q, kp, vp, table, base + 1, scale, ps, ks, vs)
    assert torch.equal(routed, got)
    old = tpa.launch(qs, kp, vp, table, base.to(torch.int32), ks, vs, decode=True,
                     _arm_for_timing=tpa.CUDA_CORES)[:, 0]
    torch.testing.assert_close(got, old, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_paged_split_arm_under_a_graph_equals_eager(cuda, kind):
    """Captured once, replayed with other lengths (more and fewer splits,
    an empty slot): each replay equals an eager launch bit for bit (a grid
    and workspace fixed by the table's width, splits merged in order)."""
    from pb_llm_tpu_torch.ops import paged_attention as tpa

    q, kp, vp, ks, vs, table, base, ps = _split_operands("gqa4_page16", kind, cuda)
    lengths = (base + 1).clone()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        tpa.paged_attention(q, kp, vp, table, lengths, 0.125, ps, ks, vs)  # warm-up
        with torch.cuda.graph(graph, stream=stream):
            captured = tpa.paged_attention(q, kp, vp, table, lengths, 0.125, ps, ks, vs)
    torch.cuda.current_stream().wait_stream(stream)
    for new in ((base + 1) // 3, base + 1, torch.zeros_like(base)):
        lengths.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        eager = tpa.paged_attention(q, kp, vp, table, new, 0.125, ps, ks, vs)
        assert torch.equal(captured, eager)


F32_SPLIT_LAYERS = ["side8", "side4", "rowgroups", "multiblock", "shards8", "shards4", "fused3"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", F32_SPLIT_LAYERS)
def test_f32_split_arm_matches_plain(cuda, name):
    """The exact f32 kernel below F32_TC rows (m = 1-31) through the wrapper
    on the "split" arm: within rtol = atol = 1e-4 of the plain version and
    of the plain version on its operands, on one and several row groups
    (fused q|k|v, groups of 128) and nibble / sharded sidecars; a row's
    bits the same at every m (the K split reads the shape alone)."""
    p = _arm_layer(name, cuda)
    x = torch.randn((31, p.ic), generator=torch.Generator(device=cuda).manual_seed(4), device=cuda)
    full = None
    for m in (31, 1, 8, 9, 16, 17):
        assert packed_matmul.f32_arm(m, p) == "split"
        xm = x[:m].contiguous()
        before = (packed_matmul.f32_split_launches, packed_matmul.split_prep_launches)
        got = packed_matmul.pb_f32_matmul(xm, p)
        torch.cuda.synchronize()
        assert (packed_matmul.f32_split_launches, packed_matmul.split_prep_launches) == (
            before[0] + 1, before[1] + 1)
        torch.testing.assert_close(got, packed_matmul.pb_f32_matmul_plain(xm, p),
                                   rtol=1e-4, atol=1e-4)
        ops = packed_matmul.prepare_split(xm, p)
        assert ops.layout == "split"
        torch.testing.assert_close(got, packed_matmul.tc_matmul_plain(ops, p), rtol=1e-4,
                                   atol=1e-4)
        full = got if full is None else full
        assert torch.equal(got, full[:m]), m


@pytest.mark.cuda
@pytest.mark.parametrize("side_bits", [8, 4])
def test_stacked_f32_split_arm_equals_flat(cuda, side_bits):
    """The stacked entry's arm "split" on every layer at decode rows: the
    flat arm's bits on the same operands (one device code, li read on the
    card), the plain version within 1e-4, and the wrapper's pick."""
    layers, markers = _stacked(cuda, side_bits)
    x = torch.randn((8, 512), generator=torch.Generator(device=cuda).manual_seed(8), device=cuda)
    for p, mk in zip(layers, markers):
        assert packed_matmul.f32_arm(8, p) == "split"
        ops = packed_matmul.prepare_split(x, p)
        before = packed_matmul.stacked_f32_split_launches
        got = packed_matmul.launch_f32_stacked(ops, mk)
        torch.cuda.synchronize()
        assert packed_matmul.stacked_f32_split_launches == before + 1
        assert torch.equal(got, packed_matmul.launch_f32_split(ops, p))
        assert torch.equal(got, packed_matmul.pb_f32_matmul_stacked(x, mk))
        torch.testing.assert_close(got, packed_matmul.pb_f32_matmul_stacked_plain(x, mk),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 31])
@pytest.mark.parametrize("ic,oc", [(4096, 4096), (4096, 11008), (11008, 4096)])
def test_dma_and_f32_split_are_one_code(cuda, ic, oc, m):
    """At one row group the dma kernel's arm "split" and the exact f32
    kernel's arm "split" are the same launch: equal bit for bit."""
    from pb_llm_tpu_torch.ops import decode_arms

    g = torch.Generator(device=cuda).manual_seed(ic + oc + m)
    p = random_packed_v2(ic, oc, g, low_frac=0.9)
    x = torch.randn((m, ic), generator=g, device=cuda)
    assert decode_arms.dma_arm(p) == "split" and packed_matmul.f32_arm(m, p) == "split"
    assert torch.equal(decode_arms.pb_dma_v2(x, p), packed_matmul.pb_f32_matmul(x, p))


@pytest.mark.cuda
def test_hf_dir_converts_on_the_card_as_on_the_cpu(cuda, tmp_path):
    """A 2-layer hidden-128 HF directory written by the port (torch alone,
    sharded fp16 bins), converted by `hf_stream` on the card and on the
    CPU: every field of every packed linear bit for bit (the selection sums
    in a fixed order, `quant.reduce.tree_sum`, and the rest is elementwise)."""
    from pb_llm_tpu_torch.data.synthetic import write_hf_checkpoint
    from pb_llm_tpu_torch.models import hf_stream, llama

    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=352,
                            num_hidden_layers=2, num_attention_heads=4,
                            max_position_embeddings=256)
    params = llama.init_params(cfg, torch.Generator().manual_seed(30), device="cpu")
    d = write_hf_checkpoint(params, cfg, "llama", str(tmp_path / "llama-128"),
                            max_shard_bytes=200_000)
    out = {}
    for dev in ("cuda", "cpu"):
        hf_stream.stream_pack_to_pbw(d, str(tmp_path / dev), "llama",
                                     pack_fn=hf_stream.rtn_pack_fn(device=dev))
        out[dev], _ = pbw.load_pbw(str(tmp_path / dev))
    assert len(out["cpu"]) == 14 and set(out["cuda"]) == set(out["cpu"])
    for key, want in out["cpu"].items():
        got = out["cuda"][key]
        for f in pbw.fields_of(want):
            if getattr(want, f) is not None:
                assert torch.equal(getattr(got, f), getattr(want, f)), (key, f)


# QAT on the card: one trainer step and a few, card = CPU at a tiny size.
# The QAT matmuls are plain f32 products with TF32 off (cuBLAS against the
# CPU's BLAS: another summation order), the STE and fake-quant elementwise,
# the binary scale an f64 sum (the same on both): masks and sim-8bit
# masters bit for bit, losses within 1e-5, weights within 1e-5 (0.2% of one
# lr-5e-3 step), the frozen tensors bit-unchanged.
QAT_LOSS_ATOL = QAT_PARAM_ATOL = 1e-5


def _qat_llama(max_pos=256):
    from pb_llm_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                            max_position_embeddings=max_pos)
    return cfg, llama.init_params(cfg, torch.Generator().manual_seed(40), device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 4])
def test_qat_train_steps_card_equal_cpu(cuda, steps):
    from pb_llm_tpu_torch.interop import to_device
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.train import qat as tq

    cfg, params = _qat_llama()
    fam = family_for("llama")
    qcfg = tq.QATConfig(outlier_fraction=0.1, train_steps=4, learning_rate=5e-3, remat=True)
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, 512, size=(2, 64))} for _ in range(steps)]
    out = {}
    for dev in ("cpu", "cuda"):
        p = tq.replace_linears(to_device(params, dev), fam, qcfg)
        masters = [(q.weight.detach().clone(), q.outlier_mask.clone()) for q in tq.qat_linears(p)]
        opt, sched = tq.make_optimizer(qcfg, p)
        step = tq.make_train_step(cfg, fam, qcfg, opt, sched)
        losses = [float(step(p, {k: torch.as_tensor(v, device=dev) for k, v in b.items()}))
                  for b in batches]
        out[dev] = (p, masters, losses)
    (cp, cm, cl), (gp, gm, gl) = out["cpu"], out["cuda"]
    for (cw, cmask), (gw, gmask) in zip(cm, gm):
        assert torch.equal(gw.cpu(), cw) and torch.equal(gmask.cpu(), cmask)
    np.testing.assert_allclose(gl, cl, rtol=0, atol=QAT_LOSS_ATOL)
    for cq, gq in zip(tq.qat_linears(cp), tq.qat_linears(gp)):
        np.testing.assert_allclose(gq.weight.detach().cpu().numpy(), cq.weight.detach().numpy(),
                                   rtol=0, atol=QAT_PARAM_ATOL)
    for name in ("embed_tokens", "norm"):
        assert torch.equal(gp[name].cpu(), params[name])
    assert torch.equal(gp["lm_head"]["w"].cpu(), params["lm_head"]["w"])


@pytest.mark.cuda
def test_flash_raises_under_grad_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(41)
    q, k, v = (torch.randn(1, 1024, 4, 64, generator=gen, device=cuda) for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_attention(q, k, v.requires_grad_(), 0.125, causal=True)
    with torch.no_grad():
        assert torch.isfinite(tfa.flash_attention(q, k, v, 0.125, causal=True)).all()


@pytest.mark.cuda
def test_qat_qkv_gradients_at_long_windows(cuda):
    """At T = 1024 "auto" sends a forward on the card to the flash kernel,
    which has no backward: a QAT forward under grad outside the trainer
    raises; the trainer's step takes the masked softmax, and q_proj, k_proj
    and v_proj get nonzero gradients, within 1e-4 of the CPU's of max|g|."""
    from pb_llm_tpu_torch.interop import to_device
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.train import qat as tq

    cfg, params = _qat_llama(max_pos=2048)
    fam = family_for("llama")
    qcfg = tq.QATConfig(outlier_fraction=0.1, train_steps=4, learning_rate=5e-3)
    ids = np.random.default_rng(1).integers(0, 512, size=(1, 1024))
    grads = {}
    for dev in ("cpu", "cuda"):
        p = tq.replace_linears(to_device(params, dev), fam, qcfg)
        if dev == "cuda":
            with pytest.raises(RuntimeError, match="no backward"):
                fam.forward(p, torch.as_tensor(ids, device=dev), cfg, linear_fn=tq.qat_linear_fn)
        opt, sched = tq.make_optimizer(qcfg, p)
        tq.make_train_step(cfg, fam, qcfg, opt, sched)(p, {"input_ids": torch.as_tensor(ids,
                                                                                      device=dev)})
        grads[dev] = [p["layers"][i][n].weight.grad.cpu() for i in range(2)
                      for n in ("q_proj", "k_proj", "v_proj")]
    for g, c in zip(grads["cuda"], grads["cpu"]):
        assert g.abs().max() > 0
        np.testing.assert_allclose(g.numpy(), c.numpy(), rtol=0, atol=1e-4 * c.abs().max().item())
