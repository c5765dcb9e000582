"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The kernels have no CPU mode, so every test here carries the `cuda` marker
and skips without a card.  The file imports no JAX (the machine with the
card has none), so it runs there without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the int8 matmul accumulates exactly in int32 and its f32
epilogue rounds once per operation in the plain version's order, so the two
agree bit for bit.  Decode attention sums in another order than the plain
version (online softmax over warps): rtol 1e-4, atol 1e-5.
"""

import numpy as np
import pytest
import torch

from pb_llm_tpu_torch.core import pbw
from pb_llm_tpu_torch.data.synthetic import random_packed_v2
from pb_llm_tpu_torch.ops import decode_attention as tda
from pb_llm_tpu_torch.ops import packed_matmul

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


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LAYERS) + ["shards8", "shards4"])
@pytest.mark.parametrize("m", [1, 8, 300])
def test_int8_matmul_kernel_matches_plain(cuda, name, m):
    p = _layer(name, cuda)
    x = torch.randn((m, p.ic), generator=torch.Generator(device=cuda).manual_seed(m), device=cuda)
    before = packed_matmul.launches
    got = packed_matmul.pb_int8_matmul(x, p)
    torch.cuda.synchronize()
    assert packed_matmul.launches == before + 1
    want = packed_matmul.pb_int8_matmul_plain(x, p)
    assert torch.equal(got, want), (got - want).abs().max()


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
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 128), (4, 4, 64), (6, 1, 96)])
def test_decode_attention_kernel_matches_plain(cuda, quantized, hq, hkv, d):
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
    before = tda.launches
    got = tda.decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert tda.launches == before + 1
    want = tda.decode_attention_plain(*args, **kw)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
