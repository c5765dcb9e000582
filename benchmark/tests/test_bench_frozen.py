"""The benchmark's frozen copies (random planes, packing, the smoke run's
bytes arithmetic) give what the port's originals give, at small sizes."""

import pytest
import torch

from benchmark.harness import yardstick as ys
from benchmark.weights import packing, pbw


def _same(raw: dict, obj) -> None:
    for k, v in raw.items():
        got = getattr(obj, k)
        if isinstance(v, torch.Tensor):
            assert got is not None and torch.equal(v, got), k
        else:
            assert v == got, k


@pytest.mark.parametrize("kw", [dict(), dict(col_tile=64), dict(side_bits=4),
                                dict(ic_shards=2, bias=True), dict(low_frac=0.5, pack_block=64)])
def test_random_v2_is_the_ports(kw):
    from pb_llm_tpu_torch.data.synthetic import random_packed_v2

    a = pbw.random_v2(256, 192, torch.Generator().manual_seed(3), **kw)
    b = random_packed_v2(256, 192, torch.Generator().manual_seed(3), **kw)
    _same(a, b)


@pytest.mark.parametrize("kw", [dict(), dict(groupsize=64), dict(sidecar_bits=4, bias=True),
                                dict(low_bits=2), dict(pack_block=64)])
def test_random_v1_is_the_ports(kw):
    from pb_llm_tpu_torch.data.synthetic import random_packed_v1

    a = pbw.random_v1(256, 96, torch.Generator().manual_seed(4), **kw)
    b = random_packed_v1(256, 96, torch.Generator().manual_seed(4), **kw)
    _same(a, b)


@pytest.mark.parametrize("ic,block", [(256, 256), (320, 128), (96, 2048)])
def test_packing_is_the_ports(ic, block):
    from pb_llm_tpu_torch.core import packing as port

    bits = torch.randint(0, 2, (ic, 40), generator=torch.Generator().manual_seed(5))
    assert torch.equal(packing.pack_bits(bits, block), port.pack_bits(bits, block))
    codes = torch.randint(0, 16, (ic, 40), generator=torch.Generator().manual_seed(6))
    assert torch.equal(packing.pack_nibbles(codes, block), port.pack_nibbles(codes, block))
    assert packing.default_pack_block(ic) == port.default_pack_block(ic)


def test_bytes_arithmetic_is_the_smoke_runs():
    import chip_smoke
    from pb_llm_tpu_torch.core.pbw import PackedLinear, PackedLinearV2

    v2 = pbw.random_v2(256, 128, torch.Generator().manual_seed(7))
    v1 = pbw.random_v1(256, 128, torch.Generator().manual_seed(8), bias=True)
    p2, p1 = PackedLinearV2(**v2), PackedLinear(**v1)
    assert ys.packed_bytes(v2) == chip_smoke.packed_bytes(p2)
    assert ys.matmul_bytes(v2, 8) == chip_smoke.matmul_bytes(p2, 8)
    assert ys.v1_plane_bytes(v1) == chip_smoke.v1_plane_bytes(p1)
    assert ys.bound(3.35e9, 1979e12, ys.INT8_OPS_PER_S) == chip_smoke.bound(
        3.35e9, 1979e12, chip_smoke.INT8_OPS_PER_S)
    assert (ys.HBM_BYTES_PER_S, ys.INT8_OPS_PER_S, ys.F32_FLOPS_PER_S, ys.BF16_FLOPS_PER_S) == (
        chip_smoke.HBM_BYTES_PER_S, chip_smoke.INT8_OPS_PER_S, chip_smoke.F32_FLOPS_PER_S,
        chip_smoke.BF16_FLOPS_PER_S)
