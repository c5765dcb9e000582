"""Roofline and mfu counts against shapes worked by hand, and the trace
reductions on a made-up timeline."""

import types

import pytest
import torch

from benchmark.harness import stats, trace as tr, yardstick as ys
from benchmark.harness.session import Span
from benchmark.weights import pbw

BW, I8, F32, BF16 = 3.35e12, 1979e12, 67e12, 989e12


@pytest.fixture(scope="module")
def v2():
    # ic 512: round(0.1 · 512) = 51 salient columns, padded to k_pad 64
    return pbw.random_v2(512, 256, torch.Generator().manual_seed(1))


def test_v2_layer_bytes_by_hand(v2):
    e = ys.linear_entry("q", v2)
    assert (e["k_pad"], e["n_rg"]) == (64, 1)
    assert e["sign_bytes"] == 512 // 32 * 256 * 4 == 16384
    assert e["side_bytes"] == 64 * 256
    assert ys.packed_bytes(v2) == 16384 + 16384 + 64 * 4 + 4 * 256 * 4
    nbytes, ops = ys.int8_matmul_launch(e, 8)
    assert nbytes == (8 * 512 + 8 * 64 + 4 * (16 + 8 + 5 * 256) + 16384 + 16384 + 4 * 8 * 256)
    assert ops == 2 * 8 * 256 * (512 + 64)
    assert ys.int8_prep_launch(e, 8) == 4 * 8 * 512 + 256 + 8 * 512 + 8 * 64 + 4 * (16 + 8)


def test_v1_layer_bytes_by_hand():
    p = pbw.random_v1(256, 128, torch.Generator().manual_seed(2), bias=True)
    e = ys.linear_entry("fc1", p)
    held = 256 // 32 * 128 * 4 * 2 + 256 * 128 + 4 * 128 * 4 + 4 * 128
    assert e["held_bytes"] == held
    assert ys.v1_launch(e, 64) == (4 * (64 * 256 + 64 * 128) + held, 2 * 64 * 256 * 128)


def _sheet(v2):
    layer = {"q_proj": v2, "input_layernorm": torch.ones(4)}
    cfg = {"num_hidden_layers": 2, "hidden_size": 512, "vocab_size": 1000}
    return ys.sheet_of(cfg, layer, 512 * 1000 * 4, 4, 2, 128)


def test_step_bound_by_hand(v2):
    sheet = _sheet(v2)
    held = ys.packed_bytes(v2)
    rows, kv, pairs = 8, 100, 100
    t_ops = (2 * (2 * rows * 256 * (512 + 64)) / I8
             + (2 * rows * 512 * 1000 + 4 * 128 * 4 * pairs * 2) / F32)
    nbytes = 2 * held + 512 * 1000 * 4 + 4 * rows * (512 + 1000) + 2 * (kv + rows) * 2 * (2 * 128 + 8)
    want = max(t_ops, nbytes / BW)
    got, by = ys.step_bound(sheet, rows, kv, pairs, rows)
    assert got == pytest.approx(want, rel=1e-12)
    assert by == ("bytes" if nbytes / BW >= t_ops else "operations")


def test_decode_attention_bytes_by_hand():
    sheet = {"heads": 32, "kv_heads": 8, "head_dim": 128}
    nbytes, ops = ys.decode_attention_launches(sheet, 64, 40000)
    assert nbytes == 40000 * 8 * (256 + 8) + 2 * 4 * 64 * 32 * 128
    assert ops == 4 * 128 * 32 * 40000


INT8_NAME = ("void (anonymous namespace)::tc::kernel<8, false, 64>((anonymous namespace)::tc::Maps,"
             " float const*, float const*, float const*, float const*, float*, int, int, int)")
PREP_NAME = "void (anonymous namespace)::pb_prep_int8_kernel<8>(float const*, int const*)"
ATTN_NAME = "void (anonymous namespace)::split_kernel<signed char>(float const*, signed char const*)"
MERGE_NAME = "(anonymous namespace)::merge_kernel(float const*, float const*, float*, int)"
OTHER = "void at::native::elementwise_kernel<128, 4>(int, at::native::Func)"


def _run(v2):
    us = 1000  # ns
    span = Span("decode", 0.0, 0.01, 1_000 * us, 11_000 * us, 6, 8, 800, 600, 600)
    ops = [(INT8_NAME, 2_000 * us, 2_010 * us), (PREP_NAME, 2_010 * us, 2_012 * us),
           (ATTN_NAME, 3_000 * us, 3_004 * us), (MERGE_NAME, 3_004 * us, 3_005 * us),
           (OTHER, 4_000 * us, 4_003 * us), (INT8_NAME, 20_000 * us, 20_010 * us)]
    trace = {"ns0": 0, "ns1": 10_000 * us * 2, "ops": ops}
    return types.SimpleNamespace(trace=trace, spans=[span], sheet=_sheet(v2), n_slots=8,
                                 t_open=0.0, t_close=1.0, spans_in_window=lambda k=None: [span])


def test_kernel_names_select_their_family():
    import re

    assert re.search(stats.INT8_MATMUL, INT8_NAME) and re.search(stats.INT8_MATMUL, PREP_NAME)
    assert not re.search(stats.INT8_MATMUL, ATTN_NAME)
    assert re.search(stats.DECODE_ATTENTION, ATTN_NAME) and re.search(stats.DECODE_ATTENTION,
                                                                      MERGE_NAME)
    assert not re.search(stats.DECODE_ATTENTION, INT8_NAME.replace("tc::kernel", "tc::split_kernel"))
    assert not re.search(stats.DECODE_ATTENTION, "(anonymous namespace)::split::merge_kernel(int)")
    for name in ("(anonymous namespace)::v1tc::kernel<1, 8>(CUtensorMap)",
                 "(anonymous namespace)::seltc::kernel<3, 1, 8>(CUtensorMap)",
                 "(anonymous namespace)::v1terms::terms_kernel<3, 0>(float const*)"):
        assert re.search(stats.PLANAR_V1, name) and not re.search(stats.INT8_MATMUL, name)
    assert not re.search(stats.INT8_MATMUL, "(anonymous namespace)::bf16tc::kernel<3, 8, false, 8>")


def test_kernel_roofline_is_bound_over_device_time(v2):
    run = _run(v2)
    span = run.spans[0]
    e = ys.linear_entry("q_proj", v2)
    want_s = 2 * (ys.bound(*ys.int8_matmul_launch(e, 8), I8)[0]
                  + ys.bound(ys.int8_prep_launch(e, 8), 0, I8)[0]) / 1e3
    assert stats.int8_bound_s(run, span) == pytest.approx(want_s)
    # the launch at 20 ms lies outside the span: not counted
    assert stats.roofline(run, stats.INT8_MATMUL, stats.int8_bound_s) == pytest.approx(
        100 * want_s / 12e-6)
    nbytes = 800 * 2 * (256 + 8) + 2 * 4 * 8 * 4 * 128
    attn = 2 * max(nbytes / BW, 4 * 128 * 4 * 800 / F32)
    assert stats.roofline(run, stats.DECODE_ATTENTION, stats.decode_attention_bound_s,
                          ("decode",)) == pytest.approx(100 * attn / 5e-6)
    assert stats.roofline(run, stats.PLANAR_V1, stats.v1_bound_s) is None


def test_step_share_and_idle_share(v2):
    run = _run(v2)
    least = ys.step_bound(run.sheet, 6, 600, 600, 6)[0]
    assert stats.step_share(run, "decode") == pytest.approx(100 * least / 0.01)
    busy = (10 + 2 + 4 + 1 + 3) * 1e3  # the launch at 20 ms starts as the window ends
    assert stats.idle_share(run) == pytest.approx(100 * (1 - busy / 20e6))
    bd = tr.breakdown(run.trace, run.spans)
    assert bd["device_ops"][0][0].startswith("anon::tc::kernel") and len(bd["idle_gaps"]) == 2
    assert sum(v for _, v in bd["idle_gaps"]) == pytest.approx(0.02 - busy / 1e9)
