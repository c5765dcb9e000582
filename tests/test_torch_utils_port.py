"""Port parity of the small modules: `utils.profiling`, `utils.compile_cache`,
`native` (the host packer), `core.packing`'s numpy forms and
`models.llama.hidden_states_prefix`, against the JAX package on the CPU.

Bounds: the roofline fields and the packers bit for bit (the same formulas
and integer ops); `time_bound_s` exact at the H100's figures."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_llm_tpu import native as jnative
from pb_llm_tpu.core import packing as jpacking
from pb_llm_tpu.models import llama as jllama
from pb_llm_tpu.utils import profiling as jprof
from pb_llm_tpu_torch import native
from pb_llm_tpu_torch.core import packing
from pb_llm_tpu_torch.interop import from_jax_params
from pb_llm_tpu_torch.models import llama as tllama
from pb_llm_tpu_torch.ops import _build
from pb_llm_tpu_torch.utils import compile_cache, profiling

torch.set_num_threads(2)

SHAPES = [(8, 4096, 11008), (1, 4096, 4096), (512, 11008, 4096)]


@pytest.mark.parametrize("m,ic,oc", SHAPES)
@pytest.mark.parametrize("planes,sidecar_bits", [(2, 8), (1, 8), (2, 4)])
def test_pb_roofline_fields_equal_jax(m, ic, oc, planes, sidecar_bits):
    got = profiling.pb_roofline(m, ic, oc, sidecar_bits=sidecar_bits, planes=planes)
    want = jprof.pb_roofline(m, ic, oc, sidecar_bits=sidecar_bits, planes=planes)
    assert [getattr(got, f) for f in ("bytes_weights", "bytes_activations", "flops", "vpu_ops")] \
        == [getattr(want, f) for f in ("bytes_weights", "bytes_activations", "flops", "vpu_ops")]
    # the same formula at the same rates
    assert got.time_bound_s(819.0, 197.0, 4.0) == want.time_bound_s(819.0, 197.0, 4.0)


def test_time_bound_uses_the_h100_figures():
    r = profiling.pb_roofline(8, 4096, 11008)
    want = max((r.bytes_weights + r.bytes_activations) / 3350e9, r.flops / 989e12,
               r.vpu_ops / 67e12)
    assert r.time_bound_s() == want
    assert (profiling.H100_HBM_GBPS, profiling.H100_BF16_TFLOPS, profiling.H100_F32_TFLOPS) \
        == (3350.0, 989.0, 67.0)


def test_sync_time_and_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    dt, out = profiling.sync_time(lambda a: {"y": a @ a}, x)
    assert dt > 0 and torch.equal(out["y"], x @ x)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.mm(x, x)
    with open(tmp_path / "tr" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in a.key for a in prof.key_averages())


def test_enable_compile_cache_points_the_kernel_build(tmp_path, monkeypatch):
    """PB_TPU_COMPILE_CACHE=<dir> moves `ops._build`'s libraries there;
    unset, build/kernels/ and None without CUDA; 0, a temporary directory
    and None.  No nvcc is needed: the path is the one `_build` would build."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    d = str(tmp_path / "kc")
    monkeypatch.setenv("PB_TPU_COMPILE_CACHE", d)
    assert compile_cache.enable_compile_cache() == d and os.path.isdir(d)
    assert os.path.dirname(_build._lib_path("pb_int8_matmul")) == d
    monkeypatch.delenv("PB_TPU_COMPILE_CACHE")
    assert compile_cache.enable_compile_cache() is None  # no CUDA here
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
    assert _build.DEFAULT_BUILD_DIR.endswith(os.path.join("build", "kernels"))
    monkeypatch.setenv("PB_TPU_COMPILE_CACHE", "0")
    assert compile_cache.enable_compile_cache() is None
    assert _build.BUILD_DIR != _build.DEFAULT_BUILD_DIR and os.path.isdir(_build.BUILD_DIR)
    monkeypatch.setenv("PB_TPU_COMPILE_CACHE", "/proc/no/such/dir")
    assert compile_cache.enable_compile_cache() is None  # never raises


def test_native_route_is_taken_and_builds_outside_the_package():
    assert native.available()
    assert native.lib_path().startswith(native.BUILD_DIR)
    assert os.path.join("build", "native") in native.BUILD_DIR
    assert not any(f.endswith(".so") for f in os.listdir(os.path.dirname(native.__file__)))


@pytest.mark.parametrize("numpy_route", [False, True])
def test_native_pack_bits_equals_jax(numpy_route, monkeypatch):
    if numpy_route:  # JAX's numpy semantics, where no compiler exists
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
    rng = np.random.default_rng(0)
    for ic, oc, blk in [(256, 64, 256), (1024, 100, 256), (1376, 40, 1376), (608, 32, 512)]:
        bits = rng.integers(0, 2, size=(ic, oc)).astype(np.uint8)
        got = native.pack_bits(bits, blk)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, jpacking.pack_bits_np(bits.astype(np.uint32), blk))


@pytest.mark.parametrize("numpy_route", [False, True])
def test_native_build_planes_equals_jax(numpy_route, monkeypatch):
    if numpy_route:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
    rng = np.random.default_rng(1)
    oc, ic = 48, 256
    w_q = rng.standard_normal((oc, ic)).astype(np.float32)
    mask = (np.abs(w_q) <= np.quantile(np.abs(w_q), 0.8)).astype(np.uint8)
    mean = (0.01 * rng.standard_normal(oc)).astype(np.float32)
    hscale = (0.02 + 0.01 * rng.random(oc)).astype(np.float32)
    hzero = np.round(128 + 4 * rng.standard_normal(oc)).astype(np.float32)
    got = native.build_planes(w_q, mask, mean, hscale, hzero, 128)
    want = jnative.build_planes(w_q, mask, mean, hscale, hzero, 128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("ic,oc,blk", [(256, 64, 256), (1376, 40, 1376), (608, 32, 512)])
def test_numpy_forms_equal_jax(ic, oc, blk):
    rng = np.random.default_rng(ic)
    bits = rng.integers(0, 2, size=(ic, oc)).astype(np.uint32)
    words = packing.pack_bits_np(bits, blk)
    np.testing.assert_array_equal(words, jpacking.pack_bits_np(bits, blk))
    np.testing.assert_array_equal(packing.unpack_bits_np(words, ic, blk),
                                  jpacking.unpack_bits_np(words, ic, blk))
    np.testing.assert_array_equal(packing.unpack_bits_np(words, ic, blk), bits)
    codes = rng.integers(0, 16, size=(ic, oc)).astype(np.uint8)
    nib = packing.pack_nibbles_np(codes, blk)
    np.testing.assert_array_equal(nib, jpacking.pack_nibbles_np(codes, blk))
    np.testing.assert_array_equal(packing.unpack_nibbles_np(nib, ic, blk),
                                  jpacking.unpack_nibbles_np(nib, ic, blk))
    # the numpy words are the torch packer's int32 bits
    np.testing.assert_array_equal(
        packing.pack_bits(torch.from_numpy(bits.astype(np.int64)), blk).numpy().view(np.uint32),
        words)
    x = rng.standard_normal((ic % 7 + 5, 3)).astype(np.float32)
    for arr in (x, torch.from_numpy(x)):
        got, rows = packing.pad_rows(arr, 8)
        want, wrows = jpacking.pad_rows(x, 8)
        assert rows == wrows and type(got) is type(arr)
        np.testing.assert_array_equal(np.asarray(got), want)


def test_hidden_states_prefix_equals_jax():
    jcfg = jllama.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                              num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=4,
                              max_position_embeddings=64)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    ids = np.random.default_rng(3).integers(0, 128, size=(2, 9))
    want = np.asarray(jllama.hidden_states_prefix(jp, jnp.asarray(ids), jcfg))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    got = tllama.hidden_states_prefix(tp, torch.from_numpy(ids), None)
    np.testing.assert_array_equal(got.numpy(), want)
    from pb_llm_tpu_torch.models.registry import FAMILIES

    assert FAMILIES["llama"].embed is tllama.hidden_states_prefix
