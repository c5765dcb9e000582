"""ctypes bindings for the native PBW plane packer (port of
`pb_llm_tpu/native/__init__.py`; `pbpack.cpp` here is a byte-identical
copy of the JAX package's source).

The library is built at first use with
``g++ -O3 -march=native -std=c++17 -fPIC -shared -pthread`` into
``build/native/`` at the repository root (listed in `.gitignore`; never into
the package), named by a hash of the source and of this CPU's feature flags,
so that a library built for one host is never loaded on another.  Where no
compiler exists, each entry point runs JAX's numpy semantics instead
(`core.packing.pack_bits_np`): a host-throughput helper for converting
large checkpoints, not a correctness dependency.  `available()` says which
route runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pbpack.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(_SRC))), "build",
                         "native")
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-pthread"]
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            return next((ln for ln in fh if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def lib_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(CXX_FLAGS).encode() + _cpu_flags())
    return os.path.join(BUILD_DIR, f"libpbpack_{h.hexdigest()[:12]}.so")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = lib_path()
    if not os.path.exists(path):
        cxx = shutil.which("g++")
        if cxx is None:
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            subprocess.run([cxx, *CXX_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True)
            os.replace(tmp, path)
        except (OSError, subprocess.CalledProcessError):
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.c_int64
    lib.pbpack_pack_bits.argtypes = [u8p, i64, i64, i64, u32p, ctypes.c_int]
    lib.pbpack_pack_bits.restype = None
    lib.pbpack_build_planes.argtypes = [f32p, u8p, f32p, f32p, f32p, i64, i64, i64, u32p, u32p,
                                        u8p, ctypes.c_int]
    lib.pbpack_build_planes.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native library runs (False: the numpy route)."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pack_bits(bits: np.ndarray, pack_block: int, n_threads: int = 0) -> np.ndarray:
    """{0,1} [ic, oc] → uint32 [ic//32, oc]; native if possible, numpy otherwise."""
    ic, oc = bits.shape
    lib = _load()
    if lib is None:
        from ..core.packing import pack_bits_np

        return pack_bits_np(bits.astype(np.uint32), pack_block)
    b = np.ascontiguousarray(bits, np.uint8)
    out = np.empty((ic // 32, oc), np.uint32)
    lib.pbpack_pack_bits(_ptr(b, ctypes.c_uint8), ic, oc, pack_block, _ptr(out, ctypes.c_uint32),
                         n_threads)
    return out


def build_planes(
    w_q: np.ndarray, mask: np.ndarray, mean: np.ndarray,
    hscale: np.ndarray, hzero: np.ndarray, pack_block: int, n_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fused construction of (sign_packed, mask_packed, sidecar) from solver
    outputs (single whole-row group); JAX's numpy semantics without the
    library."""
    oc, ic = w_q.shape
    lib = _load()
    if lib is None:
        return build_planes_np(w_q, mask, mean, hscale, hzero, pack_block)
    w = np.ascontiguousarray(w_q, np.float32)
    mk = np.ascontiguousarray(mask, np.uint8)
    mu = np.ascontiguousarray(mean, np.float32)
    hs = np.ascontiguousarray(hscale, np.float32)
    hz = np.ascontiguousarray(hzero, np.float32)
    sign_packed = np.empty((ic // 32, oc), np.uint32)
    mask_packed = np.empty((ic // 32, oc), np.uint32)
    sidecar = np.empty((ic, oc), np.uint8)
    lib.pbpack_build_planes(
        _ptr(w, ctypes.c_float), _ptr(mk, ctypes.c_uint8), _ptr(mu, ctypes.c_float),
        _ptr(hs, ctypes.c_float), _ptr(hz, ctypes.c_float),
        oc, ic, pack_block,
        _ptr(sign_packed, ctypes.c_uint32), _ptr(mask_packed, ctypes.c_uint32),
        _ptr(sidecar, ctypes.c_uint8), n_threads,
    )
    return sign_packed, mask_packed, sidecar


def build_planes_np(w_q: np.ndarray, mask: np.ndarray, mean: np.ndarray, hscale: np.ndarray,
                    hzero: np.ndarray, pack_block: int) -> Tuple[np.ndarray, np.ndarray,
                                                                 np.ndarray]:
    """`build_planes` in numpy (JAX's semantics): the route without the
    library."""
    from ..core.packing import pack_bits_np

    salient = (~mask.astype(bool)).T
    sbits = (((w_q - mean[:, None]) >= 0).T) & ~salient
    codes = np.clip(np.round(w_q / hscale[:, None] + hzero[:, None]), 0, 255)
    sidecar = np.where(salient, codes.T, 0).astype(np.uint8)
    return (
        pack_bits_np(sbits.astype(np.uint32), pack_block),
        pack_bits_np(salient.astype(np.uint32), pack_block),
        sidecar,
    )
