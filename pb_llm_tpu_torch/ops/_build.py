"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source (with the shared `csrc/*.cuh` headers) has a plain
C interface and is compiled on first use by ``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared
library under ``build/kernels/`` at the repository root (listed in
`.gitignore`), then loaded with ctypes.  A missing nvcc or a failed build
raises.  `build_all` compiles every source in parallel (one nvcc each).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
DEFAULT_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "kernels")
# where the libraries are built and loaded from (`utils.compile_cache` points it)
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("pb_int8_matmul", "decode_attention", "pb_dequant_v2", "pb_f32_matmul",
           "flash_attention", "paged_attention", "pb_planar_v1", "pb_select_v1", "pb_pair_v2",
           "pb_dma_v2", "pb_prep_int8")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")
    return cand


def _lib_path(name: str) -> str:
    """The library's path, named by a hash of its source and of every
    header in csrc/ (a header change rebuilds the sources)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def _start(name: str):
    out = _lib_path(name)
    if os.path.exists(out):
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", out + ".tmp", os.path.join(CSRC, name + ".cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: str, proc) -> None:
    if proc is not None:
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(out + ".tmp", out)
    _libs[name] = ctypes.CDLL(out)


def build_all(names: List[str] = SOURCES) -> None:
    """Compile every kernel source at once (one nvcc process each)."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        started = [(n, *_start(n)) for n in todo]
        for n, out, proc in started:
            _finish(n, out, proc)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it on first use."""
    if name not in _libs:
        build_all([name])
    return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
