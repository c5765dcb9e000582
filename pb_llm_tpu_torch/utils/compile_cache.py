"""The kernel build cache for the CLIs (port of
`pb_llm_tpu/utils/compile_cache.py`).

JAX keeps XLA's compiled programs in a persistent on-disk cache, so that
every run after the first reads them instead of compiling.  The port's
compiled programs are its CUDA kernels: `ops._build` compiles each
`csrc/*.cu` with nvcc into a shared library named by a hash of its sources,
and loads it from there on every later run.  This module points that build
directory.  Controls:

  PB_TPU_COMPILE_CACHE=<dir>  build into (and load from) <dir>
  unset                        ``build/kernels/`` at the repository root
  PB_TPU_COMPILE_CACHE=0       build into a temporary directory, removed at
                               exit (every run compiles afresh)

Every CLI calls `enable_compile_cache` at entry, as JAX's five do.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Optional


def enable_compile_cache() -> Optional[str]:
    """Point `ops._build` at the build directory the environment names.

    Returns the directory, or None when caching is off (``=0``) or, left
    unset, where CUDA is absent (no kernel is built there; JAX returns None
    on the CPU too).  Never raises: a directory that cannot be made leaves
    the build directory as it was and returns None."""
    try:
        import torch

        from ..ops import _build

        setting = os.environ.get("PB_TPU_COMPILE_CACHE", "")
        if setting == "0":
            tmp = tempfile.mkdtemp(prefix="pb_kernels_")
            atexit.register(shutil.rmtree, tmp, True)
            _build.BUILD_DIR = tmp
            return None
        if setting:
            os.makedirs(setting, exist_ok=True)
            _build.BUILD_DIR = os.path.abspath(setting)
            return _build.BUILD_DIR
        _build.BUILD_DIR = _build.DEFAULT_BUILD_DIR
        return _build.BUILD_DIR if torch.cuda.is_available() else None
    except Exception:  # a read-only filesystem, a broken CUDA runtime
        return None
