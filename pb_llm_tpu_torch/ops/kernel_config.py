"""Typed kernel-arm configuration (port of `pb_llm_tpu/ops/kernel_config.py`).

Same frozen `KernelConfig`, same fields and valid values, so the CLI flags
are identical.  In the port:

  * ``"pallas"`` means the hand-written CUDA kernel;
  * ``"pallas_interpret"`` means that kernel's plain PyTorch version;
  * ``"auto"`` mirrors JAX: on a CUDA tensor it picks what the TPU picks
    (int8 matmul for decode and prefill, the decode-attention kernel, flash
    attention for windows of 1024 or more), on a CPU tensor what JAX picks
    on the CPU (`matmul_reference_v2`, the masked-softmax attention).

Resolution order: innermost `use_kernels` context > per-field
`set_field_default` overrides > `set_default` > env-var overrides > field
defaults.  There is no `wrap_jit`: the engine enters `use_kernels` around
each of its calls, and its decode step, captured once as a CUDA graph
(`runtime.step_graph`), keeps the arms resolved at capture.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

_VALID = {
    "backend": ("auto", "pallas", "pallas_interpret", "xla"),
    "decode_dot": ("auto", "f32", "int8", "dma", "bf16", "pair"),
    "prefill": ("auto", "int8", "hybrid", "hybrid_bf16"),
    "prefill_gather": ("take", "dot"),
    "prefill_extract": ("pallas", "xla"),
    "attention": ("auto", "flash", "flash_interpret", "xla"),
    "decode_attention": ("auto", "pallas", "pallas_q8", "pallas_interpret", "xla"),
}


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Which kernel arm each hot path takes (see the module docstring)."""

    backend: str = "auto"
    decode_dot: str = "auto"
    prefill: str = "auto"
    prefill_gather: str = "take"
    prefill_extract: str = "pallas"
    attention: str = "auto"
    decode_attention: str = "auto"

    def __post_init__(self):
        for f, valid in _VALID.items():
            v = getattr(self, f)
            if v not in valid:
                raise ValueError(f"KernelConfig.{f}={v!r} not in {valid}")


def from_env() -> KernelConfig:
    """Config from the env-var overrides (read at call time)."""
    prefill = "auto"
    if os.environ.get("PB_TPU_PREFILL_INT8") == "1":
        prefill = "int8"
    elif os.environ.get("PB_TPU_PREFILL_BF16") == "1":
        prefill = "hybrid_bf16"
    elif (os.environ.get("PB_TPU_PREFILL_INT8") == "0"
          or os.environ.get("PB_TPU_PREFILL_BF16") == "0"):
        prefill = "hybrid"
    return KernelConfig(
        backend=os.environ.get("PB_TPU_PACKED_BACKEND", "auto"),
        decode_dot=os.environ.get("PB_TPU_DECODE_DOT", "auto"),
        prefill=prefill,
        prefill_gather=os.environ.get("PB_TPU_PREFILL_GATHER", "take"),
        prefill_extract=os.environ.get("PB_TPU_PREFILL_EXTRACT", "pallas"),
        attention=os.environ.get("PB_TPU_ATTENTION", "auto"),
        decode_attention=os.environ.get("PB_TPU_DECODE_ATTENTION", "auto"),
    )


_default: Optional[KernelConfig] = None
_field_overrides: dict = {}
_tls = threading.local()


def set_default(cfg: Optional[KernelConfig]) -> None:
    """Process-wide default beneath any `use_kernels` context (None restores
    the env/defaults resolution)."""
    global _default
    _default = cfg


def set_field_default(**fields) -> None:
    """Per-field process defaults, layered over `set_default` / the env vars
    when `current()` resolves, so a setter pins only its own field."""
    for f, v in fields.items():
        if f not in _VALID or v not in _VALID[f]:
            raise ValueError(f"KernelConfig.{f}={v!r} not in {_VALID.get(f)}")
    _field_overrides.update(fields)


def pin_exact_prefill() -> None:
    """Parity CLIs (run_ptq / run_eval): pin the exact hybrid prefill unless
    the env chose an arm — the fused int8 default rounds x per row in every
    large-m matmul and would shift reported perplexities."""
    if from_env().prefill == "auto":
        set_field_default(prefill="hybrid")


class use_kernels:
    """Scope a KernelConfig to a with-block.  Re-entrant and thread-local."""

    def __init__(self, cfg: Optional[KernelConfig]):
        self.cfg = cfg

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self.cfg)
        return self.cfg

    def __exit__(self, *exc):
        _tls.stack.pop()
        return False


def current() -> KernelConfig:
    """The active config at this call site."""
    stack = getattr(_tls, "stack", None)
    if stack:
        for cfg in reversed(stack):
            if cfg is not None:
                return cfg
    base = _default if _default is not None else from_env()
    if _field_overrides:
        base = dataclasses.replace(base, **_field_overrides)
    return base
