"""The system under test: the port's kernels built into the checkout, the
model made from the run's seed, an `Engine` with the graphed decode step,
warmed up on every shape the cell's traffic sends, and the
`ServingLoop` over it.  Each step of set-up is timed (`System.setup`).
"""

from __future__ import annotations

import gc
import importlib
import os
import time
from typing import Dict

import torch

from .bench import ROOT, Cell
from .session import Session
from . import yardstick

KV_DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16, "f32": torch.float32}


def _plain_kernels():
    """Off the card (the CPU rehearsals): the kernels' plain versions on the
    card's arms (the int8 matmul at prefill too), not the CPU's f32 path."""
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig

    return KernelConfig(backend="pallas_interpret", prefill="int8",
                        decode_attention="pallas_interpret")


def build_kernels(device) -> None:
    """Build (or load) every CUDA kernel of the port into the checkout's
    fixed build directory, so that only a cell's first run compiles."""
    os.environ["PB_TPU_COMPILE_CACHE"] = os.path.join(ROOT, "build", "kernels")
    from pb_llm_tpu_torch.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if device.type == "cuda":
        from pb_llm_tpu_torch.ops import _build

        _build.build_all()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


class System:
    """Set up one cell for one seed; ``setup`` holds the seconds of each step."""

    def __init__(self, cell: Cell, seed: int, device):
        from pb_llm_tpu_torch.ops.kernel_config import KernelConfig
        from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig
        from pb_llm_tpu_torch.runtime.server import ServingLoop

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.setup: Dict[str, float] = {}
        cfg, mix = cell.config, cell.mix
        fam = importlib.import_module(f"benchmark.families.{cfg['family']}")

        t = time.perf_counter()
        build_kernels(self.device)
        self.setup["compile_s"] = time.perf_counter() - t

        t = time.perf_counter()
        params = fam.program_params(cfg, seed, self.device)
        _sync(self.device)
        self.setup["weights_s"] = time.perf_counter() - t
        pcfg = fam.program_config(cfg)
        weights = importlib.import_module(f"benchmark.weights.{cfg['family']}")
        head = params.get("lm_head", {}).get("w") if params.get("lm_head") else None
        head = params["embed_tokens"] if head is None else head
        self.sheet = yardstick.sheet_of(
            cfg, {k: vars(v) for k, v in params["layers"][0].items() if hasattr(v, "sign_packed")},
            head.numel() * head.element_size(), cfg["num_attention_heads"],
            weights.kv_heads(cfg), weights.head_dim(cfg))

        t = time.perf_counter()
        e = mix["engine"]
        ecfg = EngineConfig(n_slots=e["n_slots"], max_seq=e["max_seq"],
                            prefill_buckets=tuple(e["prefill_buckets"]),
                            max_prefill_batch=e["max_prefill_batch"],
                            cache_dtype=KV_DTYPES[cfg["assumed"]["precision"]["kv"]],
                            kernels=KernelConfig() if self.device.type == "cuda" else _plain_kernels())
        self.engine = Engine(params, pcfg, fam.FAMILY, ecfg, device=self.device, seed=seed)
        del params
        _sync(self.device)
        self.setup["engine_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.warm_up(cell.kind().prompt_range(mix))
        self.setup["warm_up_s"] = time.perf_counter() - t

        self.loop = ServingLoop(self.engine)  # the traffic kind starts it (`Session.start`)
        self.session = Session(self.loop, self.engine, seed, cfg["vocab_size"], e["max_seq"],
                               self.sheet, torch.cuda.get_device_name(self.device)
                               if self.device.type == "cuda" else "cpu")
        self.session.instrument()
        if self.device.type == "cuda":
            self.session.memory = self._memory

    def _memory(self, stage: str) -> None:
        """The allocator's peak: set-up's when the window opens (then reset),
        the window's when it closes (`Session.extra`)."""
        self.session.extra[f"{stage}_peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
        if stage == "open":
            torch.cuda.reset_peak_memory_stats(self.device)

    def warm_up(self, prompt_range) -> None:
        """One prefill of every (bucket, batch) shape the traffic can send,
        then three decode steps (eager, captured, replayed); every slot is
        released after."""
        eng = self.engine
        from benchmark.harness.traffic import buckets_of

        lo, hi = prompt_range
        kmax = min(eng.ecfg.max_prefill_batch, eng.ecfg.n_slots)
        for b in reversed(buckets_of(self.cell.mix, lo, hi)):
            n = min(b, hi)
            for k in range(kmax, 0, -1):
                eng.prefill_batch([(s, [1 + s] * n) for s in range(k)])
                for s in range(k):
                    eng.release(s)
        eng.prefill_batch([(0, [1] * min(lo, 8))])
        for _ in range(3):
            eng.decode_step()
        eng.release(0)
        _sync(self.device)

    def shutdown(self) -> None:
        """Stop the scheduler thread and drop the program's state (the
        engine, its caches and graph), keeping the session's records."""
        self.loop.shutdown()
        self.session.loop_error = self.loop._error
        self.session.loop = self.session.engine = None
        self.loop = self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
