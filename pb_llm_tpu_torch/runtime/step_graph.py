"""The engine's decode step as one CUDA graph: the counterpart of JAX's
jitted engine programs (`pb_llm_tpu/runtime/engine.py` `Engine._jit`, with
`ops/kernel_config.wrap_jit`).

`StepGraph` runs an engine's single-token forward for all ``n_slots`` rows
from static buffers: before each step the slots' last tokens and positions
are copied into one device tensor, and the logits come back in a tensor the
step owns (read it before the next step).  On a CUDA engine the first step
runs eagerly: it makes what is made on first use (each layer's coefficient
rows, the kernels' libraries, cuBLAS's handle, index tables).  The second
step captures the forward into a `torch.cuda.CUDAGraph` (on a side stream,
as PyTorch requires, in a memory pool the graph owns) and replays it, and
every later step replays it.  A failed capture or replay raises: nothing
falls back to the eager step.  On the CPU nothing is captured and the same
buffers feed the forward directly.

`eager()` makes every engine run its steps op by op while it is entered,
as `jax.disable_jit()` does; it nests.

The graph holds the addresses of the engine's params and caches, which the
engine assigns once in its constructor and updates in place (cache rows,
pages and the paged table); a step raises if they were replaced.  A forward
under capture must not read a device value on the host (``.item()``,
``int(t)``, a device-to-host copy): the capture then raises.

Launch counters: capture runs the kernel wrappers, which count their
launches, but launches nothing; a replay launches the kernels but runs no
Python.  So the counters (`ops.counters`) are restored after capture, and
each replay adds the launches the capture recorded.
"""

from __future__ import annotations

import contextlib
import gc
import weakref

import numpy as np
import torch

from ..ops import counters

_eager_depth = 0


@contextlib.contextmanager
def eager():
    """Run every engine's decode steps op by op inside the block."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def is_eager() -> bool:
    return _eager_depth > 0


def capture(graph):
    """The capture context: PyTorch's, on its side stream; errors from
    this thread's CUDA calls fail the capture (the HTTP server's other
    threads make none)."""
    return torch.cuda.graph(graph, capture_error_mode="thread_local")


class StepGraph:
    """The decode-step forward of ``engine`` (see the module note).
    ``engine._run(ids [n, 1], caches, pos [n])`` is the forward."""

    graph_cls = torch.cuda.CUDAGraph

    def __init__(self, engine):
        self._engine = weakref.ref(engine)  # the engine owns the step, not the reverse
        n = engine.ecfg.n_slots
        self.device = engine.device
        self.buf = torch.zeros((2, n), dtype=torch.long, device=self.device)
        self.ids = self.buf[0][:, None]   # [n, 1] last tokens
        self.pos = self.buf[1]            # [n] positions (the cache row each writes)
        self.params, self.caches = engine.params, engine.caches
        self.capturable = self.device.type == "cuda"
        self.warm = False
        self.graph = None
        self.logits = None  # the graph's output
        self.deltas = {}    # launches one replay makes, by counter
        self.replays = 0

    def _forward(self) -> torch.Tensor:
        return self._engine()._run(self.ids, self.caches, self.pos)[:, 0]

    def __call__(self, tokens: np.ndarray, positions: np.ndarray) -> torch.Tensor:
        """Logits [n_slots, V] of one token per slot at its position."""
        eng = self._engine()
        if eng.params is not self.params or eng.caches is not self.caches:
            raise RuntimeError("the engine's params or caches were replaced: the decode step "
                               "reads them in place (and its CUDA graph holds their addresses)")
        host = torch.from_numpy(np.stack([tokens, positions]).astype(np.int64))
        self.buf.copy_(host)
        if not self.capturable or is_eager() or not self.warm:
            self.warm = True
            return self._forward()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        counters.add(self.deltas)
        self.replays += 1
        return self.logits

    def _capture(self) -> None:
        # a dead engine's graph that the collector frees during the capture
        # would reset it there, which ends the capture: collect first
        gc.collect()
        before = counters.read(totals=True)
        graph = self.graph_cls()
        try:
            with capture(graph):
                logits = self._forward()
        finally:
            after = counters.read(totals=True)
            counters.restore(before)
        self.deltas = {k: after[k] - before[k] for k in before}
        self.graph, self.logits = graph, logits
