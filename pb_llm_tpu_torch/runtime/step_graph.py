"""The engine's CUDA graphs: the counterpart of JAX's jitted engine programs
(`pb_llm_tpu/runtime/engine.py` `Engine._jit`, with
`ops/kernel_config.wrap_jit`).

`StepGraph` runs an engine's single-token forward for all ``n_slots`` rows
from static buffers: before each step the slots' last tokens and positions
are copied into one device tensor, and the logits come back in a tensor the
step owns (read it before the next step).  On a CUDA engine the first step
runs eagerly: it makes what is made on first use (each layer's coefficient
rows, the kernels' libraries, cuBLAS's handle, index tables).  The second
step captures the forward into a `torch.cuda.CUDAGraph` (on a side stream,
as PyTorch requires, in a memory pool the graph owns) and replays it, and
every later step replays it.

`PrefillGraphs` runs the strip prefill's calls (`Engine._strip_prefill`:
the slots' strip rows gathered, the [K, bucket] forward at pos 0, the last
rows' logits picked, the rows scattered back) as one graph for each
(K, bucket) shape.  The host fills the shape's one static buffer (ids,
slots, last rows) with one copy.  The first call of a shape runs eagerly
from that buffer and then captures; every later call replays, and its
[K, V] logits are copied out of the graph's output before they are
returned (the next replay of the shape overwrites it).  The prefill graphs
share one memory pool; the decode step's graph keeps its own.

Both capture where `capturable` holds: on a CUDA engine, and for a TP
engine only under NCCL, whose collectives a graph holds; under gloo (ranks
sharing a card) they run eagerly, as the engine states
(`TPEngine.describe`).  On the CPU nothing is captured.  A failed capture
or replay raises: nothing falls back to the eager call.

`eager()` makes every engine run its steps and prefills op by op while it
is entered, as `jax.disable_jit()` does; it nests.

A graph holds the addresses of the engine's params and caches, which the
engine assigns once in its constructor and updates in place (cache rows,
pages and the paged table); a call raises if they were replaced.  A forward
under capture must not read a device value on the host (``.item()``,
``int(t)``, a device-to-host copy): the capture then raises.

Launch counters: capture runs the kernel wrappers, which count their
launches, but launches nothing; a replay launches the kernels but runs no
Python.  So the counters (`ops.counters`) are restored after capture, and
each replay adds the launches the capture recorded.  Each call records its
stages as spans (`runtime.tracing`); a capture counts in the engine's
`graph_captures`, a prefill replay in its `prefill_replays`.
"""

from __future__ import annotations

import contextlib
import gc
import weakref
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import counters
from . import tracing

_eager_depth = 0


@contextlib.contextmanager
def eager():
    """Run every engine's decode steps and prefills op by op inside the block."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def is_eager() -> bool:
    return _eager_depth > 0


def capture(graph, fn, pool):
    """``fn()`` captured into ``graph`` by PyTorch, on its side stream, in
    ``pool`` (None: a pool of the graph's own); returns its output.  Errors
    from this thread's CUDA calls fail the capture (the HTTP server's other
    threads make none)."""
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        return fn()


class _Graphs:
    """What an engine's graphs share: when to capture, the check that the
    engine's params and caches are still the ones captured, and the
    capture and replay with their launch counters."""

    graph_cls = torch.cuda.CUDAGraph

    def __init__(self, engine):
        self._engine = weakref.ref(engine)  # the engine owns its graphs, not the reverse
        self.device = engine.device
        self.params, self.caches = engine.params, engine.caches
        # a process group's collectives are captured only under NCCL: a gloo
        # engine (ranks sharing a card, `parallel.mesh`) runs eagerly
        self.capturable = self.device.type == "cuda" and (engine.mesh is None
                                                          or engine.mesh.backend == "nccl")

    def _live_engine(self):
        eng = self._engine()
        if eng.params is not self.params or eng.caches is not self.caches:
            raise RuntimeError("the engine's params or caches were replaced: its steps and "
                               "prefills read them in place (and its CUDA graphs hold their "
                               "addresses)")
        return eng

    def _capture(self, fn, pool=None) -> Tuple[object, torch.Tensor, Dict[str, int]]:
        """(graph, its output, the launches one replay makes) of ``fn``."""
        # a dead engine's graph that the collector frees during the capture
        # would reset it there, which ends the capture: collect first
        gc.collect()
        before = counters.read(totals=True)
        graph = self.graph_cls()
        try:
            out = capture(graph, fn, pool)
        finally:
            after = counters.read(totals=True)
            counters.restore(before)
        self._engine().counts.graph_captures += 1
        return graph, out, {k: after[k] - before[k] for k in before}

    @staticmethod
    def _replay(graph, deltas: Dict[str, int]) -> None:
        graph.replay()
        counters.add(deltas)


class StepGraph(_Graphs):
    """The decode-step forward of ``engine`` (see the module note).
    ``engine._run(ids [n, 1], caches, pos [n])`` is the forward."""

    def __init__(self, engine):
        super().__init__(engine)
        n = engine.ecfg.n_slots
        self.buf = torch.zeros((2, n), dtype=torch.long, device=self.device)
        self.ids = self.buf[0][:, None]   # [n, 1] last tokens
        self.pos = self.buf[1]            # [n] positions (the cache row each writes)
        self.warm = False
        self.graph = None
        self.logits = None  # the graph's output
        self.deltas = {}    # launches one replay makes, by counter
        self.replays = 0

    def _forward(self) -> torch.Tensor:
        return self._engine()._run(self.ids, self.caches, self.pos)[:, 0]

    def __call__(self, tokens: np.ndarray, positions: np.ndarray) -> torch.Tensor:
        """Logits [n_slots, V] of one token per slot at its position."""
        self._live_engine()
        sp = tracing.on and tracing.begin("step_graph.copy_in")
        host = torch.from_numpy(np.stack([tokens, positions]).astype(np.int64))
        self.buf.copy_(host)
        if sp:
            tracing.end(sp)
        if not self.capturable or is_eager() or not self.warm:
            self.warm = True
            sp = tracing.on and tracing.begin("step_graph.eager")
            logits = self._forward()
            if sp:
                tracing.end(sp)
            return logits
        if self.graph is None:
            sp = tracing.on and tracing.begin("step_graph.capture")
            self.graph, self.logits, self.deltas = self._capture(self._forward)
            if sp:
                tracing.end(sp)
        sp = tracing.on and tracing.begin("step_graph.replay")
        self._replay(self.graph, self.deltas)
        self.replays += 1
        if sp:
            tracing.end(sp)
        return self.logits


class PrefillShape:
    """One (K, bucket) shape of the strip prefill: its static buffer (ids
    [K, bucket], then the K slots, then the K last rows, one device tensor
    the host fills with one copy) and, once captured, its graph."""

    def __init__(self, k: int, bucket: int, device):
        n = k * bucket
        self.buf = torch.zeros(n + 2 * k, dtype=torch.long, device=device)
        self.ids = self.buf[:n].view(k, bucket)
        self.slots = self.buf[n : n + k]
        self.last = self.buf[n + k :]
        self.graph = None
        self.logits = None  # the graph's output [K, V]
        self.deltas: Dict[str, int] = {}


class PrefillGraphs(_Graphs):
    """The strip prefill of ``engine`` as one graph a (K, bucket) shape
    (see the module note).  ``engine._strip_prefill(ids, slots, last)`` is
    the call."""

    def __init__(self, engine):
        super().__init__(engine)
        self.shapes: Dict[Tuple[int, int], PrefillShape] = {}
        self.pool = None  # the memory pool the prefill graphs share: the first graph's

    def engaged(self) -> bool:
        """Whether prefill calls run through the graphs now."""
        return self.capturable and not is_eager()

    def load(self, ids: np.ndarray, slots, last) -> PrefillShape:
        """The shape of ``ids`` [K, bucket], its buffer filled with the ids,
        the slots [K] and each prompt's last row [K]."""
        k, bucket = ids.shape
        shape = self.shapes.get((k, bucket))
        if shape is None:
            shape = self.shapes[(k, bucket)] = PrefillShape(k, bucket, self.device)
        host = np.concatenate([ids.ravel(), slots, last]).astype(np.int64)
        shape.buf.copy_(torch.from_numpy(host))
        return shape

    def __call__(self, shape: PrefillShape) -> torch.Tensor:
        """Run ``shape``'s loaded call: eagerly and then captured the first
        time, replayed after; the next-token logits [K, V], the caller's."""
        eng = self._live_engine()

        def call():
            return eng._strip_prefill(shape.ids, shape.slots, shape.last)

        if shape.graph is None:
            sp = tracing.on and tracing.begin("prefill.forward")
            logits = call()
            if sp:
                tracing.end(sp)
            sp = tracing.on and tracing.begin("prefill.capture")
            shape.graph, shape.logits, shape.deltas = self._capture(call, self.pool)
            if self.pool is None:
                self.pool = shape.graph.pool()
            if sp:
                tracing.end(sp)
            return logits
        sp = tracing.on and tracing.begin("prefill.replay")
        self._replay(shape.graph, shape.deltas)
        logits = shape.logits.clone()
        eng.counts.prefill_replays += 1
        if sp:
            tracing.end(sp)
        return logits
