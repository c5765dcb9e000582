"""The serving path's span recorder: one in-memory ring of spans on the
clock of the card's profiler trace.

A span is one record: a name, start and end in ``time.time_ns()`` (the
clock that `torch.profiler`'s CUDA activities carry, so a span can be laid
over a device trace), the index of the span that caused it (its parent, -1
for none), and the host integers a reader needs (`COUNTS` names them).
The sites, from the scheduler thread down:

    loop.handoff      `ServingLoop._run`: the lock taken, pending requests
                      moved into the batcher
    loop.idle         `ServingLoop._run`: the wait when there is no work
    batcher.step      `ContinuousBatcher.step`
      batcher.admit     admission and its prefill calls
      batcher.emit      a decode step's tokens: `_emit`, `on_token`, retirement
    engine.prefill    `Engine.prefill_batch`; children prefill.gather (ids and
                      the strip rows), prefill.forward, prefill.scatter (the rows
                      written back), prefill.finish (first tokens, two reads each);
                      on the graphed strip prefill (`step_graph.PrefillGraphs`)
                      prefill.gather (the host's fill of the shape's buffer), then
                      prefill.forward and prefill.capture on the shape's first call
                      (its eager run, then its capture) or prefill.replay (the
                      replay and the copy of its logits), then prefill.finish
    engine.decode     `Engine.decode_step`; children step_graph.copy_in, one of
                      step_graph.eager / step_graph.capture / step_graph.replay
                      (a capture is followed by its first replay), decode.sample
                      (sampling and log-prob launches; its copy of the active
                      mask to the card waits for the step), decode.read (the
                      two reads to the host), decode.slots (the loop over slots)
    engine.prefill_chunk, engine.spec_decode

Spans go into a preallocated ring of `CAPACITY` records; a record that is
overwritten before it is read is counted by `dropped`.  Writing takes no
lock and does no I/O: an index comes from one `next()` of a shared
counter (atomic under the GIL), so threads write apart; each keeps its
own stack of open spans.  Nothing here touches a CUDA tensor or emits a
profiler range: the device trace sees no trace of the recorder.

``on`` switches recording; a site costs one attribute read when it is off:

    sp = tracing.on and tracing.begin("engine.decode")
    ...
    if sp:
        tracing.end(sp, rows, computed)

Readers (after the work, e.g. the benchmark's metrics): `spans`,
`children`, `dropped`.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

CAPACITY = 1 << 17

on = True

# what each span's counts are, in order.  Prefill rows: prompt tokens run,
# against the rows computed (K·bucket, each prefix-cache suffix's bucket, a
# chunk's size): `prefill_padding.batch`.  Decode rows: active slots,
# against n_slots: the slot occupancy's counter.
COUNTS: Dict[str, tuple] = {
    "engine.prefill": ("rows", "computed"),
    "engine.prefill_chunk": ("rows", "computed"),
    "engine.decode": ("rows", "computed"),
}


class Span(NamedTuple):
    index: int
    name: str
    ns0: int
    ns1: int
    parent: int
    counts: Dict[str, int]


class _Thread(threading.local):
    def __init__(self):
        self.stack: List[int] = []  # this thread's open spans


_tls = _Thread()


def _alloc(capacity: int) -> None:
    global _cap, _mask, _ids, _seq, _name, _t0, _t1, _parent, _counts
    if capacity & (capacity - 1):
        raise ValueError(f"capacity {capacity} is not a power of two")
    _cap, _mask = capacity, capacity - 1
    _ids = itertools.count(1)
    _seq = [0] * capacity      # the index a slot holds (0: never written)
    _name = [""] * capacity
    _t0 = [0] * capacity
    _t1 = [0] * capacity       # 0 while the span is open
    _parent = [-1] * capacity
    _counts = [()] * capacity


_alloc(CAPACITY)


def begin(name: str) -> int:
    """Open a span inside this thread's innermost open span; its index."""
    stack = _tls.stack
    # the time is read before the index is taken: a span's children then
    # follow it in index order before any span that starts after it ends
    t0 = time.time_ns()
    i = next(_ids)
    k = i & _mask
    _seq[k] = 0  # a reader never pairs the new index with the old record
    _name[k], _t0[k], _t1[k], _counts[k] = name, t0, 0, ()
    _parent[k] = stack[-1] if stack else -1
    _seq[k] = i
    stack.append(i)
    return i


def end(i: int, *counts: int) -> None:
    """Close span ``i`` with its counts.  Spans this thread opened inside it
    and left open (an exception passed through them) stay unclosed."""
    t1 = time.time_ns()
    k = i & _mask
    if _seq[k] == i:  # else the ring has overwritten it
        _t1[k], _counts[k] = t1, counts
    stack = _tls.stack
    if stack and stack[-1] == i:
        stack.pop()
    elif i in stack:
        del stack[stack.index(i):]


def _span(k: int) -> Span:
    names = COUNTS.get(_name[k], ())
    return Span(_seq[k], _name[k], _t0[k], _t1[k], _parent[k], dict(zip(names, _counts[k])))


def spans(*names: str, ns0: Optional[int] = None, ns1: Optional[int] = None) -> List[Span]:
    """Closed spans the ring holds, in the order they began: those named
    ``names`` (all where none is given) that start at or after ``ns0`` and
    end at or before ``ns1``."""
    want = set(names)
    lo = -1 if ns0 is None else ns0
    hi = float("inf") if ns1 is None else ns1
    ks = [k for k in range(_cap) if _seq[k] and _t1[k] and (not want or _name[k] in want)
          and _t0[k] >= lo and _t1[k] <= hi]
    ks.sort(key=_seq.__getitem__)
    return [_span(k) for k in ks]


def children(span: Span) -> List[Span]:
    """The closed spans whose parent is ``span``, in the order they began.
    They follow it in index order, before any span that began after it
    ended (`begin`), so the scan stops there."""
    out = []
    i = span.index + 1
    while True:
        k = i & _mask
        if _seq[k] != i or _t0[k] > span.ns1:
            return out
        if _parent[k] == span.index and _t1[k]:
            out.append(_span(k))
        i += 1


def dropped() -> int:
    """Spans the ring overwrote: those written beyond its capacity."""
    return max(0, max(_seq) - _cap)


def reset(capacity: int = CAPACITY) -> None:
    """Empty the ring (of ``capacity`` records, a power of two).  Only
    while no other thread records."""
    _alloc(capacity)
    _tls.stack.clear()
