"""One run's records: the requests sent through the port's `ServingLoop`,
each token's host time as its `on_token` callback saw it, and a span for
each engine call (`Engine.prefill_batch`, `Engine.decode_step`), timed by
wrappers of the benchmark's own around the engine's methods (every such
call ends in a device synchronisation: both hand the batcher Python ints).

A traffic kind (`benchmark/traffic/kinds/`) drives a `Session`: it submits
requests, opens and closes the measured window and, for an open loop,
drains.  Metric readers (`benchmark/metrics/`) read the finished session.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from ..weights import derive_seed

clock = time.perf_counter
TRACE_SECONDS = 10.0  # a 45 s trace of a batch cell holds ~3.3 M device activities: ~2 min to read


def _key(prompt) -> tuple:
    """A prompt's key: the loop hands the engine its own copy of the list,
    so admissions are matched by content (random ids over the vocabulary:
    the first 16 and the length tell prompts apart)."""
    return (len(prompt),) + tuple(prompt[:16])


@dataclasses.dataclass(eq=False)
class Record:
    """One request, as its client saw it."""

    rid: int
    tags: tuple
    prompt: List[int]
    max_new: int
    due: float                      # when it was due to be sent
    sent: float = 0.0               # when `ServingLoop.submit` returned
    admitted: float = float("nan")  # start of the prefill call that admitted it
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    finished: float = float("nan")
    request: object = None          # the port's `Request`
    on_done: Optional[Callable[[], None]] = None

    @property
    def done(self) -> bool:
        return self.finished == self.finished  # not NaN


@dataclasses.dataclass
class Span:
    """One engine call: host times (perf_counter and, for the trace, the
    wall clock in ns), the rows it computed and the useful ones."""

    kind: str          # "prefill" | "decode"
    t0: float
    t1: float
    ns0: int
    ns1: int
    rows: int          # useful rows: real prompt tokens / active slots
    computed: int      # rows through the linears: K·bucket / n_slots
    kv_rows: int       # decode: cache rows the attention reads over all slots
    kv_active: int     # decode: of those, the active slots' rows
    attn_pairs: float  # (row, key) pairs a layer the mathematics needs
    lens: tuple = ()   # prefill: each prompt's length


class Session:
    def __init__(self, loop, engine, seed: int, vocab: int, max_seq: int, sheet: dict,
                 device_name: str):
        self.loop, self.engine, self.seed = loop, engine, seed
        self.vocab, self.max_seq, self.sheet = vocab, max_seq, sheet
        self.device_name = device_name
        self.n_slots = engine.ecfg.n_slots
        self.records: List[Record] = []
        self.spans: List[Span] = []
        self.lateness: List[float] = []  # open loops: send time − due time
        self.t_open = self.t_close = float("nan")
        self.closed = False
        self.loop_error: Optional[BaseException] = None
        self._by_prompt = {}
        self._lock = threading.Lock()
        # held around every engine call (all the scheduler thread's device
        # work): the profiler starts and stops under it, since stopping it
        # while another thread replays a CUDA graph can deadlock the two
        self.gate = threading.Lock()
        self.trace = None   # `trace.Tracer.read()` of a traced run
        self.extra = {}     # what a kind or the harness adds for the readers
        self.memory: Optional[Callable[[str], None]] = None
        self._ns_base, self._pc_base = time.time_ns(), clock()

    def ns(self, t: float) -> int:
        """A perf_counter time on the wall clock in ns (the trace's clock)."""
        return int(self._ns_base + (t - self._pc_base) * 1e9)

    # -- requests ----------------------------------------------------------

    def prompt(self, n: int, *tags) -> List[int]:
        rng = np.random.default_rng(derive_seed(self.seed, "prompt", *tags))
        return rng.integers(0, self.vocab, n).tolist()

    def submit(self, prompt_len: int, max_new: int, tags: tuple, due: Optional[float] = None,
               on_done: Optional[Callable[[], None]] = None) -> Record:
        """Send one greedy request (no EOS: it runs to ``max_new`` tokens or
        a full cache) through the serving loop."""
        now = clock()
        rec = Record(rid=-1, tags=tags, prompt=self.prompt(prompt_len, *tags), max_new=max_new,
                     due=now if due is None else due, on_done=on_done)
        with self._lock:  # the scheduler thread sends a closed loop's next requests too
            rec.rid = len(self.records)
            self.records.append(rec)
            self._by_prompt[_key(rec.prompt)] = rec
        rec.request = self.loop.submit(rec.prompt, max_new_tokens=max_new,
                                       on_token=lambda tok, r=rec: self._token(r, tok))
        rec.sent = clock()
        return rec

    def _token(self, rec: Record, tok: int) -> None:
        """The streaming hook, on the scheduler thread."""
        now = clock()
        rec.times.append(now)
        rec.tokens.append(tok)
        if len(rec.tokens) >= rec.max_new or len(rec.prompt) + len(rec.tokens) >= self.max_seq:
            rec.finished = now
            if rec.on_done is not None:
                rec.on_done()

    def start(self) -> None:
        """Start the serving loop's scheduler thread: what was submitted
        before waits in its queue, so a closed loop's first requests are all
        there at its first tick, whatever the host's timing.  A later
        session on the same loop (the rate sweep) finds it running."""
        if self.loop._thread is None:
            self.loop.start()

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float, tracer=None) -> None:
        """Open the window, hold it ``seconds``, close it.  A traced run then
        traces `TRACE_SECONDS` more of the same traffic, which runs on until
        the trace ends: the profiler (CUPTI) starts only after the window
        has closed, so the program's spans in the window are an untraced
        run's, and it keeps recording until `stop_trace`.  ``memory`` (the
        card's allocator) is told when the window opens and closes."""
        self.t_open = clock()
        if self.memory is not None:
            self.memory("open")
        self.sleep_until(self.t_open + seconds)
        self.t_close = clock()
        if self.memory is not None:
            self.memory("close")
        if tracer is not None:
            with self.gate:
                tracer.start()
            self.sleep_until(clock() + TRACE_SECONDS)
            tracer.mark_end()
        self.closed = True

    def stop_trace(self, tracer) -> None:
        """Stop the profiler between two engine calls (it takes seconds:
        the runner calls this once the kind has drained)."""
        with self.gate:
            tracer.pause()

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def failed(self) -> Optional[BaseException]:
        return self.loop._error if self.loop is not None else self.loop_error

    def wait(self, pred: Callable[[], bool], timeout: float, poll: float = 0.005) -> bool:
        """Wait until ``pred()`` or the timeout or the loop's death."""
        end = clock() + timeout
        while not pred():
            if self.failed() is not None or clock() > end:
                return False
            time.sleep(poll)
        return True

    def sleep_until(self, t: float) -> None:
        while True:
            left = t - clock()
            if left <= 0 or self.failed() is not None:
                return
            time.sleep(min(left, 0.05))

    # -- engine spans ----------------------------------------------------------

    def instrument(self) -> None:
        """Wrap the engine's prefill and decode calls with spans."""
        eng = self.engine
        if not hasattr(eng, "_bench_unwrapped"):  # a later session wraps the originals
            eng._bench_unwrapped = (eng.prefill_batch, eng.decode_step)
        prefill_batch, decode_step = eng._bench_unwrapped

        def timed_prefill(pairs):
            pairs = list(pairs)
            lens = tuple(len(p) for _, p in pairs)
            with self.gate:
                t0, ns0 = clock(), time.time_ns()
                with self._lock:
                    for _, p in pairs:
                        rec = self._by_prompt.get(_key(p))
                        if rec is not None and rec.admitted != rec.admitted:
                            rec.admitted = t0
                out = prefill_batch(pairs)
                t1, ns1 = clock(), time.time_ns()
            self.spans.append(Span("prefill", t0, t1, ns0, ns1, sum(lens),
                                   len(lens) * eng._bucket(max(lens)), 0, 0,
                                   sum(n * (n + 1) / 2 for n in lens), lens))
            return out

        def timed_decode():
            active = int(eng.active.sum())
            kv_active = int(eng.lengths[eng.active].sum()) + active
            kv_rows = int(eng.lengths.sum()) + self.n_slots
            with self.gate:
                t0, ns0 = clock(), time.time_ns()
                out = decode_step()
                t1, ns1 = clock(), time.time_ns()
            if active:
                self.spans.append(Span("decode", t0, t1, ns0, ns1, active, self.n_slots, kv_rows,
                                       kv_active, kv_active))
            return out

        eng.prefill_batch, eng.decode_step = timed_prefill, timed_decode

    # -- views for the readers ----------------------------------------------

    def spans_in_window(self, kind: Optional[str] = None) -> List[Span]:
        """Engine calls that started and ended inside the window."""
        return [s for s in self.spans if s.t0 >= self.t_open and s.t1 <= self.t_close
                and (kind is None or s.kind == kind)]

    def due_in_window(self) -> List[Record]:
        return [r for r in self.records if self.t_open <= r.due < self.t_close]
