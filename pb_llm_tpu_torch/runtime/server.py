"""HTTP serving front end over the continuous batcher (port of
`pb_llm_tpu/runtime/server.py`).

A scheduler thread drives `ContinuousBatcher.step()` whenever work is
queued, and a stdlib `ThreadingHTTPServer` exposes

    POST /generate   {"prompt": "...", "max_new_tokens": 32, ...}
                     or {"prompt_ids": [...]}: blocks until the request
                     retires, returns {"request_id", "output_ids", "text"?}.
                     With "stream": true, tokens arrive as NDJSON lines the
                     moment the batcher emits them (Connection: close).
    GET  /health     {"status": "ok"}
    GET  /stats      batcher counters (tokens, steps, prefills, tokens/s)

Requests from concurrent handlers land in the one batcher queue and share
decode steps.  No third-party package: threads and one condition variable.
All device work stays on the scheduler thread: the engine enters
`torch.inference_mode` and its `KernelConfig` (both thread-local) in each of
its calls, on that thread, and hands the batcher Python ints, so a handler
thread never touches a CUDA tensor.
"""

from __future__ import annotations

import json
import queue as queue_mod
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from .batching import ContinuousBatcher, Request
from .engine import Engine


class ServingLoop:
    """Thread-safe wrapper: one scheduler thread owns all engine calls."""

    def __init__(self, engine: Engine, draft_source=None):
        self.batcher = ContinuousBatcher(engine, draft_source=draft_source)
        self._cond = threading.Condition()
        self._pending: list = []  # handler → scheduler handoff; under _cond
        self._stop = False
        self._error: Optional[BaseException] = None
        self._next_id = 0
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServingLoop":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def shutdown(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread:
            self._thread.join(timeout=30)

    def _has_work(self) -> bool:
        return bool(self.batcher.queue or self.batcher.slot_to_request
                    or self.batcher._prefilling)

    def _run(self) -> None:
        """Scheduler thread, the sole owner of the batcher and the engine.
        The lock is held only for the handoff and notifications, never
        across a device step, so handlers submit without waiting on decode."""
        while True:
            with self._cond:
                if self._stop:
                    return
                for req in self._pending:
                    self.batcher.submit(req)
                self._pending.clear()
                if not self._has_work():
                    self._cond.wait(timeout=0.05)
                    continue
            try:
                t0 = time.time()
                self.batcher.step()  # outside the lock: device work
                self.batcher.stats.wall_seconds += time.time() - t0
            except Exception as e:  # the scheduler must not die silently: waiters raise it
                with self._cond:
                    self._error = e
                    self._stop = True
                    self._cond.notify_all()
                return
            with self._cond:
                self._cond.notify_all()

    # -- request API -------------------------------------------------------

    def submit(self, prompt_ids: List[int], max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None,
               on_token: Optional[Callable[[int], None]] = None,
               sampling=None, stop_token_ids=None, logprobs: bool = False) -> Request:
        with self._cond:
            if self._error is not None:
                raise RuntimeError(f"serving loop died: {self._error!r}")
            self._next_id += 1
            req = Request(request_id=self._next_id, prompt_ids=list(prompt_ids),
                          max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
                          on_token=on_token, sampling=sampling,
                          stop_token_ids=stop_token_ids, logprobs=logprobs)
            self._pending.append(req)
            self._cond.notify_all()
            return req

    def wait(self, req: Request, timeout: Optional[float] = None) -> Request:
        with self._cond:
            if not self._cond.wait_for(lambda: req.done or self._stop, timeout=timeout):
                raise TimeoutError(f"request {req.request_id} timed out")
            if not req.done and self._error is not None:
                raise RuntimeError(f"serving loop died: {self._error!r}")
        return req

    def generate(self, prompt_ids: List[int], max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 timeout: Optional[float] = None, sampling=None,
                 stop_token_ids=None, logprobs: bool = False) -> Request:
        return self.wait(
            self.submit(prompt_ids, max_new_tokens, eos_token_id,
                        sampling=sampling, stop_token_ids=stop_token_ids,
                        logprobs=logprobs), timeout)


def make_handler(loop: ServingLoop,
                 encode: Optional[Callable[[str], List[int]]] = None,
                 decode: Optional[Callable[[List[int]], str]] = None,
                 request_timeout: float = 600.0):
    def _sampling_from(payload):
        """Per-request SamplingParams from the JSON fields, or None (the
        engine's) when none is given.  Omitted fields take the ENGINE's
        values: a request setting only top_k is not flipped to greedy."""
        if not any(k in payload for k in ("temperature", "top_k", "top_p")):
            return None
        from .sampler import SamplingParams

        base = loop.batcher.engine.sampling
        return SamplingParams(
            temperature=float(payload.get("temperature", base.temperature)),
            top_k=int(payload.get("top_k", base.top_k)),
            top_p=float(payload.get("top_p", base.top_p)),
        )

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                return self._reply(200, {"status": "ok"})
            if self.path == "/stats":
                s = loop.batcher.stats
                out = {
                    "generated_tokens": s.generated_tokens,
                    "decode_steps": s.decode_steps,
                    "prefills": s.prefills,
                    "preemptions": s.preemptions,
                    "spec_drafted": s.spec_drafted,
                    "spec_accepted": s.spec_accepted,
                    "wall_seconds": round(s.wall_seconds, 3),
                    "tokens_per_second": round(s.tokens_per_second, 2),
                }
                pool = loop.batcher.engine.pool
                if pool is not None and pool.prefix_cache:
                    out["prefix_queries"] = pool.prefix_queries
                    out["prefix_hit_pages"] = pool.prefix_hit_pages
                return self._reply(200, out)
            return self._reply(404, {"error": f"unknown path {self.path}"})

        def _stream(self, ids, payload):
            """One NDJSON line per generated token over a Connection: close
            response (no Content-Length; the client reads to EOF).  The
            scheduler thread feeds a queue through the request's on_token
            hook; this handler thread drains it."""
            q: "queue_mod.Queue" = queue_mod.Queue()
            req = loop.submit(
                ids, max_new_tokens=int(payload.get("max_new_tokens", 32)),
                eos_token_id=payload.get("eos_token_id"), on_token=q.put,
                sampling=_sampling_from(payload),
                stop_token_ids=payload.get("stop_token_ids"),
                logprobs=bool(payload.get("logprobs")))

            # the end sentinel comes from a watcher thread: on_token fires
            # BEFORE retirement sets req.done, so polling done after the last
            # token would race the scheduler; loop.wait() sees the retirement
            def _watch():
                try:
                    loop.wait(req, timeout=request_timeout)
                except (TimeoutError, RuntimeError):
                    pass  # the tail line reports done: false
                q.put(None)

            threading.Thread(target=_watch, daemon=True).start()
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Connection", "close")
            self.end_headers()
            while True:
                tok = q.get()
                if tok is None:
                    break
                line = {"token": tok}
                if decode is not None:
                    line["text"] = decode([tok])
                self.wfile.write((json.dumps(line) + "\n").encode())
                self.wfile.flush()
            tail = {"request_id": req.request_id, "done": req.done,
                    "output_ids": req.output_ids}
            if req.logprobs:
                tail["logprobs"] = req.output_logprobs
            self.wfile.write((json.dumps(tail) + "\n").encode())
            self.close_connection = True

        def do_POST(self):
            if self.path != "/generate":
                return self._reply(404, {"error": f"unknown path {self.path}"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if "prompt_ids" in payload:
                    ids = [int(t) for t in payload["prompt_ids"]]
                elif "prompt" in payload and encode is not None:
                    ids = encode(payload["prompt"])
                else:
                    return self._reply(400, {"error": "need prompt_ids (or prompt, when the "
                                                      "server has a tokenizer)"})
                if payload.get("stream"):
                    return self._stream(ids, payload)
                req = loop.generate(
                    ids,
                    max_new_tokens=int(payload.get("max_new_tokens", 32)),
                    eos_token_id=payload.get("eos_token_id"),
                    timeout=request_timeout,
                    sampling=_sampling_from(payload),
                    stop_token_ids=payload.get("stop_token_ids"),
                    logprobs=bool(payload.get("logprobs")),
                )
            except TimeoutError as e:
                return self._reply(504, {"error": str(e)})
            except Exception as e:  # malformed JSON, bad types
                return self._reply(400, {"error": str(e)})
            out = {"request_id": req.request_id, "output_ids": req.output_ids}
            if req.logprobs:
                out["logprobs"] = req.output_logprobs
            if decode is not None:
                out["text"] = decode(req.output_ids)
            return self._reply(200, out)

    return Handler


def serve_http(engine: Engine, host: str = "0.0.0.0", port: int = 8000,
               encode=None, decode=None, draft_source=None) -> ThreadingHTTPServer:
    """Start the scheduler loop and the HTTP server; returns the running
    server (port 0 binds a free port: read it from ``server_address``).

    Stop with `server.shutdown()`, then `server.serving_loop.shutdown()`."""
    loop = ServingLoop(engine, draft_source=draft_source).start()
    server = ThreadingHTTPServer((host, port), make_handler(loop, encode, decode))
    server.serving_loop = loop
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
