"""Continuous batching over the strip engine (port of
`pb_llm_tpu/runtime/batching.py`): admit queued requests into free slots
(same-bucket requests prefill together), run batched decode steps over the
pool, retire requests on EOS, a stop token, their budget or a full cache.
Preemption, chunked prefill and speculative ticks belong to the paged /
spec engine and are not ported yet."""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from .engine import Engine


@dataclasses.dataclass
class Request:
    request_id: int
    prompt_ids: List[int]
    max_new_tokens: int = 64
    eos_token_id: Optional[int] = None
    sampling: Optional[object] = None
    stop_token_ids: Optional[List[int]] = None
    logprobs: bool = False
    output_logprobs: List[float] = dataclasses.field(default_factory=list)
    output_ids: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class BatcherStats:
    generated_tokens: int = 0
    decode_steps: int = 0
    prefills: int = 0
    wall_seconds: float = 0.0

    @property
    def tokens_per_second(self) -> float:
        return self.generated_tokens / self.wall_seconds if self.wall_seconds else 0.0


class ContinuousBatcher:
    def __init__(self, engine: Engine):
        self.engine = engine
        self.queue: deque = deque()
        self.slot_to_request: Dict[int, Request] = {}
        self.stats = BatcherStats()

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        """Admit queued requests into free slots; consecutive same-bucket
        requests prefill together (up to ecfg.max_prefill_batch)."""
        while True:
            free = self.engine.free_slots()
            max_k = max(1, self.engine.ecfg.max_prefill_batch)
            batch, bucket = [], None
            while free and self.queue and len(batch) < max_k:
                req = self.queue[0]
                b = self.engine._bucket(len(req.prompt_ids))
                if bucket is None:
                    bucket = b
                elif b != bucket:
                    break
                self.queue.popleft()
                batch.append((free.pop(0), req))
            if not batch:
                return
            for s, r in batch:
                self.engine.set_slot_sampling(s, r.sampling)
            firsts = self.engine.prefill_batch([(s, r.prompt_ids) for s, r in batch])
            for slot, req in batch:
                self.stats.prefills += 1
                self.slot_to_request[slot] = req
                self._emit(slot, req, firsts[slot])

    def _emit(self, slot: int, req: Request, token: int) -> None:
        req.output_ids.append(token)
        if req.logprobs:
            lps = self.engine.token_logprobs.get(slot)
            if lps:
                req.output_logprobs.append(lps.pop(0))
        self.stats.generated_tokens += 1
        self._maybe_retire(slot, token)

    def _maybe_retire(self, slot: int, token: int) -> None:
        req = self.slot_to_request[slot]
        hit_eos = req.eos_token_id is not None and token == req.eos_token_id
        hit_stop = bool(req.stop_token_ids) and token in req.stop_token_ids
        out_of_budget = len(req.output_ids) >= req.max_new_tokens
        out_of_cache = self.engine.lengths[slot] + 1 >= self.engine.ecfg.max_seq
        if hit_eos or hit_stop or out_of_budget or out_of_cache:
            req.done = True
            del self.slot_to_request[slot]
            self.engine.release(slot)

    def step(self) -> None:
        """One scheduler tick: admit new work, then one batched decode step."""
        self._admit()
        toks = self.engine.decode_step()
        for slot, tok in toks.items():
            req = self.slot_to_request.get(slot)
            if req is not None:
                self._emit(slot, req, tok)
        self.stats.decode_steps += 1

    def run(self, requests: Sequence[Request]) -> List[Request]:
        """Serve all requests to completion; returns them with outputs."""
        for r in requests:
            self.submit(r)
        t0 = time.time()
        while self.queue or self.slot_to_request:
            self.step()
        self.stats.wall_seconds += time.time() - t0
        return list(requests)
