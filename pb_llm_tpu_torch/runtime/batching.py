"""Continuous batching (port of `pb_llm_tpu/runtime/batching.py`): admit
queued requests into free slots (same-bucket requests prefill together;
long prompts take the chunked path, one chunk per tick), run batched decode
steps over the pool, retire requests on EOS, a stop token, their budget or
a full cache.  A paged pool that runs out preempts the most recently
admitted request (recompute: its tokens fold into its prompt and it
requeues at the front).

With `EngineConfig.spec_gamma > 0` the decode tick runs speculatively:
each slot drafts γ tokens by prompt lookup (the most recent continuation of
its trailing n-gram in its own history) or from a ``draft_source``
(`runtime.draft.ModelDraftSource`), and one verify forward accepts the
exact-greedy prefix.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .engine import Engine, PoolExhausted


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
    preempted_output_logprobs: List[float] = dataclasses.field(default_factory=list)
    output_ids: List[int] = dataclasses.field(default_factory=list)
    # tokens generated BEFORE a recompute preemption: folded into prompt_ids
    # (and max_new_tokens decremented); merged back into output_ids at
    # retirement so callers see the whole stream
    preempted_output_ids: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # streaming hook: called on the scheduler thread with each generated
    # token, a Python int, as it is emitted (keep it non-blocking)
    on_token: Optional[Callable[[int], None]] = dataclasses.field(
        default=None, repr=False, compare=False)


@dataclasses.dataclass
class BatcherStats:
    generated_tokens: int = 0
    decode_steps: int = 0
    prefills: int = 0
    preemptions: int = 0
    spec_drafted: int = 0   # draft tokens verified
    spec_accepted: int = 0  # draft tokens accepted
    wall_seconds: float = 0.0

    @property
    def tokens_per_second(self) -> float:
        return self.generated_tokens / self.wall_seconds if self.wall_seconds else 0.0


class ContinuousBatcher:
    def __init__(self, engine: Engine, draft_source=None):
        """``draft_source``: optional object with ``propose(batcher, gamma)
        -> Optional[np.ndarray]`` replacing the prompt-lookup drafts; only
        consulted when ``engine.ecfg.spec_gamma > 0``."""
        self.engine = engine
        self.draft_source = draft_source
        self.queue: deque = deque()
        self.slot_to_request: Dict[int, Request] = {}
        self.stats = BatcherStats()
        self._admit_seq = 0
        self._admitted_at: Dict[int, int] = {}
        self._prefilling: Dict[int, Request] = {}  # chunked prefill jobs in flight

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        """Admit queued requests into free slots; consecutive same-bucket
        requests prefill together (up to ecfg.max_prefill_batch)."""
        chunk = self.engine.ecfg.prefill_chunk
        pool = self.engine.pool
        while True:
            free = [s for s in self.engine.free_slots() if s not in self._prefilling]
            max_k = max(1, self.engine.ecfg.max_prefill_batch)
            batch, reserved, bucket = [], 0, None
            while free and self.queue and len(batch) < max_k:
                req = self.queue[0]
                if chunk and len(req.prompt_ids) > chunk:
                    # long prompt: claim the slot and prefill it one chunk
                    # per tick; gate on (and reserve) the whole prompt's pages
                    if pool is not None:
                        need = pool.pages_needed(len(req.prompt_ids))
                        if pool.free_pages - reserved < need + 1:
                            break
                        reserved += need
                    self.queue.popleft()
                    slot = free.pop(0)
                    self.engine.set_slot_sampling(slot, req.sampling)
                    self.engine.start_chunked_prefill(slot, req.prompt_ids)
                    self._prefilling[slot] = req
                    continue
                if not self.engine.can_admit(len(req.prompt_ids), reserved_pages=reserved):
                    break  # paged pool full: wait for a retirement to free pages
                b = self.engine._bucket(len(req.prompt_ids))
                if bucket is None:
                    bucket = b
                elif b != bucket:
                    break  # next request pads to a different bucket: next round
                if pool is not None:
                    reserved += pool.pages_needed(bucket)
                self.queue.popleft()
                batch.append((free.pop(0), req))
            if not batch:
                return
            for s, r in batch:
                self.engine.set_slot_sampling(s, r.sampling)
            firsts = self.engine.prefill_batch([(s, r.prompt_ids) for s, r in batch])
            for slot, req in batch:
                self._start(slot, req, firsts[slot])

    def _start(self, slot: int, req: Request, first: int) -> None:
        self.stats.prefills += 1
        self.slot_to_request[slot] = req
        self._admitted_at[slot] = self._admit_seq
        self._admit_seq += 1
        self._emit(slot, req, first)

    def _preempt_one(self) -> bool:
        """Recompute preemption: evict the most recently admitted request,
        release its pages, fold its generated tokens into its prompt and
        requeue it at the front.  Greedy streams are unchanged by the
        recompute.  Returns False when no victim can be recomputed (its
        grown prompt no longer fits a bucket or the chunked path)."""
        chunk = self.engine.ecfg.prefill_chunk
        for slot in sorted(self.slot_to_request, key=lambda s: -self._admitted_at[s]):
            req = self.slot_to_request[slot]
            full = req.prompt_ids + req.output_ids
            if len(full) >= self.engine.ecfg.max_seq:
                continue
            if not (chunk and len(full) > chunk):
                try:
                    self.engine._bucket(len(full))
                except ValueError:
                    continue
            req.prompt_ids = full
            req.max_new_tokens -= len(req.output_ids)
            req.preempted_output_ids = req.preempted_output_ids + req.output_ids
            req.output_ids = []
            req.preempted_output_logprobs = req.preempted_output_logprobs + req.output_logprobs
            req.output_logprobs = []
            del self.slot_to_request[slot]
            self.engine.release(slot)
            self.queue.appendleft(req)
            self.stats.preemptions += 1
            return True
        return False

    def _emit(self, slot: int, req: Request, token: int, length: Optional[int] = None) -> None:
        """Append one generated token: stats, streaming callback, retirement."""
        req.output_ids.append(token)
        if req.logprobs:
            lps = self.engine.token_logprobs.get(slot)
            if lps:
                req.output_logprobs.append(lps.pop(0))
        self.stats.generated_tokens += 1
        if req.on_token is not None:
            req.on_token(int(token))
        self._maybe_retire(slot, token, length=length)

    def _maybe_retire(self, slot: int, token: int, length: Optional[int] = None) -> None:
        """``length``: the slot's sequence length as of this token (a
        speculative step emits several tokens; each is judged at its own
        position)."""
        req = self.slot_to_request[slot]
        hit_eos = req.eos_token_id is not None and token == req.eos_token_id
        hit_stop = bool(req.stop_token_ids) and token in req.stop_token_ids
        out_of_budget = len(req.output_ids) >= req.max_new_tokens
        cur = self.engine.lengths[slot] if length is None else length
        out_of_cache = cur + 1 >= self.engine.ecfg.max_seq
        if hit_eos or hit_stop or out_of_budget or out_of_cache:
            req.done = True
            if req.preempted_output_ids:  # merge recompute-preempted tokens back
                req.output_ids = req.preempted_output_ids + req.output_ids
                req.output_logprobs = req.preempted_output_logprobs + req.output_logprobs
                req.preempted_output_logprobs = []
                req.max_new_tokens += len(req.preempted_output_ids)
                req.preempted_output_ids = []
            del self.slot_to_request[slot]
            self.engine.release(slot)

    def _propose_drafts(self, gamma: int) -> Optional[np.ndarray]:
        """Prompt-lookup drafts [n_slots, γ], or None to fall back to plain
        decode this tick: for each active slot, the tokens that followed the
        most recent earlier occurrence of its trailing n-gram (n = 3, 2) in
        the last 512 tokens of its history.  A slot near max_seq forces the
        fallback (the verify writes γ+1 rows)."""
        eng = self.engine
        drafts = np.zeros((eng.ecfg.n_slots, gamma), np.int32)
        for slot, req in self.slot_to_request.items():
            if eng.lengths[slot] + gamma + 1 >= eng.ecfg.max_seq:
                return None
            hist = req.prompt_ids + req.output_ids
            lo = max(0, len(hist) - 512)
            for n in (3, 2):
                if len(hist) <= n:
                    continue
                key = hist[-n:]
                found = False
                for j in range(len(hist) - n - 1, lo - 1, -1):
                    if hist[j : j + n] == key:
                        cont = hist[j + n : j + n + gamma]
                        drafts[slot, : len(cont)] = cont
                        if cont:
                            drafts[slot, len(cont):] = cont[-1]
                        found = True
                        break
                if found:
                    break
        return drafts

    def _step_prefill_chunk(self) -> bool:
        """Advance the oldest chunked-prefill job by one chunk; False when
        the pool ran out and a request was preempted instead."""
        slot = next(iter(self._prefilling))  # FIFO (dict insertion order)
        req = self._prefilling[slot]
        try:
            tok = self.engine.prefill_chunk_step(slot)
        except PoolExhausted:
            if not self._preempt_one():
                raise
            return False
        if tok is not None:
            del self._prefilling[slot]
            self._start(slot, req, tok)
        return True

    def _check_admissible(self) -> None:
        """Nothing runs and the head request still cannot be admitted: it
        can never fit (pool smaller than its footprint), so fail loudly."""
        req = self.queue[0]
        n = len(req.prompt_ids)
        chunk = self.engine.ecfg.prefill_chunk
        pool = self.engine.pool
        if chunk and n > chunk:
            ok = pool is None or pool.free_pages >= pool.pages_needed(n) + 1
        else:
            ok = self.engine.can_admit(n)
        if not ok:
            raise RuntimeError(f"request {req.request_id} (prompt {n}) cannot be admitted even "
                               "with an idle engine — page pool smaller than its footprint")

    def _spec_tick(self, gamma: int) -> bool:
        """One speculative tick; False when no drafts were proposed (the
        caller runs a plain decode step instead)."""
        if self.draft_source is not None:
            drafts = self.draft_source.propose(self, gamma)
        else:
            drafts = self._propose_drafts(gamma)
        if drafts is None:
            return False
        try:
            tok_lists = self.engine.spec_decode_step(drafts)
        except PoolExhausted:
            if not self._preempt_one():
                raise
            return True
        self.stats.decode_steps += 1
        for slot, toks in tok_lists.items():
            req = self.slot_to_request.get(slot)
            if req is None:
                continue
            self.stats.spec_drafted += gamma
            self.stats.spec_accepted += len(toks) - 1
            # engine.lengths advanced by the whole window: judge each token
            # at its own position
            base_len = int(self.engine.lengths[slot]) - len(toks)
            for idx, tok in enumerate(toks):
                self._emit(slot, req, tok, length=base_len + idx + 1)
                if req.done:
                    break  # tokens past EOS/budget are discarded
        return True

    def step(self) -> None:
        """One scheduler tick: admit new work, advance one chunked-prefill
        job (if any), then one batched decode (or speculative) step."""
        self._admit()
        if self._prefilling and not self._step_prefill_chunk():
            return
        if self.queue and not self.slot_to_request and not self._prefilling:
            self._check_admissible()
        gamma = self.engine.ecfg.spec_gamma
        if gamma and self.slot_to_request and self._spec_tick(gamma):
            return
        try:
            toks = self.engine.decode_step()
        except PoolExhausted:
            # shed load and retry next tick (the freed pages unblock the others)
            if not self._preempt_one():
                raise
            return
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
        while self.queue or self.slot_to_request or self._prefilling:
            self.step()
        self.stats.wall_seconds += time.time() - t0
        return list(requests)
