"""Continuous batching across ranks (port of `pb_llm_tpu/runtime/
multihost_batching.py`): rank 0 decides admissions, every rank runs them.

Every rank of a serving world (one process a rank, `parallel.mesh`) must
issue the same engine calls in the same order, so scheduling cannot depend
on rank-local state.  The split:

  * decisions that follow from the token streams (retirement on EOS, a stop
    token, the budget or a full cache; slot freeing; preemption under pool
    pressure; speculative drafts) replicate on every rank for free: the
    decode outputs are the same everywhere (greedy, or sampling from the
    same seeded generator);
  * the one input that is not — WHICH request enters a free slot, and its
    prompt — is decided on rank 0 and broadcast
    (`parallel.collectives.broadcast_one_to_all`) as a fixed-shape int32
    admission record before each tick.

With one process the broadcast is the identity and this class serves as
`runtime.batching.ContinuousBatcher` does (the tests hold it to JAX's).
The engine under it is a replica `Engine` on each rank or a rank's
`TPEngine`.  Requests and their ``on_token`` callbacks and logprobs are rich
on rank 0 only; the other ranks mirror them as shadow `Request`s.

`tick` broadcasts the HTTP scheduler's loop word (`runtime.server`), and
`follow` is the loop of a rank > 0 under it.
"""

from __future__ import annotations

import operator
import time

import numpy as np

from ..parallel.collectives import broadcast_one_to_all
from .batching import ContinuousBatcher, Request
from .engine import Engine
from .sampler import SamplingParams

# the scheduler's loop word (`tick`): a step follows, nothing this time, or leave
TICK_IDLE, TICK_WORK, TICK_STOP = 0, 1, 2
_I32_MAX = 2**31 - 1


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class MultiHostBatcher(ContinuousBatcher):
    """`ContinuousBatcher` whose admissions come from rank 0's record; its
    emission, retirement, speculative tick and decode step are the base
    class's, run alike on every rank."""

    _REC_META = 12  # columns before the prompt
    _MAX_STOP = 4  # stop_token_ids carried in the record (columns 8..11)

    def __init__(self, engine: Engine, max_admits_per_tick: int = 4, max_prompt: int = 512,
                 draft_source=None):
        # a draft model (`runtime.draft.ModelDraftSource`) needs no broadcast:
        # its proposals are a function of the request histories, the same on
        # every rank, through a replica draft engine on each
        super().__init__(engine, draft_source=draft_source)
        self.max_admits = max_admits_per_tick
        self.max_prompt = max_prompt
        # the admission order (_admitted_at) follows the record, alike on
        # every rank, so preemption picks the same victim everywhere
        self.is_host0 = _rank() == 0

    def submit(self, req: Request) -> None:
        """Requests are queued on rank 0; the others receive them in the record."""
        if self.is_host0:
            super().submit(req)

    def check(self, req: Request) -> None:
        """Raise ValueError for a request the admission record cannot carry:
        more than 4 stop ids, a prompt longer than max_prompt, a value
        outside int32 or a negative one.  Called before a request is queued
        (`submit`, and `runtime.server.ServingLoop.submit` on the handler's
        thread), so nothing of a request can raise inside a step, where it
        would raise on rank 0 alone and leave the other ranks in the next
        broadcast."""
        self._row(req)

    def _row(self, req: Request) -> np.ndarray:
        """``req``'s row of the admission record, its slot column -1:
        (slot, request_id, budget_left, eos, true_len, temp_fp, top_k,
        top_p_fp, stop_0..stop_3, prompt...); eos -1 none, temp_fp -1 the
        engine's sampling, -1 an unused stop or prompt column.  budget_left
        is the budget still to generate (after a preemption), so shadow
        requests retire on the same tick as rank 0's.  Sampling rides in
        1e-6 fixed point."""
        stops = list(req.stop_token_ids or [])
        if len(stops) > self._MAX_STOP:
            raise ValueError(f"the admission record carries at most {self._MAX_STOP} "
                             f"stop_token_ids, got {len(stops)}")
        if len(req.prompt_ids) > self.max_prompt:
            raise ValueError(f"a prompt of {len(req.prompt_ids)} tokens: the admission record "
                             f"carries at most {self.max_prompt}")
        # (name, value, carried in 1e-6 fixed point): every one lands in 0..2^31-1
        values = [("request_id", req.request_id, False),
                  ("max_new_tokens", req.max_new_tokens - len(req.output_ids), False)]
        if req.eos_token_id is not None:
            values.append(("eos_token_id", req.eos_token_id, False))
        sp = req.sampling
        if sp is not None:
            values += [("temperature", sp.temperature, True), ("top_k", sp.top_k, False),
                       ("top_p", sp.top_p, True)]
        values += [(f"stop_token_ids[{i}]", t, False) for i, t in enumerate(stops)]
        values += [(f"prompt_ids[{i}]", t, False) for i, t in enumerate(req.prompt_ids)]
        col = {}
        for name, x, fixed in values:
            try:
                col[name] = round(x * 1e6) if fixed else operator.index(x)
            except (TypeError, ValueError, OverflowError):
                col[name] = -1
            if not 0 <= col[name] <= _I32_MAX:
                raise ValueError(f"{name} = {x!r}: the admission record carries "
                                 + ("a 1e-6 fixed point" if fixed else "an integer")
                                 + f" in 0..{_I32_MAX}")
        row = np.full(self._REC_META + self.max_prompt, -1, np.int32)
        row[1:5] = (col["request_id"], col["max_new_tokens"], col.get("eos_token_id", -1),
                    len(req.prompt_ids))
        if sp is not None:
            row[5:8] = (col["temperature"], col["top_k"], col["top_p"])
        row[8 : 8 + len(stops)] = stops
        row[self._REC_META : self._REC_META + len(req.prompt_ids)] = req.prompt_ids
        return row

    def _admission_record(self) -> np.ndarray:
        """Fixed-shape [max_admits, 12 + max_prompt] int32 record, a row an
        admission (`_row`); slot -1 is an empty row.  Every rank, rank 0
        too, installs the sampling values the record decodes to."""
        rec = np.full((self.max_admits, self._REC_META + self.max_prompt), -1, np.int32)
        if not self.is_host0:
            return rec
        free = [s for s in self.engine.free_slots()
                if s not in self.slot_to_request and s not in self._prefilling]
        # a paged pool allocates at prefill (in _apply_admissions): count every
        # admission of this record before checking the next
        pool = self.engine.pool
        chunk = self.engine.ecfg.prefill_chunk
        pages_left = pool.free_pages if pool is not None else None
        for row, slot in enumerate(free[: self.max_admits]):
            if not self.queue:
                break
            if pool is not None:
                n = len(self.queue[0].prompt_ids)
                need = pool.pages_needed(n if chunk and n > chunk else self.engine._bucket(n))
                if pages_left < need + 1:  # a page of decode headroom
                    break
                pages_left -= need
            req = self.queue.popleft()
            rec[row] = self._row(req)
            rec[row, 0] = slot
            self.slot_to_request[slot] = req  # rank 0 keeps the rich request
        return rec

    def _admit(self) -> None:
        self._apply_admissions(broadcast_one_to_all(self._admission_record()))

    def _apply_admissions(self, rec: np.ndarray) -> None:
        """Prefill the record's admissions alike on every rank: consecutive
        same-bucket rows together (up to ecfg.max_prefill_batch), long
        prompts as chunked jobs."""
        rows = []
        chunk = self.engine.ecfg.prefill_chunk
        for row in rec:
            slot = int(row[0])
            if slot < 0:
                continue
            m = self._REC_META
            prompt = row[m : m + int(row[4])].tolist()
            sp = None
            if int(row[5]) >= 0:
                sp = SamplingParams(temperature=int(row[5]) / 1e6, top_k=int(row[6]),
                                    top_p=int(row[7]) / 1e6)
            stops = [int(t) for t in row[8:12] if int(t) >= 0] or None
            self.engine.set_slot_sampling(slot, sp)
            if not self.is_host0:
                self.slot_to_request[slot] = Request(
                    request_id=int(row[1]), prompt_ids=prompt, max_new_tokens=int(row[2]),
                    eos_token_id=None if int(row[3]) < 0 else int(row[3]),
                    sampling=sp, stop_token_ids=stops)
            self._admitted_at[slot] = self._admit_seq
            self._admit_seq += 1
            if chunk and len(prompt) > chunk:
                self._prefilling[slot] = self.slot_to_request.pop(slot)
                self.engine.start_chunked_prefill(slot, prompt)
                continue
            rows.append((slot, prompt))
        max_k = max(1, self.engine.ecfg.max_prefill_batch)
        i = 0
        while i < len(rows):
            bucket = self.engine._bucket(len(rows[i][1]))
            group = [rows[i]]
            i += 1
            while (i < len(rows) and len(group) < max_k
                   and self.engine._bucket(len(rows[i][1])) == bucket):
                group.append(rows[i])
                i += 1
            firsts = self.engine.prefill_batch(group)
            for slot, _ in group:
                self._start(slot, self.slot_to_request[slot], firsts[slot])

    def _start(self, slot: int, req: Request, first: int) -> None:
        """A prefill's first token; the admission order was taken from the
        record (`_apply_admissions`), a chunked job's too."""
        self.stats.prefills += 1
        self.slot_to_request[slot] = req
        self._emit(slot, req, first)

    def _preempt_one(self) -> bool:
        """Recompute preemption (`ContinuousBatcher._preempt_one`): the
        victim is a function of state alike on every rank; rank 0 requeues
        the folded request, the others drop their shadow and mirror it again
        when rank 0 readmits it."""
        for slot in sorted(self.slot_to_request, key=lambda s: -self._admitted_at[s]):
            req = self.slot_to_request[slot]
            full = req.prompt_ids + req.output_ids
            if len(full) >= self.engine.ecfg.max_seq or len(full) > self.max_prompt:
                continue
            try:
                self.engine._bucket(len(full))
            except ValueError:
                continue
            del self.slot_to_request[slot]
            self.engine.release(slot)
            if self.is_host0:
                req.prompt_ids = full
                req.max_new_tokens -= len(req.output_ids)
                req.preempted_output_ids = req.preempted_output_ids + req.output_ids
                req.output_ids = []
                req.preempted_output_logprobs = (req.preempted_output_logprobs
                                                 + req.output_logprobs)
                req.output_logprobs = []
                self.queue.appendleft(req)
            self.stats.preemptions += 1
            return True
        return False

    def _check_admissible(self) -> None:
        """An idle engine (alike on every rank) whose head request still
        cannot be admitted never will: rank 0 broadcasts the stuck word and
        EVERY rank raises (a raise on rank 0 alone would leave the others in
        the next broadcast)."""
        stuck = 0
        if self.is_host0 and self.queue:
            req = self.queue[0]
            if not self.engine.can_admit(len(req.prompt_ids)):
                stuck = req.request_id + 1
        stuck = int(broadcast_one_to_all(np.asarray([stuck], np.int32))[0])
        if stuck:
            raise RuntimeError(f"request {stuck - 1} cannot be admitted even with an idle "
                               "engine — page pool smaller than its bucket")

    def pending(self) -> bool:
        """Any work left, by rank 0's view (only it holds the queue)."""
        return int(broadcast_one_to_all(np.asarray([super().pending()], np.int32))[0]) > 0

    def tick(self, word: int) -> int:
        """Rank 0's scheduler word (TICK_IDLE, TICK_WORK or TICK_STOP) on
        every rank."""
        return int(broadcast_one_to_all(np.asarray([word], np.int32))[0])


def follow(batcher: MultiHostBatcher) -> None:
    """The serving loop of a rank > 0 under rank 0's `runtime.server`
    scheduler: a step for every TICK_WORK word, until TICK_STOP."""
    while True:
        word = batcher.tick(TICK_IDLE)
        if word == TICK_STOP:
            return
        if word == TICK_WORK:
            t0 = time.time()
            batcher.step()
            batcher.stats.wall_seconds += time.time() - t0
