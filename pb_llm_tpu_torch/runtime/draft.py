"""Draft-model speculative decoding (port of `pb_llm_tpu/runtime/draft.py`).

`ContinuousBatcher` verifies γ draft tokens per engine step
(`Engine.spec_decode_step`), greedy-exact wherever the drafts come from.
`ModelDraftSource` proposes them by rolling a small draft model in its own
strip-cache engine.  Wrong drafts cost only wasted verify work.

Sync protocol (host-side integers; the draft engine's caches are written
only through its own prefill and decode steps):
- admission is LAZY: the first `propose()` that sees a slot prefills the
  draft engine with that request's history (this covers slots that arrive
  through chunked prefill or preemption re-admission);
- after a verify step accepted k ≤ γ tokens, the draft rows at positions
  ≤ L+k hold exactly the accepted stream, so rollback is just
  ``lengths[slot] = new_target_length`` (rows past a length are
  overwritten in place);
- ticks the scheduler ran without this source (slots near max_seq) leave
  the draft behind; `propose()` catches it up by feeding the missed
  history tokens through batched decode steps.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .engine import Engine


class ModelDraftSource:
    """Propose γ tokens per active slot by rolling a small draft engine.

    ``draft``: an `Engine` over the draft model, sharing the target's
    ``n_slots`` and ``max_seq`` (slot ids are reused verbatim), with strip
    caches and greedy sampling."""

    def __init__(self, draft: Engine):
        if draft.sampling.temperature != 0.0:
            raise ValueError("draft engine must sample greedily")
        if draft.pool is not None:
            raise ValueError("draft engine must use strip caches")
        mpe = getattr(draft.cfg, "max_position_embeddings", None)
        if mpe and mpe < draft.ecfg.max_seq:
            raise ValueError(
                f"draft model max_position_embeddings {mpe} < engine max_seq "
                f"{draft.ecfg.max_seq}: drafts past position {mpe} would silently degenerate")
        self.draft = draft
        # which request each draft slot was prefilled for: a slot can be
        # retired AND re-admitted to a new request between two propose()
        # calls, and its stale KV must not be reused for the new request
        self._slot_request: Dict[int, object] = {}

    def propose(self, batcher, gamma: int) -> Optional[np.ndarray]:
        """Drafts [n_slots, γ] for the batcher's active slots, or None to
        fall back to plain decode this tick."""
        target = batcher.engine
        slots: Dict[int, object] = batcher.slot_to_request
        d = self.draft
        if d.ecfg.n_slots != target.ecfg.n_slots:
            raise ValueError("draft n_slots must match the target engine")
        for slot in slots:
            if target.lengths[slot] + gamma + 1 >= min(target.ecfg.max_seq, d.ecfg.max_seq):
                return None  # the verify writes γ+1 rows unconditionally

        # drop slots retired, preempted or reused for another request
        for s in range(d.ecfg.n_slots):
            if d.active[s] and (s not in slots or self._slot_request.get(s) is not slots[s]):
                d.release(s)
                self._slot_request.pop(s, None)

        hists = {}
        for slot, req in slots.items():
            hist = list(req.prompt_ids) + list(req.output_ids)
            hists[slot] = hist
            lt = len(hist) - 1  # target cache rows hold hist[:lt]
            if not d.active[slot]:
                d.prefill(slot, hist[:lt])
                self._slot_request[slot] = req
            elif d.lengths[slot] > lt:
                d.lengths[slot] = lt  # verify-step rollback

        # catch-up: each batched step feeds every behind slot one forced
        # token; synced slots sit inactive (their garbage row lands at their
        # length and is overwritten later)
        while True:
            behind = [s for s in slots if d.lengths[s] < len(hists[s]) - 1]
            if not behind:
                break
            act = np.zeros(d.ecfg.n_slots, bool)
            for s in behind:
                act[s] = True
                d.last_token[s] = hists[s][int(d.lengths[s])]
            d.active = act
            d.decode_step()

        act = np.zeros(d.ecfg.n_slots, bool)
        for s in slots:
            act[s] = True
            d.last_token[s] = hists[s][-1]
        d.active = act

        drafts = np.zeros((target.ecfg.n_slots, gamma), np.int32)
        for j in range(gamma):
            for s, t in d.decode_step().items():
                drafts[s, j] = t
        return drafts
