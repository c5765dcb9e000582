"""What decides `correct`: the served tokens of a sample of finished
requests against the plain reference, and the run's own bookkeeping.

The reference (`benchmark/reference`) runs at the precision the
configuration states.  At every served position of the sample it reads the
gap by which the served token's logit lies below its best logit (0 where
the port picked the reference's token).  Of these gaps:

  max_logit_gap     the widest
  mean_logit_gap    the mean over every served token of the sample
  flip_share        the share of served tokens that are not the
                    reference's first choice

A cell's `benchmark/checks/<cell>.json` names which of them are compared,
each with its limit and the readings it was set from; the others are
printed beside them.  Always compared, with the limit 0:

  unfinished        requests owed an answer (an open loop's requests due in
                    the window) that had none at the end of the drain
  stream_mismatch   finished requests whose streamed tokens differ from the
                    loop's final output or have the wrong count
  loop_errors       1 if the serving loop died

The sample: the finished request with the most tokens, and others drawn
from the seed, ``sample_requests`` in all.

A control (`reference.controls`: one stated precision a step lower) is put
in the program's place by ``run(..., control=<name>)``: its gaps (those of
the tokens it puts first, at the positions of the same prompts and served
tokens) are judged in place of the served tokens'.  Each control has to
come out not correct (`tools/readings.py` reads them on the card, the CPU
tests at a tiny size).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import reference
from ..weights import derive_seed


def sample(session, n: int) -> list:
    done = [r for r in session.records if r.done]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.tokens), -r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(derive_seed(session.seed, "sample"))
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[int(i)] for i in sorted(pick)]


def bookkeeping(session, owed: list) -> Dict[str, int]:
    mismatch = 0
    for r in session.records:
        if not r.done:
            continue
        want = min(r.max_new, session.max_seq - len(r.prompt))
        if r.tokens != list(r.request.output_ids) or len(r.tokens) != want:
            mismatch += 1
    return {"unfinished": sum(not r.done for r in owed), "stream_mismatch": mismatch,
            "loop_errors": int(session.failed() is not None)}


GAPS = ("max_logit_gap", "mean_logit_gap", "flip_share")


def gap_numbers(gaps) -> Dict[str, float]:
    g = np.concatenate([np.asarray(x, np.float64) for x in gaps]) if gaps else np.zeros(0)
    if not g.size or np.isnan(g).any():
        return {k: float("nan") for k in GAPS}
    return {"max_logit_gap": float(g.max()), "mean_logit_gap": float(g.mean()),
            "flip_share": float((g > 0).mean())}


def judge(cell, gaps, book: Dict[str, int]) -> Tuple[bool, Dict[str, dict], dict]:
    """The verdict on one arm's gaps (a list per sampled request; empty for
    no sample) and the run's bookkeeping: (correct, {number compared:
    {"value", "limit"}}, the gap numbers not compared)."""
    nums = gap_numbers(gaps)
    compared = [k for k in GAPS if k in cell.limits]
    numbers = {k: {"value": nums[k], "limit": cell.limits[k]["limit"]} for k in compared}
    numbers.update({k: {"value": v, "limit": 0} for k, v in book.items()})
    ok = bool(len(gaps)) and bool(compared) and all(
        v["value"] == v["value"] and v["value"] <= v["limit"] for v in numbers.values())
    return ok, numbers, {k: nums[k] for k in GAPS if k not in compared}


def run(cell, session, owed: list, device,
        control: Optional[str] = None) -> Tuple[bool, Dict[str, dict], dict]:
    """(correct, {number compared: {"value", "limit"}}, what else was read);
    with ``control`` that control judged in the program's place."""
    picked = sample(session, int(cell.limits.get("sample_requests", 8)))
    info = {"sample_requests": len(picked), "sample_tokens": sum(len(r.tokens) for r in picked)}
    gaps = []
    if picked:
        arms = (reference.controls(cell.config)[control],) if control else ()
        gaps, picks = reference.forward_gaps(cell.config, session.seed, device,
                                             [(r.prompt, r.tokens) for r in picked], arms)
        gaps = picks[0] if control else gaps
    if control:
        info["judged"] = f"control {control}"
    ok, numbers, rest = judge(cell, gaps, bookkeeping(session, owed))
    info.update(rest)
    return ok, numbers, info


def lines(numbers: Dict[str, dict], info: dict) -> List[str]:
    out = [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in numbers.items()]
    out.append("check also read: " + ", ".join(f"{k} {v}" for k, v in info.items()))
    return out
