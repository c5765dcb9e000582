#!/usr/bin/env python3
"""The dma decode arm and the PBW-v1 planar kernel by arm, end to end, in one
run on one NVIDIA card.

    python3 scripts/torch_v1_dma_arm_ab.py            # from the repository root
    python3 scripts/torch_v1_dma_arm_ab.py --profile  # also trace each arm's step

Two passes of chip_smoke.py, each served on fresh engines with the kernel's
arm rule in turns (new arm, "cores", "cores", new arm):

  * phase 9b's dma pass: the 32-layer random PBW-v2 llama-7b, decode_dot
    "dma", 8 slots, int8 strips, phase 4's 16 requests; the dma kernel on
    `decode_arms.DMA_ARM` "split" (bf16 tensor cores) or "cores";
  * phase 7b: the 24-layer random PBW-v1 OPT-1.3B, the same engine and
    mix; the planar kernel on `packed_matmul_v1.PLANAR_ARM` "tc" (bf16
    tensor cores) or "cores".

For each pass it prints the tokens/s, the decode step's median wall ms, one
graph replay's device ms (CUDA events) at the last step's inputs and its
idle share of the step (1 - replay / step), the median, mean and deciles
of the device ms of the replays that served the mix (CUDA events around
each) and their idle share (1 - median replay / median step), the summed synchronised wall ms of the prefill forwards,
the arm's launches (the other arm must show none) and whether the greedy
streams equal the first pass's.  A pass on the same arm must give the first
pass's streams.  The two arms sum in other orders, so their streams may
part; where a request's streams first part, each arm's logits at that token
are re-scored on the shared prefix (a fresh engine, the prompt prefilled
into slot 0, the shared tokens teacher-forced through its graphed decode
step), once in the served config (int8 strips) and once with an f32 KV
cache, and printed with each arm's top-2 gap over max|logit| (and whether
it lies within chip_smoke.py's near-tie MARGIN) and the two arms' logit
difference over max|logit|.  The int8 strips round k and v per row, so a
last-bit difference can move a whole row's codes, and 24–32 layers carry
that far; with the f32 cache the arms compute the same exact function, and
their logits there must lie within chip_smoke.py's LOGIT_TOL_EXACT of
max|logit|, the exact arms' logit bound.  With
``--profile`` also each arm's device time by kernel over three graphed
steps (chip_smoke.py's `profile_decode`).  Each line is one JSON object
with the card's name and power limit; it exits non-zero if an arm's
launches miss, a pass on the same arm gives other streams, or the arms'
logits at a parting lie beyond that bound with the f32 cache.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TURNS = (0, 1, 1, 0)  # the new arm, "cores", "cores", the new arm


def engine(cs, params, cfg, family: str, kernels, **kw):
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    return Engine(params, cfg, family_for(family), EngineConfig(n_slots=8, max_seq=2048,
                                                                kernels=kernels, **kw),
                  device="cuda")


def rescore(eng, prompt, tokens, k: int) -> torch.Tensor:
    """Slot 0's logits for output token k of a stream starting ``tokens``:
    the prompt prefilled, tokens[:k] teacher-forced through the decode step
    (`Engine.forced_decode_nll`'s order).  A copy: a graphed step's logits
    are the graph's output buffer, which its next replay overwrites."""
    eng.release(0)
    eng.prefill(0, list(prompt))
    logits = eng._prefill_logits[0]
    for j in range(k):
        eng.last_token[0] = int(tokens[j])
        logits = eng._step_logits()[0]
        eng.lengths[0] += 1
    return logits.float().clone()


def pass_name(family: str) -> str:
    return "dma (9b)" if family == "llama" else "OPT-1.3B (7b)"


def partings(cs, params, cfg, family: str, kernels, set_arm, arms, prompts, streams,
             card: str, name: str = None, ekw: dict = None, exact_kernels=None) -> None:
    """Where the two arms' greedy streams first part, each arm's re-scored
    logits there, in the served config and with an f32 KV cache (and, given
    ``exact_kernels``, also with the served cache on those kernels):
    printed, and the arms' difference in every config but the served one
    held to LOGIT_TOL_EXACT.  ``name``, ``ekw`` (engine options) and
    ``exact_kernels`` as in `ab`."""
    apart = [(i, next(j for j, (a, b) in enumerate(zip(s0, s1)) if a != b))
             for i, (s0, s1) in enumerate(zip(streams[arms[0]], streams[arms[1]])) if s0 != s1]
    caches = {"served": ({}, kernels),
              "f32_cache": ({"cache_dtype": torch.float32}, exact_kernels or kernels)}
    if exact_kernels is not None:
        caches["served_cache_exact_arms"] = ({}, exact_kernels)
    logits = {}
    for arm in arms:
        set_arm(arm)
        for c, (kw, kc) in caches.items():
            eng = engine(cs, params, cfg, family, kc, **(ekw or {}), **kw)
            logits[c, arm] = [rescore(eng, prompts[i], streams[arm][i], k) for i, k in apart]
            del eng
            torch.cuda.empty_cache()
    name_of = name or pass_name(family)
    worst = {c: 0.0 for c in caches}
    for n, (i, k) in enumerate(apart):
        row = {"pass": name_of, "parting": i, "token": k,
               "served_tokens": {a: streams[a][i][k] for a in arms}, "card": card}
        for c in caches:
            lg = [logits[c, a][n] for a in arms]
            scale = max(float(t.abs().max()) for t in lg)
            diff = float((lg[0] - lg[1]).abs().max()) / scale
            worst[c] = max(worst[c], diff)
            row[c] = {"arms_logit_diff_over_max": diff}
            for a, t in zip(arms, lg):
                top = torch.topk(t, 2)
                gap = float(top.values[0] - top.values[1]) / scale
                row[c][a] = {"top": int(top.indices[0]), "runner_up": int(top.indices[1]),
                             "top2_gap_over_max": gap, "within_margin": gap <= cs.MARGIN}
        print(json.dumps(row), flush=True)
    print(json.dumps({"pass": name_of, "requests": len(prompts), "parted": len(apart),
                      "max_arms_logit_diff_over_max": worst, "bound_f32_cache": cs.LOGIT_TOL_EXACT,
                      "margin": cs.MARGIN, "card": card}), flush=True)
    for c in caches:
        if c != "served" and worst[c] > cs.LOGIT_TOL_EXACT:
            raise AssertionError(f"{family}: in config {c} the arms' logits differ by "
                                 f"{worst[c]} of max|logit| > {cs.LOGIT_TOL_EXACT}")


def time_replays(eng) -> list:
    """Record every replay of ``eng``'s decode-step graph between CUDA
    events (set before the graph is captured); returns the list that
    collects the (start, end) pairs: each pair spans one served step's
    device time, its inputs as the batcher left them."""
    pairs = []

    class Timed(eng._step.graph_cls):
        def replay(self):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            super().replay()
            e1.record()
            pairs.append((e0, e1))

    eng._step.graph_cls = Timed
    return pairs


def serve(cs, params, cfg, family: str, kernels, arm_counters, arm: str, card: str,
          first_streams, same, profile: bool, name: str = None, ekw: dict = None,
          requests=None) -> list:
    """One pass on a fresh engine; returns its greedy streams (``same``: the
    streams of this arm's earlier pass, or None).  ``name``, ``ekw`` and
    ``requests`` as in `ab`."""
    eng = engine(cs, params, cfg, family, kernels, **(ekw or {}))
    reqs = (requests or cs.e2e_requests)(cfg.vocab_size)
    pairs = time_replays(eng)
    batcher, launches, _, step_ms, _, prefill_ms = cs.run_counted(eng, reqs)
    torch.cuda.synchronize()
    served = [a.elapsed_time(b) for a, b in pairs]  # the warm-up request's replays included
    streams = [r.output_ids for r in reqs]
    step = statistics.median(step_ms)
    replay = cs.replay_ms(eng)
    served_ms = statistics.median(served) if served else "not measured"
    counts = {k: launches[k] for k in arm_counters.values()}
    print(json.dumps({
        "pass": name or pass_name(family), "arm": arm,
        "tokens_per_s": batcher.stats.tokens_per_second, "wall_s": batcher.stats.wall_seconds,
        "ms_per_decode_step_median": step, "graph_replay_device_ms": replay,
        "graph_idle_share": 1 - replay / step, "served_replays": len(served),
        "served_replay_device_ms_median": served_ms,
        "served_replay_device_ms_mean": statistics.fmean(served) if served else "not measured",
        "served_replay_device_ms_deciles": (statistics.quantiles(served, n=10)
                                            if len(served) > 1 else "not measured"),
        "served_idle_share": 1 - served_ms / step if served else "not measured",
        "prefill_ms_total": sum(prefill_ms),
        "launches": counts, "streams_equal_first_pass": first_streams in (None, streams),
        "card": card}), flush=True)
    if same is not None and same != streams:
        raise AssertionError(f"{family} pass on arm {arm}: other streams than its first pass")
    other = [c for a, c in arm_counters.items() if a != arm]
    if counts[arm_counters[arm]] == 0 or any(counts[c] for c in other):
        raise AssertionError(f"{family} pass on arm {arm}: launches {counts}")
    if profile:
        print(json.dumps({"profile_of": f"{family} {arm}"}), flush=True)
        cs.profile_decode(eng, "graph")
    del eng, batcher
    torch.cuda.empty_cache()
    return streams


def ab(cs, params, cfg, family: str, kernels, arms, set_arm, arm_counters, card: str,
       profile: bool, name: str = None, ekw: dict = None, requests=None,
       exact_kernels=None) -> None:
    """One pass's four turns, then where the two arms' streams part.
    ``name`` names the pass in the output (by default after ``family``),
    ``ekw`` adds `EngineConfig` options, ``requests(vocab)`` makes the mix
    (by default phase 4's, `chip_smoke.e2e_requests`), ``exact_kernels``
    replaces ``kernels`` in the f32-cache re-score and adds a re-score of
    the served cache on them (the exact matmul arms, where the pass serves
    on the int8 ones: their per-row rounding of x carries a last-bit
    difference in attention into the logits, so only on the exact arms are
    the two arms held to one bound)."""
    first, streams = None, {}
    for t in TURNS:
        arm = arms[t]
        set_arm(arm)
        got = serve(cs, params, cfg, family, kernels, arm_counters, arm, card, first,
                    streams.get(arm), profile and arm not in streams, name, ekw, requests)
        streams.setdefault(arm, got)
        first = got if first is None else first
    prompts = [r.prompt_ids for r in (requests or cs.e2e_requests)(cfg.vocab_size)]
    partings(cs, params, cfg, family, kernels, set_arm, arms, prompts, streams, card, name, ekw,
             exact_kernels)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true", help="trace each arm's decode step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_v1_dma_arm_ab: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pb_llm_tpu_torch.data.synthetic import random_packed_llama, random_packed_opt
    from pb_llm_tpu_torch.ops import decode_arms as da
    from pb_llm_tpu_torch.ops import packed_matmul_v1 as v1
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig

    card = cs.setup()
    saved = da.DMA_ARM, v1.PLANAR_ARM
    try:
        cfg = cs.llama7b(32)
        params = random_packed_llama(cfg, torch.Generator(device="cuda").manual_seed(5))
        ab(cs, params, cfg, "llama", KernelConfig(decode_dot="dma"), ("split", "cores"),
           lambda a: setattr(da, "DMA_ARM", a),
           {"split": "pb_dma_v2_split", "cores": "pb_dma_v2"}, card, args.profile)
        da.DMA_ARM = saved[0]
        del params
        torch.cuda.empty_cache()
        cfg = cs.opt13b(24)
        params = random_packed_opt(cfg, torch.Generator(device="cuda").manual_seed(18))
        ab(cs, params, cfg, "opt", None, ("tc", "cores"), lambda a: setattr(v1, "PLANAR_ARM", a),
           {"tc": "pb_planar_v1_tc", "cores": "pb_planar_v1"}, card, args.profile)
    finally:
        da.DMA_ARM, v1.PLANAR_ARM = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
