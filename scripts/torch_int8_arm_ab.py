#!/usr/bin/env python3
"""The int8 packed matmul's arms end to end, in one run on one NVIDIA card.

    python3 scripts/torch_int8_arm_ab.py            # from the repository root
    python3 scripts/torch_int8_arm_ab.py --profile  # also trace each setting's step

The port's int8 matmul (`pb_llm_tpu_torch/csrc/pb_int8_matmul.cu`) runs
below `packed_matmul.M_TC` rows of x on `packed_matmul.DECODE_ARM` ("split":
the int8 tensor cores with a K split over a cluster of blocks; or "dp4a":
the CUDA cores) and on the int8 tensor cores ("tc") from there.  This
script serves chip_smoke.py phase 4's model and request mix (32-layer
random PBW-v2 llama-7b, 8 slots, 16 requests, graphed decode step) on fresh
engines with the decode step's 8 rows in turns on

  * "dp4a": DECODE_ARM "dp4a" (the rule before the split arm existed),
  * "split": DECODE_ARM "split" (the port's setting),
  * "tc": M_TC = 8, decode on the prefill tensor-core arm,

(prefill, at 16 rows and more, on "tc" in every pass) and prints for each
the tokens/s, the decode step's median wall ms, one graph replay's device
ms (CUDA events), the idle share of the step (1 - replay / step) and the
summed synchronised wall ms of the prefill forwards.  The arms sum the same
integers, so every pass must give the same greedy tokens: it exits non-zero
if a pass's streams differ from the first's.  With ``--profile``
also each setting's device time by kernel over three graphed steps
(chip_smoke.py's `profile_decode`).  It first prints the host's wall µs for
one call of each arm's launch and x preparation (no synchronisation between
calls).  Each line is one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SETTINGS = {"dp4a": (16, "dp4a"), "split": (16, "split"), "tc": (8, "split")}  # M_TC, DECODE_ARM
PASSES = ("dp4a", "split", "tc", "split", "dp4a", "tc")  # in turns: each setting twice


def host_us(fn, n: int = 200) -> float:
    """Host wall µs a call, the calls queued back to back."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t) / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true", help="trace each setting's decode step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_int8_arm_ab: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pb_llm_tpu_torch.data.synthetic import random_packed_llama, random_packed_v2
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.ops import packed_matmul as pm
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    card = cs.setup()
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = random_packed_v2(4096, 11008, gen, low_frac=0.9)
    for m in (8, 512):
        x = torch.randn((m, 4096), generator=gen, device="cuda")
        for arm in pm.ARMS:
            if arm == "split" and m > pm.SPLIT_MAX_M:
                continue
            ops = pm.prepare_int8(x, p, pm.layout_of(arm))
            print(json.dumps({"m": m, "ic": 4096, "oc": 11008, "arm": arm,
                              "launch_host_us": host_us(lambda: pm.launch_int8(ops, p, arm)),
                              "prep_host_us": host_us(
                                  lambda: pm.prepare_int8(x, p, pm.layout_of(arm))),
                              "card": card}), flush=True)
    del p, x, ops
    cfg = cs.llama7b(32)
    params = random_packed_llama(cfg, torch.Generator(device="cuda").manual_seed(5))
    saved = pm.M_TC, pm.DECODE_ARM
    profiled = set()
    streams = None
    try:
        for name in PASSES:
            pm.M_TC, pm.DECODE_ARM = SETTINGS[name]
            eng = Engine(params, cfg, family_for("llama"), EngineConfig(n_slots=8, max_seq=2048),
                         device="cuda")
            reqs = cs.e2e_requests(cfg.vocab_size)
            batcher, launches, _, step_ms, _, prefill_ms = cs.run_counted(eng, reqs)
            got = [r.output_ids for r in reqs]
            streams = got if streams is None else streams
            step = statistics.median(step_ms)
            replay = cs.replay_ms(eng)
            print(json.dumps({
                "decode_arm": name, "M_TC": pm.M_TC, "DECODE_ARM": pm.DECODE_ARM,
                "tokens_per_s": batcher.stats.tokens_per_second,
                "wall_s": batcher.stats.wall_seconds, "ms_per_decode_step_median": step,
                "graph_replay_device_ms": replay, "graph_idle_share": 1 - replay / step,
                "prefill_ms_total": sum(prefill_ms),
                "int8_launches": {k: launches[k] for k in cs.INT8_COUNTERS.values()},
                "streams_equal_first_pass": got == streams, "card": card}), flush=True)
            if got != streams:
                print(f"torch_int8_arm_ab: {name}'s greedy streams differ from the first pass's",
                      file=sys.stderr)
                return 1
            if args.profile and name not in profiled:
                profiled.add(name)
                print(json.dumps({"profile_of": name}), flush=True)
                cs.profile_decode(eng, "graph")
            del eng, batcher
            torch.cuda.empty_cache()
    finally:
        pm.M_TC, pm.DECODE_ARM = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
