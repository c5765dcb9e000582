#!/usr/bin/env python3
"""The int8 packed matmul's two arms end to end, in one run on one NVIDIA card.

    python3 scripts/torch_int8_arm_ab.py     # from the repository root

The port's int8 matmul (`pb_llm_tpu_torch/csrc/pb_int8_matmul.cu`) runs on
`__dp4a` below `packed_matmul.M_TC` rows of x and on the int8 tensor cores
from there.  This script serves chip_smoke.py phase 4's model and request
mix (32-layer random PBW-v2 llama-7b, 8 slots, 16 requests, graphed decode
step) on fresh engines with M_TC set in turns to

  * a value no forward reaches: every linear on dp4a (the arm rule before
    the tensor-core arm existed),
  * 16: prefill, chunks and verify windows on the tensor cores, decode's 8
    slots on dp4a (the port's setting),
  * 8: decode on the tensor cores too,

and prints for each the tokens/s, the decode step's median wall ms, one
graph replay's device ms (CUDA events) and the summed synchronised wall ms
of the prefill forwards.  It first prints the host's wall µs for one call of
each arm's launch and x preparation (no synchronisation between calls).
Each line is one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ALL_DP4A = 1 << 30
PASSES = (ALL_DP4A, 16, 8, 16, ALL_DP4A, 8)  # in turns: each setting twice


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
            ops = pm.prepare_int8(x, p, arm)
            print(json.dumps({"m": m, "ic": 4096, "oc": 11008, "arm": arm,
                              "launch_host_us": host_us(lambda: pm.launch_int8(ops, p)),
                              "prep_host_us": host_us(lambda: pm.prepare_int8(x, p, arm)),
                              "card": card}), flush=True)
    del p, x, ops
    cfg = cs.llama7b(32)
    params = random_packed_llama(cfg, torch.Generator(device="cuda").manual_seed(5))
    m_tc = pm.M_TC
    try:
        for setting in PASSES:
            pm.M_TC = setting
            eng = Engine(params, cfg, family_for("llama"), EngineConfig(n_slots=8, max_seq=2048),
                         device="cuda")
            batcher, launches, _, step_ms, _, prefill_ms = cs.run_counted(
                eng, cs.e2e_requests(cfg.vocab_size))
            print(json.dumps({
                "M_TC": "none" if setting == ALL_DP4A else setting,
                "tokens_per_s": batcher.stats.tokens_per_second,
                "wall_s": batcher.stats.wall_seconds,
                "ms_per_decode_step_median": statistics.median(step_ms),
                "graph_replay_device_ms": cs.replay_ms(eng),
                "prefill_ms_total": sum(prefill_ms),
                "int8_launches": {k: launches[k] for k in ("pb_int8_matmul", "pb_int8_matmul_tc")},
                "card": card}), flush=True)
            del eng, batcher
            torch.cuda.empty_cache()
    finally:
        pm.M_TC = m_tc
    return 0


if __name__ == "__main__":
    sys.exit(main())
