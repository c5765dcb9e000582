#!/usr/bin/env python3
"""The pair kernel's arms end to end, in one run on one NVIDIA card.

    python3 scripts/torch_pair_arm_ab.py     # from the repository root

The port's pair kernel (`decode_dot pair`, `pb_llm_tpu_torch/ops/
decode_arms.py`) has three arms: "mma" (`mma.sync`, the arm before the
tensor-core code existed), "split" (wgmma with its K loop split over
blocks) below `decode_arms.PAIR_TC` rows and "tc" (wgmma) from there.  This
script serves chip_smoke.py phase 9b's second pass (32-layer random PBW-v2
llama-7b, fuse_linears + decode_dot pair, 8 slots, 16 requests, graphed
decode step) on fresh engines with the arm rule set in turns to

  * every linear on "mma" (the rule before this arm existed),
  * the port's PAIR_TC: decode's 8 slots on "split", prefill windows from
    PAIR_TC rows on "tc",
  * PAIR_TC = 1: decode on "tc" too (no K split),

and prints for each the tokens/s, the decode step's median wall ms, one
graph replay's device ms (CUDA events), the summed synchronised wall ms of
the prefill forwards and the pair launches by arm.  Each line is one JSON
object with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PASSES = ("mma", "port", 1, "port", "mma", 1)  # in turns: each setting twice


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_pair_arm_ab: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pb_llm_tpu_torch.data.synthetic import random_packed_llama
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.ops import decode_arms as da
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    card = cs.setup()
    cfg = cs.llama7b(32)
    params = random_packed_llama(cfg, torch.Generator(device="cuda").manual_seed(5))
    pair_tc, pair_arm = da.PAIR_TC, da.pair_arm
    try:
        for setting in PASSES:
            if setting == "mma":
                da.pair_arm = lambda m, p: "mma"
            else:
                da.pair_arm, da.PAIR_TC = pair_arm, pair_tc if setting == "port" else setting
            eng = Engine(params, cfg, family_for("llama"),
                         EngineConfig(n_slots=8, max_seq=2048, fuse_linears=True,
                                      kernels=KernelConfig(decode_dot="pair")), device="cuda")
            batcher, launches, _, step_ms, _, prefill_ms = cs.run_counted(
                eng, cs.e2e_requests(cfg.vocab_size))
            print(json.dumps({
                "pair_rule": "every linear on mma" if setting == "mma"
                else f"PAIR_TC={da.PAIR_TC}",
                "tokens_per_s": batcher.stats.tokens_per_second,
                "wall_s": batcher.stats.wall_seconds,
                "ms_per_decode_step_median": statistics.median(step_ms),
                "graph_replay_device_ms": cs.replay_ms(eng),
                "prefill_ms_total": sum(prefill_ms),
                "pair_launches": {k: launches[k] for k in
                                  ("pb_pair_v2", "pb_pair_v2_split", "pb_pair_v2_tc")},
                "card": card}), flush=True)
            del eng, batcher
            torch.cuda.empty_cache()
    finally:
        da.PAIR_TC, da.pair_arm = pair_tc, pair_arm
    return 0


if __name__ == "__main__":
    sys.exit(main())
