#!/usr/bin/env python3
"""Paged decode attention and the exact f32 matmul's decode rows by arm, end
to end, in one run on one NVIDIA card.

    python3 scripts/torch_paged_f32_arm_ab.py            # from the repository root
    python3 scripts/torch_paged_f32_arm_ab.py --profile  # also trace each arm's step

Two passes, each served on fresh engines with the kernel's arm rule in
turns (new arm, old arm, old arm, new arm), by `torch_v1_dma_arm_ab.ab`:

  * phase 6b's pass i: the 32-layer random PBW-v2 llama-7b behind
    `EngineConfig(n_slots=8, max_seq=2048, page_size=16, prefix_cache=True,
    prefill_chunk=256)` (int8 pages, spec_gamma 0), phase 6b's 16 requests;
    paged decode on `paged_attention.DECODE_ARM` "split" or "cuda_cores";
  * the exact arms on scanned layers: the same model with `scan_layers`,
    decode_dot "f32" and the hybrid prefill, int8 strips, phase 4's 16
    requests; the stacked exact f32 kernel's decode rows on
    `packed_matmul.F32_DECODE_ARM` "split" (the dma kernel's device code)
    or "cores".

Each turn prints the tokens/s, the decode step's median wall ms, one graph
replay's device ms at the last step's inputs and its idle share (1 -
replay / step), the median and mean device ms of the replays that served
the mix and their idle share (`torch_v1_dma_arm_ab.time_replays`), the
prefill forwards' wall ms, the arm's launches (the other arm must show none) and
whether the greedy streams equal the first turn's; a turn on the same arm
must repeat its first turn's streams.  Where the two arms' streams part,
each arm's logits there are re-scored in the served config, and on the
exact matmul arms (decode_dot f32, hybrid prefill) both with the served
int8 pages and with an f32 KV cache; on the exact arms they must lie
within chip_smoke.py's LOGIT_TOL_EXACT of max|logit|
(`torch_v1_dma_arm_ab.partings`).  The paged pass serves on the int8
matmul arms, whose per-row rounding of x carries a last-bit difference in
attention through 32 layers, as the int8 strips do (PERF.md §6).  Every
line is one JSON object with the card's name and power limit; it exits
non-zero where a check fails.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true", help="trace each arm's decode step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_paged_f32_arm_ab: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torch_v1_dma_arm_ab import ab
    from pb_llm_tpu_torch.data.synthetic import random_packed_llama
    from pb_llm_tpu_torch.ops import packed_matmul as pm
    from pb_llm_tpu_torch.ops import paged_attention as tpa
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig

    card = cs.setup()
    exact = KernelConfig(decode_dot="f32", prefill="hybrid")  # the exact matmul arms
    saved = tpa.DECODE_ARM, pm.F32_DECODE_ARM
    try:
        cfg = cs.llama7b(32)
        params = random_packed_llama(cfg, torch.Generator(device="cuda").manual_seed(5))
        ab(cs, params, cfg, "llama", None, (tpa.SPLIT, tpa.CUDA_CORES),
           lambda a: setattr(tpa, "DECODE_ARM", a),
           {tpa.SPLIT: "paged_attention_split", tpa.CUDA_CORES: "paged_attention_cuda_cores"},
           card, args.profile, name="paged decode (6b pass i)",
           ekw=dict(page_size=16, prefix_cache=True, prefill_chunk=256),
           requests=cs.paged_requests, exact_kernels=exact)
        tpa.DECODE_ARM = saved[0]
        ab(cs, params, cfg, "llama", exact,
           ("split", "cores"), lambda a: setattr(pm, "F32_DECODE_ARM", a),
           {"split": "pb_f32_matmul_stacked_split", "cores": "pb_f32_matmul_stacked"},
           card, args.profile, name="exact arms, scan_layers", ekw=dict(scan_layers=True))
    finally:
        tpa.DECODE_ARM, pm.F32_DECODE_ARM = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
