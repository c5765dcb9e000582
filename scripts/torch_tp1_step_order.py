#!/usr/bin/env python3
"""The decode step of `TPEngine(tp=1)` over a 1-rank NCCL group against the
plain `Engine`'s, both graphed, in one run on one NVIDIA card.

    python3 scripts/torch_tp1_step_order.py   # from the repository root

chip_smoke.py phase 15b serves phase 4's model and 16 requests (32-layer
random PBW-v2 llama-7b, 8 slots) on the plain engine, then on the TP
engine, and reads the TP step slower.  This script serves the same mix in
the order engine, tp, tp, engine on fresh engines in one process (the group
initialised throughout), and prints for each pass the median ms a decode
step, the prefill forwards' summed ms, tokens/s, the mean ms of five steps
of the full pool (8 slots of 100 tokens), and the host (CPU) time by op
over five more steps (`torch.profiler`); then, for each TP pass against the
engine pass beside it in the order, the ops whose host ms a step differ
most.  Each line is one JSON object (with the card's name and power limit
in the pass lines).
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from pb_llm_tpu_torch.data.synthetic import random_packed_llama
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.parallel import mesh as pmesh
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig
    from pb_llm_tpu_torch.runtime.tp_engine import TPEngine

    if not torch.cuda.is_available():
        print("torch_tp1_step_order: CUDA is not available", file=sys.stderr)
        return 1
    card = cs.setup()
    cfg = cs.llama7b(32)
    params = random_packed_llama(cfg, torch.Generator(device=cs.DEV).manual_seed(5))
    pmesh.multihost_initialize(pmesh.free_address(), 1, 0, device=cs.DEV)
    mesh = pmesh.make_mesh(dp=1, tp=1)
    cpu = {}
    for i, name in enumerate(("engine", "tp", "tp", "engine")):
        ecfg = EngineConfig(n_slots=8, max_seq=2048)
        eng = (Engine(params, cfg, family_for("llama"), ecfg, device=cs.DEV) if name == "engine"
               else TPEngine(params, cfg, family_for("llama"), ecfg, mesh, device=cs.DEV))
        reqs = cs.e2e_requests(cfg.vocab_size)
        batcher, launches, fwds, step_ms, _, prefill_ms = cs.run_counted(eng, reqs)
        for slot in range(8):
            eng.prefill(slot, list(range(1, 101)))
        for _ in range(3):
            eng.decode_step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            eng.decode_step()
        torch.cuda.synchronize()
        full_ms = (time.perf_counter() - t) * 1e3 / 5
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(5):
                eng.decode_step()
            torch.cuda.synchronize()
        by = {e.key: (e.self_cpu_time_total / 5e3, e.count / 5) for e in prof.key_averages()}
        cpu[i] = by
        top = sorted(by.items(), key=lambda kv: -kv[1][0])[:12]
        print(json.dumps({"phase": "gap15b", "pass": i, "engine": name,
                          "ms_per_decode_step_median": statistics.median(step_ms),
                          "prefill_ms_total": sum(prefill_ms),
                          "tokens_per_s": batcher.stats.tokens_per_second,
                          "full_pool_step_ms": full_ms, "replays": eng._step.replays,
                          "cpu_top": [[k[:60], round(ms, 4), c] for k, (ms, c) in top],
                          "card": card}), flush=True)
        for slot in range(8):
            eng.release(slot)
        del eng
        torch.cuda.empty_cache()
    for a, b in ((1, 0), (2, 3)):
        keys = set(cpu[a]) | set(cpu[b])
        d = {k: cpu[a].get(k, (0, 0))[0] - cpu[b].get(k, (0, 0))[0] for k in keys}
        print(json.dumps({"phase": "gap15b_cpu_diff", "tp_pass": a, "engine_pass": b,
                          "largest": [[k[:60], round(v, 4)] for k, v in
                                      sorted(d.items(), key=lambda kv: -abs(kv[1]))[:10]]}),
              flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
