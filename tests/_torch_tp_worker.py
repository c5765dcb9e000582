"""The rank side of the tensor-parallel tests (`tests/test_torch_tp_engine.py`):
scenario plans, played alike by the JAX package's engines in the test
process and by the port's `TPEngine` on every gloo rank.  This module
imports the port, torch and numpy only: the rank processes import no JAX.

A plan is plain data:

  {"kind": "steps", "prefills": [(slot, prompt), ...], "steps": n}
      prefill each slot, then n decode steps; the slots are released after;
  {"kind": "batcher", "requests": [(prompt, max_new, sampling), ...]}
      one `ContinuousBatcher.run` (sampling: None or SamplingParams kwargs);
  {"kind": "spec", "prompt": [...], "n": n, "gamma": g}
      prefill slot 0, then speculative steps with all-zero drafts until n
      tokens (JAX's tests/test_spec_decode.py::test_spec_tp_matches_single_device).
"""

from __future__ import annotations

import numpy as np
import torch


def play(eng, plan, batching, sampler) -> dict:
    """Run ``plan`` on ``eng`` (either package's engine, with that package's
    `runtime.batching` and `runtime.sampler` modules)."""
    kind = plan["kind"]
    if kind == "steps":
        out = {s: [eng.prefill(s, list(p))] for s, p in plan["prefills"]}
        for _ in range(plan["steps"]):
            for s, t in eng.decode_step().items():
                out[s].append(int(t))
        for s in out:
            eng.release(s)
        return {"streams": [out[s] for s, _ in plan["prefills"]]}
    if kind == "batcher":
        reqs = [batching.Request(request_id=i, prompt_ids=list(p), max_new_tokens=n,
                                 sampling=None if sp is None else sampler.SamplingParams(**sp))
                for i, (p, n, sp) in enumerate(plan["requests"])]
        b = batching.ContinuousBatcher(eng)
        b.run(reqs)
        pool = eng.pool
        return {"streams": [[int(t) for t in r.output_ids] for r in reqs],
                "done": all(r.done for r in reqs), "prefills": b.stats.prefills,
                "spec_drafted": b.stats.spec_drafted,
                "prefix_hit_pages": None if pool is None else pool.prefix_hit_pages,
                "pages_free": None if pool is None else pool.free_pages == pool.n_pages}
    if kind == "spec":
        got = [eng.prefill(0, list(plan["prompt"]))]
        while len(got) < plan["n"]:
            got.extend(int(t) for t in eng.spec_decode_step(
                np.zeros((eng.ecfg.n_slots, plan["gamma"]), np.int32))[0])
        eng.release(0)
        return {"streams": [got[: plan["n"]]]}
    raise ValueError(kind)


def _kernels(kw):
    from pb_llm_tpu_torch.ops.kernel_config import KernelConfig

    return None if kw is None else KernelConfig(**kw)


def _cache_shapes(caches):
    if isinstance(caches, dict):
        return {k: tuple(v.shape) for k, v in caches.items()}
    return [{k: tuple(v.shape) for k, v in c.items()} for c in caches]


def run_scenarios(rank: int, trees: dict, scenarios: list, layers: dict) -> dict:
    """Every scenario on this rank's `TPEngine` (engines shared by the
    scenarios that name the same model and engine config; ``trees``: name →
    (params, config, family name)), then the collectives on ``layers``.
    Returns {name: result}."""
    torch.set_num_threads(1)
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.parallel import collectives, mesh as pmesh
    from pb_llm_tpu_torch.runtime import batching, sampler
    from pb_llm_tpu_torch.runtime.engine import EngineConfig
    from pb_llm_tpu_torch.runtime.tp_engine import TPEngine, _cache_specs_like

    mesh = pmesh.make_mesh(dp=1)
    out, engines = {}, {}
    for sc in scenarios:
        key = (sc["model"], repr(sc["ecfg"]), repr(sc.get("kernels")))
        if key not in engines:
            params, cfg, fam = trees[sc["model"]]
            ecfg = EngineConfig(**sc["ecfg"], kernels=_kernels(sc.get("kernels")))
            engines[key] = TPEngine(params, cfg, family_for(fam), ecfg, mesh, device="cpu")
        eng = engines[key]
        res = play(eng, sc["plan"], batching, sampler)
        res["cache_shapes"] = _cache_shapes(eng.caches)
        res["cache_specs"] = _cache_specs_like(eng.caches)
        out[sc["name"]] = res
    for name, (x, p, kind) in layers.items():
        x = torch.from_numpy(x)
        if kind == "col":
            out[name] = {"local": collectives.column_parallel_pb_matmul(x, p, mesh).numpy(),
                         "gathered": collectives.column_parallel_pb_matmul(
                             x, p, mesh, gather=True).numpy()}
        else:
            out[name] = {"y": collectives.row_parallel_pb_matmul(x, p, mesh).numpy()}
    return out
