"""Plans of `MultiHostBatcher` runs, played alike by the JAX package in the
test process and by the port in one process or on every rank of a gloo
world (`tests/test_torch_multihost.py`), and the rank side of `serve --http
--tp 2` (`tests/test_torch_server.py`).  This module imports the port,
torch and numpy only: the rank processes import no JAX.

A plan is plain data: {"model": name, "ecfg": EngineConfig kwargs,
"draft": None or a model name, "max_prompt": n, "requests": [{"prompt":
[...], "max_new": n, "eos": id or None, "stops": [...] or None,
"sampling": None or SamplingParams kwargs}, ...]}.
"""

from __future__ import annotations

import json

import numpy as np
import torch


def play(mods, make_engine, plan) -> dict:
    """Run ``plan`` through ``mods``' MultiHostBatcher (``mods``: the
    package's (batching, multihost_batching, sampler, draft) modules;
    ``make_engine(model, ecfg)`` builds that package's engine).  Returns the
    streams of every request this process saw retire (rank 0's rich
    requests or a rank's shadows), the stats, the engine lengths and the
    sampling each admission installed."""
    batching, mhb, sampler, draft = mods

    class Capturing(mhb.MultiHostBatcher):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.seen = {}

        def _maybe_retire(self, slot, token, **kw):
            req = self.slot_to_request[slot]
            self.seen[req.request_id] = req
            super()._maybe_retire(slot, token, **kw)

    eng = make_engine(plan["model"], plan["ecfg"])
    installed = []
    set_sampling = eng.set_slot_sampling

    def record(slot, sp):
        installed.append(None if sp is None else [sp.temperature, sp.top_k, sp.top_p])
        set_sampling(slot, sp)

    eng.set_slot_sampling = record
    source = None
    if plan.get("draft"):
        source = draft.ModelDraftSource(make_engine(plan["draft"], {
            k: plan["ecfg"][k] for k in ("n_slots", "max_seq", "prefill_buckets")}))
    b = Capturing(eng, max_prompt=plan["max_prompt"], draft_source=source)
    reqs = [batching.Request(
        request_id=i, prompt_ids=list(r["prompt"]), max_new_tokens=r["max_new"],
        eos_token_id=r.get("eos"), stop_token_ids=r.get("stops"),
        sampling=None if r.get("sampling") is None else sampler.SamplingParams(**r["sampling"]))
        for i, r in enumerate(plan["requests"])]
    try:
        b.run(reqs)
    except ValueError as e:
        return {"raises": type(e).__name__}
    s = b.stats
    return {"streams": {str(k): [int(t) for t in r.output_ids] for k, r in sorted(b.seen.items())},
            "stats": [s.prefills, s.decode_steps, s.generated_tokens, s.spec_drafted,
                      s.spec_accepted, s.preemptions],
            "lengths": [int(x) for x in np.asarray(eng.lengths)], "installed": installed}


def port_mods():
    from pb_llm_tpu_torch.runtime import batching, draft, multihost_batching, sampler

    return batching, multihost_batching, sampler, draft


def port_engine_maker(trees: dict):
    """``make_engine`` over the port's trees (name → (params, cfg, family))."""
    from pb_llm_tpu_torch.models.registry import family_for
    from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig

    def make(model, ecfg):
        params, cfg, fam = trees[model]
        return Engine(params, cfg, family_for(fam), EngineConfig(**ecfg, cache_dtype=torch.float32),
                      device="cpu", seed=0)

    return make


def run_plans(rank: int, trees: dict, plans: dict) -> dict:
    """Every plan on this rank: {name: json of `play`'s result}, as bytes
    the test compares across ranks."""
    torch.set_num_threads(1)
    make = port_engine_maker(trees)
    return {name: json.dumps(play(port_mods(), make, plan), sort_keys=True)
            for name, plan in plans.items()}


# ---------------------------------------------------------------------------
# serve --http 0 --tp 2 (the CLI's own rank function, driven over HTTP)
# ---------------------------------------------------------------------------


def http_rank(rank: int, argv: list, payloads: list, idle_s: float, late: dict,
              refused: list) -> dict:
    """One rank of ``serve --tp 2`` (``argv``), then of ``serve --http 0
    --tp 2`` in the same world: `cli.serve._serve_rank` both times, the
    second with rank 0's wait for an interrupt replaced by a client that
    posts ``refused`` one by one (requests the admission record cannot
    carry), then ``payloads`` concurrently, idles ``idle_s`` seconds, posts
    ``late``, reads /stats, then returns (the CLI then shuts the server
    down, and its stop word ends every rank).  Returns rank 0's printout of
    the first run and answers of the second (a refused request's is its
    HTTP status and error), and each run's exit code."""
    import concurrent.futures
    import contextlib
    import io
    import urllib.error
    import urllib.request

    from pb_llm_tpu_torch.cli import serve

    torch.set_num_threads(1)
    seen: dict = {}

    def post(port, payload):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                     data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                body = r.read().decode()
        except urllib.error.HTTPError as e:
            return {"status": e.code, **json.loads(e.read())}
        if payload.get("stream"):
            lines = [json.loads(x) for x in body.splitlines() if x.strip()]
            return {"tokens": [x["token"] for x in lines[:-1]], **lines[-1]}
        return json.loads(body)

    def drive(server):
        import time

        port = server.server_address[1]
        seen["refused"] = [post(port, p) for p in refused]
        with concurrent.futures.ThreadPoolExecutor(len(payloads)) as ex:
            seen["answers"] = list(ex.map(lambda p: post(port, p), payloads))
        time.sleep(idle_s)
        seen["late"] = post(port, late)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
            seen["stats"] = json.loads(r.read())

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        seen["rc_batch"] = serve._serve_rank(rank, serve.build_parser().parse_args(argv), "cpu")
    seen["batch"] = buf.getvalue()
    serve._until_interrupted = drive
    args = serve.build_parser().parse_args(argv + ["--http", "0", "--host", "127.0.0.1"])
    seen["rc"] = serve._serve_rank(rank, args, "cpu")
    return seen
