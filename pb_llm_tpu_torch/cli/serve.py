"""Serving CLI (port of `pb_llm_tpu/cli/serve.py`): runs a batch of prompts
through the continuous batcher and reports tokens/s, or serves POST
/generate over HTTP (`runtime.server`) with ``--http PORT``.

    python -m pb_llm_tpu_torch.cli.serve --model_id llama --synthetic --demo
    python -m pb_llm_tpu_torch.cli.serve --model_id llama --synthetic --demo \
        --page_size 8 --prefix_cache --prefill_chunk 16 --spec_gamma 3
    python -m pb_llm_tpu_torch.cli.serve --model_id facebook/opt-synth --synthetic \
        --pbw checkpoints/opt_pbw

    python -m pb_llm_tpu_torch.cli.serve --model_id llama --synthetic \
        --pbw checkpoints/llama_pbw --scan_layers --fuse_linears --decode_dot pair
    python -m pb_llm_tpu_torch.cli.serve --model_id llama --synthetic \
        --kv_dtype bf16 --http 8000 --host 127.0.0.1

    python -m pb_llm_tpu_torch.cli.serve --model_id /ckpts/llama-7b --pbw out/llama7b_pbw

Runs on CUDA unless ``--device cpu`` is given.  ``--model_id`` is an HF
checkpoint (`models.hf_import.from_pretrained`: a local directory is read
with torch alone) served with its tokenizer (`utils.tokenizer`, which needs
`transformers`); its family comes from the name (`family_for`, as in the
JAX CLI).  ``--synthetic`` builds the JAX CLIs' tiny llama or OPT instead.
``--checkpoint`` loads a dense checkpoint over the model (`utils.checkpoint`,
JAX's layout); ``--pbw`` installs a PBW v1 or v2 checkpoint over its
linears.  A draft model for speculative decoding comes from
``--draft_model_id`` (with ``--draft_checkpoint`` / ``--draft_pbw`` over it)
or ``--draft_synthetic``.  ``--http 0`` binds a free port and prints it (the
JAX CLI reads 0 as "no HTTP").

``--tp N`` (N > 1) serves through `runtime.tp_engine.TPEngine` over a
(dp=1, tp=N) mesh, one process a rank (`parallel.mesh`): without a process
group in the environment (no WORLD_SIZE) the CLI spawns its N ranks itself,
under torchrun it takes the environment's rank.  The backend is NCCL when
each rank has a card of its own, else gloo (the CPU, or ranks sharing a
card); rank 0 prints it first, and prints the results.  ``--tp`` 0 or 1
serves on one device, as in JAX.  Across ranks the requests reach rank 0
alone, and rank 0 admits them for every rank
(`runtime.multihost_batching.MultiHostBatcher`, JAX's choice for a
multi-process world).  With ``--http`` rank 0 serves HTTP and the other
ranks follow its scheduler's loop word (`runtime.server`); interrupting
rank 0 stops every rank.

    python -m pb_llm_tpu_torch.cli.serve --model_id llama --synthetic --device cpu --tp 2
    python -m pb_llm_tpu_torch.cli.serve --model_id llama --synthetic --device cpu --tp 2 \
        --http 0 --host 127.0.0.1
"""

from __future__ import annotations

import argparse
import threading


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="continuous-batching serving demo")
    p.add_argument("--model_id", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="dense checkpoint dir (utils.checkpoint; JAX's layout)")
    p.add_argument("--pbw", type=str, default=None, help="PBW v1 or v2 packed checkpoint dir")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--max_seq", type=int, default=2048)
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--kv_int8", action="store_true",
                   help="force the absmax-quantized int8 KV cache (composes with --page_size); "
                        "already the CUDA default")
    p.add_argument("--kv_dtype", type=str, default="auto",
                   choices=["auto", "int8", "bf16", "f32"],
                   help="KV cache dtype; auto = int8 on CUDA, f32 on the CPU")
    p.add_argument("--page_size", type=int, default=0,
                   help="paged KV cache: page size in tokens (0 = fixed strips); memory per "
                        "request becomes proportional to its length")
    p.add_argument("--n_pages", type=int, default=0,
                   help="page-pool size (0 = full strip capacity; fewer pages oversubscribe "
                        "the slots, and the batcher preempts when the pool runs out)")
    p.add_argument("--prefix_cache", action="store_true",
                   help="prefix caching over the paged pool (requires --page_size): requests "
                        "sharing a page-aligned prompt prefix reuse its cached KV pages and "
                        "prefill only their suffix")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (> 1: TPEngine, one process a rank, spawned "
                        "here unless torchrun started them)")
    p.add_argument("--prefill_batch", type=int, default=4,
                   help="prefill up to K same-bucket prompts in one forward")
    p.add_argument("--prefill_chunk", type=int, default=0,
                   help="chunked prefill: prompts longer than this prefill one chunk per tick, "
                        "interleaved with decode steps (0 disables)")
    p.add_argument("--spec_gamma", type=int, default=0,
                   help="speculative decoding: verify this many draft tokens per decode step "
                        "(greedy streams equal plain decode; 0 disables). Drafts come from "
                        "prompt lookup unless a --draft_* flag is given")
    p.add_argument("--draft_model_id", type=str, default=None,
                   help="draft model for speculative decoding (HF id or checkpoint dir)")
    p.add_argument("--draft_checkpoint", type=str, default=None,
                   help="dense checkpoint dir for the draft model (needs --draft_model_id)")
    p.add_argument("--draft_pbw", type=str, default=None,
                   help="PBW packed checkpoint dir for the draft model (needs --draft_model_id)")
    p.add_argument("--draft_synthetic", action="store_true",
                   help="with --synthetic: a 1-layer synthetic draft model")
    p.add_argument("--scan_layers", action="store_true",
                   help="stacked decoder layers: one loop over layer views, PBW-v2 linears "
                        "through the stacked kernels")
    p.add_argument("--fuse_linears", action="store_true",
                   help="fuse q/k/v and gate/up into single packed matmuls (PBW v2 "
                        "global-selection checkpoints; the same weights, fewer launches)")
    p.add_argument("--decode_dot", type=str, default=None,
                   choices=["auto", "f32", "int8", "dma", "bf16", "pair"],
                   help="PBW-v2 decode dot arm: auto = int8 on CUDA; f32 exact; dma exact, "
                        "with a pipelined copy of the planes (one row group); bf16; pair, "
                        "bf16 bit pairs on the tensor cores (dma and pair need 1-bit lows and "
                        "take f32 otherwise; PBW v1 ignores it)")
    p.add_argument("--prefill_kernel", type=str, default=None,
                   choices=["auto", "int8", "hybrid", "hybrid_bf16"],
                   help="PBW-v2 prefill arm (auto = int8 on CUDA; all are ported; PBW v1 "
                        "reads only hybrid_bf16, a bf16 select dot)")
    p.add_argument("--attention_impl", type=str, default=None,
                   choices=["auto", "flash", "flash_interpret", "xla"],
                   help="full-sequence attention arm (default: env or auto = flash on CUDA for "
                        "windows of 1024 or more)")
    p.add_argument("--prompts", type=str, default=None, help="file with one prompt per line")
    p.add_argument("--n_requests", type=int, default=16)
    p.add_argument("--synthetic", action="store_true",
                   help="byte tokenizer + a tiny random llama or OPT (offline)")
    p.add_argument("--demo", action="store_true",
                   help="run the built-in prompt batch and exit (the default without --http)")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve POST /generate, GET /health and GET /stats over HTTP on this "
                        "port (0: a free one) until interrupted (runtime.server)")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--device", type=str, default=None, help="default: cuda")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> int:
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    args = build_parser().parse_args(argv)
    import os

    from .. import resolve_device
    from ..parallel import mesh as pmesh

    if args.draft_model_id or args.draft_checkpoint or args.draft_pbw or args.draft_synthetic:
        if not args.spec_gamma:
            raise SystemExit("--draft_* requires --spec_gamma > 0")
        if args.draft_synthetic and not args.synthetic:
            raise SystemExit("--draft_synthetic requires --synthetic")
    if (args.draft_checkpoint or args.draft_pbw) and not args.draft_model_id:
        # a checkpoint alone has no config: the target's would shape the
        # draft's KV caches (and positions) wrong
        raise SystemExit("--draft_checkpoint/--draft_pbw need --draft_model_id "
                         "(the draft model's config/architecture)")
    if args.tp <= 1:
        return _serve(args, resolve_device(args.device))
    device = resolve_device(args.device)
    if "WORLD_SIZE" not in os.environ:
        pmesh.run_ranks(_serve_rank, args.tp, (args, device.type), device=device.type)
        return 0
    pmesh.multihost_initialize(device=device.type)
    try:
        return _serve_rank(int(os.environ["RANK"]), args, device.type)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _serve_rank(rank: int, args, device_type: str) -> int:
    """One rank of ``serve --tp N``: its card (or the CPU) and the mesh."""
    import os

    from ..parallel import mesh as pmesh

    import torch

    if device_type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.tp))
    mesh = pmesh.make_mesh(dp=1, tp=args.tp)
    if rank == 0:
        print(pmesh.backend_line(args.tp, device_type), flush=True)
    return _serve(args, pmesh.rank_device(rank, device_type), mesh)


def _serve(args, device, mesh=None) -> int:
    """Serve on ``device``: one `Engine`, or this rank's `TPEngine` of
    ``mesh`` (rank 0 admits the requests for every rank and prints)."""
    import dataclasses
    import time

    import torch

    from ..models.registry import family_for
    from ..ops import kernel_config as _kc
    from ..runtime.batching import ContinuousBatcher, Request
    from ..runtime.engine import Engine, EngineConfig
    from ..runtime.sampler import SamplingParams

    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    fam = family_for(args.model_id)
    if args.synthetic:
        from ..data.synthetic import ByteTokenizer, synthetic_model

        cfg, params = synthetic_model(fam.name, args.seed, device)
        tokenizer = ByteTokenizer()
        max_seq = min(args.max_seq, 128)
    else:
        from ..models import hf_import
        from ..utils.tokenizer import get_tokenizer

        params, cfg, _ = hf_import.from_pretrained(args.model_id)  # the engine moves it
        tokenizer = get_tokenizer(args.model_id)
        max_seq = args.max_seq
    if args.checkpoint:
        from ..utils.checkpoint import load_dense_checkpoint

        params, _ = load_dense_checkpoint(args.checkpoint)  # the engine moves it to its device
    if args.pbw:
        from ..core.pbw import install_pbw, load_pbw

        layers, _ = load_pbw(args.pbw)
        params = install_pbw(params, layers)

    if args.prompts:
        with open(args.prompts) as fh:
            texts = [line.rstrip("\n") for line in fh if line.strip()]
    else:
        texts = [f"request {i}: the quick brown fox" for i in range(args.n_requests)]

    buckets = tuple(b for b in (32, 128, 512) if b < max_seq) + (max_seq,)
    if args.page_size:
        buckets = tuple(sorted({min(-(-b // args.page_size) * args.page_size, max_seq)
                                for b in buckets}))
    over = {k: v for k, v in (("decode_dot", args.decode_dot),
                              ("prefill", args.prefill_kernel),
                              ("attention", args.attention_impl)) if v}
    kernels = dataclasses.replace(_kc.from_env(), **over) if over else None
    cache_dtype = torch.int8 if args.kv_int8 else {
        "auto": "auto", "int8": torch.int8, "bf16": torch.bfloat16,
        "f32": torch.float32}[args.kv_dtype]
    ecfg = EngineConfig(
        n_slots=args.slots, max_seq=max_seq, prefill_buckets=buckets,
        cache_dtype=cache_dtype,
        max_prefill_batch=args.prefill_batch, kernels=kernels, page_size=args.page_size,
        n_pages=args.n_pages, prefix_cache=args.prefix_cache, spec_gamma=args.spec_gamma,
        prefill_chunk=args.prefill_chunk, scan_layers=args.scan_layers,
        fuse_linears=args.fuse_linears)
    if mesh is not None:
        from ..runtime.tp_engine import TPEngine

        eng = TPEngine(params, cfg, fam, ecfg, mesh, SamplingParams(temperature=args.temperature),
                       device=device, seed=args.seed)
        say(eng.describe(), flush=True)
    else:
        eng = Engine(params, cfg, fam, ecfg, SamplingParams(temperature=args.temperature),
                     device=device, seed=args.seed)
    draft_source = None
    if args.draft_synthetic or args.draft_model_id:
        from ..runtime.draft import ModelDraftSource

        if args.draft_synthetic:
            dcfg, dparams = synthetic_model(fam.name, args.seed + 1, device, draft=True)
            dfam = fam
        else:
            dparams, dcfg, dfam = _draft_model(args)
        draft_source = ModelDraftSource(Engine(
            dparams, dcfg, dfam, EngineConfig(n_slots=args.slots, max_seq=max_seq,
                                              prefill_buckets=buckets),
            device=device, seed=args.seed))
    batcher = None
    if mesh is not None:
        from ..runtime.multihost_batching import MultiHostBatcher, follow

        batcher = MultiHostBatcher(eng, max_prompt=max_seq, draft_source=draft_source)
        if args.http is not None and mesh.rank != 0:
            follow(batcher)  # rank 0's scheduler drives; its stop word ends this
            return 0
    if args.http is not None:
        from ..runtime.server import serve_http

        server = serve_http(eng, host=args.host, port=args.http, encode=tokenizer.encode,
                            decode=tokenizer.decode, draft_source=draft_source,
                            batcher=batcher)
        print(f"serving on http://{args.host}:{server.server_address[1]} on {device}  "
              f"(POST /generate, GET /health, GET /stats)", flush=True)
        try:
            _until_interrupted(server)
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
            server.server_close()
            server.serving_loop.shutdown()
        return 0
    batcher = batcher or ContinuousBatcher(eng, draft_source=draft_source)
    reqs = [Request(request_id=i, prompt_ids=tokenizer.encode(t)[: max_seq // 2],
                    max_new_tokens=args.max_new_tokens)
            for i, t in enumerate(texts)]
    t0 = time.time()
    done = batcher.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    for r in done[:4]:
        say(f"[{r.request_id}] {tokenizer.decode(r.output_ids)!r}")
    s = batcher.stats
    say(f"device={device} requests={len(done)} tokens={s.generated_tokens} "
        f"steps={s.decode_steps} wall={dt:.2f}s tokens/s={s.generated_tokens / dt:.1f}")
    if args.spec_gamma:
        say(f"spec drafted={s.spec_drafted} accepted={s.spec_accepted}")
    if eng.pool is not None:
        say(f"pages={eng.pool.n_pages} prefix_hit_pages={eng.pool.prefix_hit_pages} "
            f"preemptions={s.preemptions}")
    return 0


def _draft_model(args):
    """(params, config, family) of the draft model: --draft_model_id (an HF
    checkpoint, its family by name as for the target), then
    --draft_checkpoint or --draft_pbw over it."""
    from ..models import hf_import
    from ..models.registry import family_for

    dparams, dcfg, _ = hf_import.from_pretrained(args.draft_model_id)
    if args.draft_checkpoint:
        from ..utils.checkpoint import load_dense_checkpoint

        dparams, _ = load_dense_checkpoint(args.draft_checkpoint)
    if args.draft_pbw:
        from ..core.pbw import install_pbw, load_pbw

        dlayers, _ = load_pbw(args.draft_pbw)
        dparams = install_pbw(dparams, dlayers)
    return dparams, dcfg, family_for(args.draft_model_id)


def _until_interrupted(server) -> None:
    """Block while ``server`` serves (until Ctrl-C)."""
    threading.Event().wait()


if __name__ == "__main__":
    raise SystemExit(main())
