"""Eval CLI (port of `pb_llm_tpu/cli/run_eval.py`): windowed perplexity on
wikitext2 / ptb / c4 and multiple-choice task suites (boolq,piqa / llmqat /
mmlu, `eval.tasks`) under the exact hybrid prefill (`pin_exact_prefill`).
Runs on CUDA unless --device cpu.

    python -m pb_llm_tpu_torch.cli.run_eval --model_id llama --synthetic \\
        --eval_ppl wikitext2 --device cpu

``--model_id`` is an HF checkpoint (`models.hf_import.from_pretrained`: a
local directory is read with torch alone) with its tokenizer
(`utils.tokenizer`, which needs `transformers`), its family by name; the
text datasets are not downloaded, so without --synthetic the loaders raise
unless the texts are given (`data.loaders.TextSource`).  ``--synthetic``
builds the JAX CLIs' tiny llama or OPT (by --model_id), the byte tokenizer
and synthetic corpora.  ``checkpoint`` is a dense checkpoint
(`utils.checkpoint`) or a PBW v1 or v2 directory (installed over the
model's linears).  ``--scan_layers`` stacks
the layers (`models.stacking`); the eval windows (m >= 256 rows) take each
layer's views through the ordinary dispatch, as in JAX.  ``--tasks`` loads
its examples with the `datasets` package (a network or a populated cache),
and raises without it; offline, score hand-built `eval.tasks.Example`s
through `evaluate_model_tasks(examples_by_task=...)`.

``--sp N`` (N > 1) evaluates each perplexity window across N ranks
(`eval.ppl.perplexity_sp`: each rank holds T/N rows through the whole
forward, attention is the ring); seqlen must divide by N.  As ``serve
--tp``, the CLI spawns its ranks unless torchrun started them (WORLD_SIZE
in the environment); gloo on the CPU or for ranks sharing a card, NCCL
with a card a rank; rank 0 prints, and runs the task suites.

    python -m pb_llm_tpu_torch.cli.run_eval --model_id llama --synthetic \
        --eval_ppl wikitext2 --device cpu --sp 2
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Perplexity + task evaluation")
    p.add_argument("checkpoint", type=str, nargs="?", default=None,
                   help="dense checkpoint dir (utils.checkpoint) or PBW v1/v2 dir; omit for the "
                        "base model")
    p.add_argument("--model_id", type=str, required=True)
    p.add_argument("--tasks", type=str, default="", help="comma list; suites: llmqat, mmlu")
    p.add_argument("--eval_ppl", type=str, default="wikitext2,ptb,c4")
    p.add_argument("--limit", type=int, default=-1)
    p.add_argument("--ppl_batch", type=int, default=4, help="eval windows per forward")
    p.add_argument("--ppl_limit", type=int, default=None, help="max ppl windows per dataset")
    p.add_argument("--seqlen", type=int, default=None)
    p.add_argument("--flavor", type=str, default="qat", choices=["ptq", "qat"],
                   help="eval-text construction flavor (the two reference pipelines differ)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--metrics", type=str, default=None)
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ranks: each eval window's rows over N ranks with ring "
                        "attention (seqlen must be divisible by N; spawned here unless torchrun "
                        "started them)")
    p.add_argument("--scan_layers", action="store_true",
                   help="stacked layers for the ppl forward (models.stacking)")
    p.add_argument("--vocab_limit", type=int, default=50257,
                   help="slice logits to the first N rows during task scoring (the reference's "
                        "evaluate.py:79; no-op when vocab <= N); 0 disables")
    p.add_argument("--num_fewshot", type=int, default=0,
                   help="lm-eval v0.3 few-shot prompting (labeled examples joined into each "
                        "query context)")
    p.add_argument("--device", type=str, default=None, help="default: cuda")
    return p


def main(argv=None) -> int:
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    args = build_parser().parse_args(argv)
    from .. import resolve_device

    device = resolve_device(args.device)
    if args.sp <= 1:
        return _evaluate(args, device)
    from ..parallel import mesh as pmesh

    if "WORLD_SIZE" not in os.environ:
        pmesh.run_ranks(_eval_rank, args.sp, (args, device.type), device=device.type)
        return 0
    pmesh.multihost_initialize(device=device.type)
    try:
        return _eval_rank(int(os.environ["RANK"]), args, device.type)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _eval_rank(rank: int, args, device_type: str) -> int:
    """One rank of ``run_eval --sp N``: its card (or the CPU) and the sp
    mesh (a world larger than N holds several, each evaluating alike)."""
    import torch

    from ..parallel import mesh as pmesh

    if device_type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.sp))
    mesh = pmesh.make_sp_mesh(args.sp)
    if rank == 0:
        print(pmesh.backend_line(args.sp, device_type, axis="sp"), flush=True)
    return _evaluate(args, pmesh.rank_device(rank, device_type), mesh)


def _evaluate(args, device, mesh=None) -> int:
    """Perplexity (and the task suites) on ``device``; with an sp ``mesh``
    each window's rows over its ranks, rank 0 printing."""
    from ..data.loaders import get_eval_tokens, get_loaders
    from ..eval.ppl import perplexity, perplexity_sp
    from ..eval.tasks import evaluate_model_tasks
    from ..interop import to_device
    from ..models.registry import family_for
    from ..ops.kernel_config import pin_exact_prefill
    from ..utils.logging import MetricsLogger

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    pin_exact_prefill()  # parity: exact hybrid prefill unless the env chose an arm
    log = MetricsLogger(args.metrics if lead else None)
    fam = family_for(args.model_id)
    if args.synthetic:
        from ..data.synthetic import ByteTokenizer, synthetic_model, synthetic_source

        cfg, params = synthetic_model(fam.name, device=device)
        tokenizer = ByteTokenizer()
        source = synthetic_source()
        seqlen = args.seqlen or 64
    else:
        from ..models import hf_import
        from ..utils.tokenizer import get_tokenizer

        params, cfg, _ = hf_import.from_pretrained(args.model_id)
        params = to_device(params, device)
        tokenizer = get_tokenizer(args.model_id)
        source = None
        seqlen = args.seqlen or cfg.seqlen

    if args.checkpoint:
        if os.path.exists(os.path.join(args.checkpoint, "weights.npz")):
            from ..utils.checkpoint import load_dense_checkpoint

            params, extra = load_dense_checkpoint(args.checkpoint)
            params = to_device(params, device)
        else:
            from ..core.pbw import install_pbw, load_pbw

            layers, extra = load_pbw(args.checkpoint)
            params = install_pbw(params, layers)
        log.log("loaded_checkpoint", path=args.checkpoint, **{k: str(v) for k, v in extra.items()})

    if args.scan_layers:
        from ..models.stacking import stack_layers

        params = stack_layers(params)

    for ds in [d for d in args.eval_ppl.split(",") if d]:
        if args.flavor == "qat":
            evaltok = get_eval_tokens(ds, tokenizer, source=source)
        else:
            _, evaltok = get_loaders(ds, tokenizer, nsamples=2, seqlen=seqlen, flavor="ptq",
                                     source=source)
        if mesh is not None:
            ppl = perplexity_sp(params, cfg, fam.forward, evaltok, mesh, seqlen=seqlen,
                                window_limit=args.ppl_limit)
        else:
            ppl = perplexity(params, cfg, fam.forward, evaltok, seqlen=seqlen,
                             window_limit=args.ppl_limit, window_batch=args.ppl_batch)
        log.log("ppl", dataset=ds, ppl=ppl)
        say(f"{ds} perplexity: {ppl:.4f}")

    tasks = [t for t in args.tasks.split(",") if t]
    if tasks and lead:
        out = evaluate_model_tasks(params, cfg, fam, tokenizer, tasks, limit=args.limit,
                                   vocab_limit=args.vocab_limit or None,
                                   num_fewshot=args.num_fewshot)
        for t, r in out["results"].items():
            print(f"{t}: acc {r['acc']:.4f} (n={r['n']})")
            log.log("task", task=t, **r)
        print(f"mean acc: {out['mean_acc']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
