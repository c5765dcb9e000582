"""Eval CLI (port of the perplexity half of `pb_llm_tpu/cli/run_eval.py`):
windowed perplexity on wikitext2 / ptb / c4 under the exact hybrid prefill
(`pin_exact_prefill`).  Runs on CUDA unless --device cpu.

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
layer's views through the ordinary dispatch, as in JAX.  Task suites
(--tasks) and sequence parallelism (--sp) are not ported yet.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Perplexity evaluation")
    p.add_argument("checkpoint", type=str, nargs="?", default=None,
                   help="dense checkpoint dir (utils.checkpoint) or PBW v1/v2 dir; omit for the "
                        "base model")
    p.add_argument("--model_id", type=str, required=True)
    p.add_argument("--tasks", type=str, default="", help="task suites (not ported yet)")
    p.add_argument("--eval_ppl", type=str, default="wikitext2,ptb,c4")
    p.add_argument("--limit", type=int, default=-1)
    p.add_argument("--ppl_batch", type=int, default=4, help="eval windows per forward")
    p.add_argument("--ppl_limit", type=int, default=None, help="max ppl windows per dataset")
    p.add_argument("--seqlen", type=int, default=None)
    p.add_argument("--flavor", type=str, default="qat", choices=["ptq", "qat"],
                   help="eval-text construction flavor (the two reference pipelines differ)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--metrics", type=str, default=None)
    p.add_argument("--sp", type=int, default=1, help="sequence-parallel ways (not ported yet)")
    p.add_argument("--scan_layers", action="store_true",
                   help="stacked layers for the ppl forward (models.stacking)")
    p.add_argument("--vocab_limit", type=int, default=50257, help="task scoring (not ported yet)")
    p.add_argument("--num_fewshot", type=int, default=0, help="task scoring (not ported yet)")
    p.add_argument("--device", type=str, default=None, help="default: cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.tasks:
        raise NotImplementedError("--tasks: eval/tasks.py is not ported yet (ROADMAP Queue 1, slice 2)")
    if args.sp > 1:
        raise NotImplementedError("--sp: perplexity_sp and ring attention are not ported yet "
                                  "(ROADMAP Queue 1, slice 5)")

    from .. import resolve_device
    from ..data.loaders import get_eval_tokens, get_loaders
    from ..eval.ppl import perplexity
    from ..interop import to_device
    from ..models.registry import family_for
    from ..ops.kernel_config import pin_exact_prefill
    from ..utils.logging import MetricsLogger

    pin_exact_prefill()  # parity: exact hybrid prefill unless the env chose an arm
    device = resolve_device(args.device)
    log = MetricsLogger(args.metrics)
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
        ppl = perplexity(params, cfg, fam.forward, evaltok, seqlen=seqlen,
                         window_limit=args.ppl_limit, window_batch=args.ppl_batch)
        log.log("ppl", dataset=ds, ppl=ppl)
        print(f"{ds} perplexity: {ppl:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
