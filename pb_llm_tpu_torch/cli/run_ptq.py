"""PTQ CLI (port of `pb_llm_tpu/cli/run_ptq.py`): the reference's
`gptq_pb/run.py` arguments, the JAX package's extras (--format packed /
packed_v2, --save_pbw, --synthetic, --stream) and --device.  Runs on CUDA
unless --device cpu.

    python -m pb_llm_tpu_torch.cli.run_ptq facebook/opt-synth wikitext2 xnor \\
        --low_frac 0.5 --synthetic --nsamples 2 --format packed --save_pbw ck --device cpu
    python -m pb_llm_tpu_torch.cli.run_ptq huggyllama/llama-7b wikitext2 xnor \\
        --low_frac 0.5 --synthetic --nsamples 2 --format packed_v2 --device cpu

    python -m pb_llm_tpu_torch.cli.run_ptq /ckpts/llama-7b c4 xnor --low_frac 0.9 \\
        --salient_metric hessian --format packed_v2 --stream --save_pbw out/llama7b_pbw

Calibrates layer by layer (GPTQ-PB), then evaluates windowed perplexity on
wikitext2, ptb and c4 under the exact hybrid prefill (`pin_exact_prefill`).
The model is an HF checkpoint (`models.hf_import.from_pretrained`: a local
directory is read with torch alone) with its tokenizer (`utils.tokenizer`,
which needs `transformers`), or with --synthetic the JAX CLIs' tiny
random-init llama or OPT, the byte tokenizer and synthetic corpora.  The
text datasets are not downloaded: without --synthetic the loaders raise
unless the texts are given (`data.loaders.TextSource`).  --stream calibrates
one decoder layer at a time from a local checkpoint directory into
--save_pbw; --save exports an HF checkpoint (`models.hf_export`, which needs
`transformers`).
"""

from __future__ import annotations

import argparse
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("model", type=str, help="model to load; e.g. `huggyllama/llama-7b`")
    p.add_argument("dataset", type=str, choices=["wikitext2", "ptb", "c4"])
    p.add_argument("low_quant_method", type=str, choices=["xnor", "sign", "no", "2bit", "4bit", "prune"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--nsamples", type=int, default=128)
    p.add_argument("--percdamp", type=float, default=0.01)
    p.add_argument("--low_frac", type=float, default=0)
    p.add_argument("--blocksize", type=int, default=128)
    p.add_argument("--groupsize", type=int, default=-1)
    p.add_argument("--salient_metric", type=str, default="magnitude", choices=["magnitude", "hessian"])
    p.add_argument("--high_bit", type=int, default=8)
    p.add_argument("--high_sym", action="store_true", help="symmetric 8-bit range (HighQuantizer sym)")
    p.add_argument("--high_mse", action="store_true", help="MSE clip search (HighQuantizer mse)")
    p.add_argument("--minlayer", type=int, default=-1)
    p.add_argument("--maxlayer", type=int, default=1000)
    p.add_argument("--quant_only", type=str, default="")
    p.add_argument("--invert", action="store_true")
    p.add_argument("--save", action="store_true",
                   help="HF save_pretrained of the quantized model (run.py:315-319)")
    p.add_argument("--save_dir", type=str, default=None,
                   help="export directory (default outputs/<config title>)")
    p.add_argument("--load_quantized", type=str, default=None,
                   help="skip quantization; eval a previously saved artifact (HF dir or dense "
                        "checkpoint; run.py:278-280)")
    p.add_argument("--disable_gptq", action="store_true")
    p.add_argument("--ppl_batch", type=int, default=4, help="eval windows per forward")
    p.add_argument("--capture_batch", type=int, default=8,
                   help="calibration windows per Hessian-capture forward")
    p.add_argument("--log_wandb", action="store_true", help="accepted for parity; unused")
    p.add_argument("--format", dest="fmt", type=str, default="sim",
                   choices=["sim", "packed", "packed_v2"])
    p.add_argument("--mask_structure", type=str, default=None, choices=["element", "column"],
                   help="salient-mask granularity (default: element; packed_v2 implies column)")
    p.add_argument("--col_tile", type=int, default=0,
                   help="output-row group width for column masks; 0 = one global column set")
    p.add_argument("--save_pbw", type=str, default=None, help="directory for the PBW checkpoint")
    p.add_argument("--mask_out", type=str, default=None, help="npz path for GPTQ masks")
    p.add_argument("--synthetic", action="store_true",
                   help="offline: synthetic corpus + byte tokenizer + random-init model")
    p.add_argument("--metrics", type=str, default=None, help="JSONL metrics path")
    p.add_argument("--stream", action="store_true",
                   help="GPTQ-PB streaming the checkpoint one decoder layer at a time (model must "
                        "be a local HF dir; requires --save_pbw; skips the ppl eval: serve the "
                        "artifact with `serve --pbw`)")
    p.add_argument("--device", type=str, default=None, help="default: cuda")
    return p


def load_model_and_tokenizer(args, device):
    """The HF model and its tokenizer; with --synthetic the JAX CLI's tiny
    config of the model's family, weights from a torch generator seeded 0
    (so they differ from the JAX CLI's)."""
    from ..models.registry import family_for

    fam = family_for(args.model)
    if args.synthetic:
        from ..data.synthetic import ByteTokenizer, synthetic_model

        cfg, params = synthetic_model(fam.name, device=device)
        return params, cfg, fam, ByteTokenizer()
    from ..interop import to_device
    from ..models import hf_import
    from ..utils.tokenizer import get_tokenizer

    params, cfg, _ = hf_import.from_pretrained(args.model)
    return to_device(params, device), cfg, fam, get_tokenizer(args.model)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .. import resolve_device
    from ..calib.pipeline import quantize_model_ptq, save_masks
    from ..core.config import PTQJobConfig
    from ..data.loaders import get_loaders
    from ..data.synthetic import synthetic_source
    from ..eval.ppl import perplexity
    from ..interop import to_device
    from ..ops.kernel_config import pin_exact_prefill
    from ..utils.logging import MetricsLogger

    pin_exact_prefill()  # parity: exact hybrid prefill unless the env chose an arm
    device = resolve_device(args.device)
    job = PTQJobConfig(
        model=args.model, dataset=args.dataset, low_quant_method=args.low_quant_method,
        low_frac=args.low_frac, high_bit=args.high_bit, salient_metric=args.salient_metric,
        groupsize=args.groupsize, blocksize=args.blocksize, percdamp=args.percdamp,
        nsamples=args.nsamples, seed=args.seed, minlayer=args.minlayer, maxlayer=args.maxlayer,
        quant_only=args.quant_only, invert=args.invert, disable_gptq=args.disable_gptq,
        high_sym=args.high_sym, high_mse=args.high_mse, fmt=args.fmt, mask_out=args.mask_out,
        mask_structure=args.mask_structure or ("column" if args.fmt == "packed_v2" else "element"),
        col_tile=args.col_tile,
    )
    log = MetricsLogger(args.metrics)
    if args.stream:
        return _stream(args, job, log, device)
    params, cfg, fam, tokenizer = load_model_and_tokenizer(args, device)
    source = synthetic_source() if args.synthetic else None
    seqlen = min(cfg.seqlen, 128) if args.synthetic else cfg.seqlen

    tick = time.time()
    if args.load_quantized:
        from ..utils.checkpoint import load_dense_checkpoint

        if os.path.exists(os.path.join(args.load_quantized, "config.json")):
            from ..models import hf_import
            from ..models.registry import family_for

            params, cfg, famname = hf_import.from_pretrained(args.load_quantized)
            fam = family_for(famname)
        else:
            params, _ = load_dense_checkpoint(args.load_quantized)
        params = to_device(params, device)
        log.log("loaded_quantized", path=args.load_quantized)
    elif job.low_frac:
        calib, _ = get_loaders(job.dataset, tokenizer, nsamples=job.nsamples, seed=job.seed,
                               seqlen=seqlen, flavor="ptq", source=source, model=job.model)
        params, report = quantize_model_ptq(
            params, cfg, fam, calib, job.solver(), fmt=job.fmt,
            minlayer=job.minlayer, maxlayer=job.maxlayer, quant_only=job.quant_only,
            invert=job.invert, log=lambda m: log.log("layer", msg=m),
            capture_batch=args.capture_batch)
        log.log("quantized", seconds=report.seconds, total_error=sum(report.errors.values()),
                layer_seconds=report.layer_seconds)
        if job.mask_out:
            save_masks(job.mask_out, report.masks, job.low_frac)
    print(f"quantization wall s: {time.time() - tick:.1f}")

    for ds in job.eval_datasets:
        _, evaltok = get_loaders(ds, tokenizer, nsamples=2, seed=job.seed, seqlen=seqlen,
                                 flavor="ptq", source=source, model=job.model)
        ppl = perplexity(params, cfg, fam.forward, evaltok, seqlen=seqlen,
                         window_batch=args.ppl_batch)
        log.log("ppl", dataset=ds, ppl=ppl)
        print(f"{ds} perplexity: {ppl:.4f}")

    if args.save_pbw and job.fmt in ("packed", "packed_v2"):
        from ..core.pbw import PackedLinear, PackedLinearV2, save_pbw

        layers = {f"layer_{i}/{n}": leaf for i, lp in enumerate(params["layers"])
                  for n, leaf in lp.items() if isinstance(leaf, (PackedLinear, PackedLinearV2))}
        save_pbw(args.save_pbw, layers, {"model": job.model, "config": job.save_title})
        print(f"PBW checkpoint saved to {args.save_pbw}")

    if args.save:
        from ..models import hf_export

        out = args.save_dir or f"outputs/{job.save_title}"
        hf_export.save_pretrained(params, cfg, fam.name, out,
                                  tokenizer=None if args.synthetic else tokenizer)
        log.log("saved_hf", path=out)
        print(f"HF checkpoint saved to {out}")
    return 0


def _stream(args, job, log, device) -> int:
    """--stream: GPTQ-PB of a local checkpoint directory one decoder layer
    at a time, into the sharded PBW artifact --save_pbw."""
    if not args.save_pbw:
        raise SystemExit("--stream requires --save_pbw")
    if args.synthetic:
        raise SystemExit("--stream reads a real checkpoint dir; drop --synthetic")
    from ..calib.pipeline import quantize_model_ptq_streamed, save_masks
    from ..data.loaders import get_loaders
    from ..models import hf_import
    from ..models.hf_stream import StreamedLayerLoader
    from ..models.registry import family_for
    from ..utils.tokenizer import get_tokenizer

    cfg, famname = hf_import.config_from_dir(args.model)
    fam = family_for(famname)
    calib, _ = get_loaders(job.dataset, get_tokenizer(args.model), nsamples=job.nsamples,
                           seed=job.seed, seqlen=cfg.seqlen, flavor="ptq", model=job.model)
    loader = StreamedLayerLoader(args.model, fam.name)
    report = quantize_model_ptq_streamed(
        loader, cfg, fam, calib, job.solver(), args.save_pbw, fmt=job.fmt,
        log=lambda m: log.log("layer", msg=m), capture_batch=args.capture_batch, device=device)
    log.log("quantized", seconds=report.seconds, total_error=sum(report.errors.values()))
    if job.mask_out:
        save_masks(job.mask_out, report.masks, job.low_frac)
    print(f"streamed PBW checkpoint saved to {args.save_pbw} "
          f"(peak resident layers: {loader.max_live})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
