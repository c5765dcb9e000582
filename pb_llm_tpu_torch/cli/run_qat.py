"""QAT CLI (port of `pb_llm_tpu/cli/run_qat.py`): the reference's
`qat/run_qat.py` arguments, the JAX package's extras and --device.  Runs on
CUDA unless --device cpu.

    python -m pb_llm_tpu_torch.cli.run_qat --model_id facebook/opt-125m --synthetic \\
        --train_steps 2 --device cpu
    python -m pb_llm_tpu_torch.cli.run_qat --binarization_method=xnor_outlier \\
        --model_id=/ckpts/opt-1.3b --train_step=10000 --dataset=red_pajama --outlier_fraction 0.1

Every decoder linear becomes a partially-binarized STE layer (`train.qat`),
AdamW trains them, and the fake-quant weights are saved as a dense
checkpoint (`utils.checkpoint`) under out_dir/model_id/method_frac_steps,
which `cli.run_eval` reads; --save_hf also exports an HF directory
(`models.hf_export`, which needs `transformers`).  The model is an HF
checkpoint (`models.hf_import.from_pretrained`: a local directory is read
with torch alone) with its tokenizer (`utils.tokenizer`, which needs
`transformers`), or with --synthetic the JAX CLIs' tiny random-init llama
or OPT, the byte tokenizer and synthetic corpora.  The training texts are
not downloaded: without --synthetic the loader raises unless the texts are
given (`data.loaders.TextSource`).

With --dp·--tp > 1 the QAT tree is placed on a (dp, tp) mesh
(`parallel.sharding.shard_params`, --fsdp also splitting its weights and
their Adam moments over dp), as JAX's CLI does, and each rank trains its
block (`train.qat` under a mesh).  The ranks are spawned on this host
(`parallel.mesh.run_ranks`: gloo on the CPU or on a shared card, NCCL with
a card a rank), or, in a process group set up by torchrun (WORLD_SIZE in
the environment), this process is one of them.  Rank 0 prints and writes
the checkpoints, from the tree gathered back (`sharding.gather_params`);
every rank returns 0.  --fsdp at dp = tp = 1 trains on one device.

    python -m pb_llm_tpu_torch.cli.run_qat --model_id facebook/opt-synth --synthetic \
        --device cpu --train_steps 2 --seqlen 32 --dp 2 --tp 2 --fsdp
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="QAT fine-tuning")
    p.add_argument("--model_id", type=str, default="facebook/opt-350m")
    p.add_argument("--dataset", type=str, default="Abirate/english_quotes")
    p.add_argument("--data_percent", type=float, default=100)
    p.add_argument("-s", "--train_steps", "--train_step", dest="train_steps", type=int, default=1000)
    p.add_argument(
        "--binarization_method", type=str, default="xnor_outlier",
        choices=["xnor_outlier", "xnor_outlier_hessian"],
    )
    p.add_argument("--outlier_fraction", type=float, default=0.1)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--seqlen", type=int, default=2048)
    p.add_argument("--gptq_masks", type=str, default=None,
                   help="masks npz from run_ptq --mask_out (hessian variant)")
    p.add_argument("--wrap_compat_8bit", action="store_true",
                   help="freeze the sim-8bit master with the reference's uint8 WRAP semantics "
                        "(default: the clamp fix)")
    p.add_argument("--out_dir", type=str, default="outputs")
    p.add_argument("--save_hf", action="store_true",
                   help="also export an HF save_pretrained dir + tokenizer")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel mesh axis (the batch rows split over dp ranks)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh axis (Megatron column / row linears over tp ranks)")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3-style sharding of the QAT weights and their Adam moments over "
                        "dp (read only when dp·tp > 1, as in JAX); numerics unchanged")
    p.add_argument("--metrics", type=str, default=None)
    p.add_argument("--device", type=str, default=None, help="default: cuda")
    return p


def main(argv=None) -> int:
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    args = build_parser().parse_args(argv)
    from .. import resolve_device

    device = resolve_device(args.device)
    world = args.dp * args.tp
    # as in JAX, the mesh (and --fsdp with it) is taken only when dp·tp > 1
    if world == 1:
        return _train(args, device)
    from ..parallel import mesh as pmesh

    if "WORLD_SIZE" not in os.environ:
        pmesh.run_ranks(_train_rank, world, (args, device.type), device=device.type)
        return 0
    pmesh.multihost_initialize(device=device.type)
    try:
        return _train_rank(int(os.environ["RANK"]), args, device.type)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _train_rank(rank: int, args, device_type: str) -> int:
    """One rank of ``run_qat --dp D --tp T``: its card (or the CPU) and the
    mesh."""
    import torch

    from ..parallel import mesh as pmesh

    world = args.dp * args.tp
    if device_type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = pmesh.make_mesh(dp=args.dp, tp=args.tp)
    if rank == 0:
        print(pmesh.backend_line(world, device_type, axis="dp x tp"), flush=True)
    return _train(args, pmesh.rank_device(rank, device_type), mesh)


def _train(args, device, mesh=None) -> int:
    """Train on ``device``: the whole tree, or this rank's blocks of it on
    ``mesh`` (rank 0 prints and writes)."""
    from ..calib.pipeline import load_masks
    from ..data.loaders import get_qat_dataset
    from ..interop import to_device
    from ..models.registry import family_for
    from ..train import qat as tq
    from ..utils.checkpoint import save_dense_checkpoint
    from ..utils.logging import MetricsLogger

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    log = MetricsLogger(args.metrics)
    fam = family_for(args.model_id)
    if args.synthetic:
        from ..data.synthetic import ByteTokenizer, synthetic_model, synthetic_source

        cfg, params = synthetic_model(fam.name, device=device)
        tokenizer = ByteTokenizer()
        source = synthetic_source()
        seqlen = min(args.seqlen, 128)
    else:
        from ..models import hf_import
        from ..utils.tokenizer import get_tokenizer

        params, cfg, _ = hf_import.from_pretrained(args.model_id)
        params = to_device(params, device)
        tokenizer = get_tokenizer(args.model_id)
        source = None
        seqlen = args.seqlen

    qcfg = tq.QATConfig(
        binarization_method=args.binarization_method,
        outlier_fraction=args.outlier_fraction,
        train_steps=args.train_steps,
        learning_rate=args.learning_rate,
        wrap_compat_8bit=args.wrap_compat_8bit,
    )
    gptq_masks = None
    if args.gptq_masks:
        gptq_masks, _ = load_masks(args.gptq_masks)
    params = tq.replace_linears(params, fam, qcfg, gptq_masks)
    bits = tq.mean_bits_report(params, fam)
    # the reference's report format (qat/run_qat.py:110)
    say(f"mean_bit: {bits} frac: {bits / 16}")
    log.log("mean_bits", bits=bits)

    specs = None
    if mesh is not None:
        from ..parallel import sharding

        specs = sharding.param_specs(params, fam.name, mesh, fsdp=args.fsdp)
        params = sharding.shard_params(params, mesh, fam.name, fsdp=args.fsdp)

    data = get_qat_dataset(args.dataset, tokenizer, args.data_percent, seqlen=seqlen,
                           batch_size=args.batch_size, source=source)
    params, losses = tq.train(params, cfg, fam, qcfg, data,
                              log=lambda i, l: log.log("train", step=i, loss=l),
                              mesh=mesh, specs=specs)
    if mesh is not None:
        params = sharding.gather_params(params, mesh, specs)
        if not lead:
            return 0

    dense = tq.export_dense(params, fam)
    save_dir = os.path.join(
        args.out_dir, args.model_id,
        f"{args.binarization_method}_{args.outlier_fraction}_{args.train_steps}")
    save_dense_checkpoint(save_dir, dense,
                          {"model_id": args.model_id, "final_loss": losses[-1] if losses else None})
    print(f"model saved to {save_dir}")

    if args.save_hf:
        from ..models import hf_export

        hf_dir = save_dir + "_hf"
        hf_export.save_pretrained(dense, cfg, fam.name, hf_dir,
                                  tokenizer=None if args.synthetic else tokenizer)
        log.log("saved_hf", path=hf_dir)
        print(f"HF checkpoint saved to {hf_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
