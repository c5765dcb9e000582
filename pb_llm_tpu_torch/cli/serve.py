"""Serving demo CLI (port of `pb_llm_tpu/cli/serve.py`, strip-cache path):
runs a batch of prompts through the continuous batcher and reports tokens/s.

    python -m pb_llm_tpu_torch.cli.serve --model_id llama --synthetic --demo
    python -m pb_llm_tpu_torch.cli.serve --model_id huggyllama/llama-7b --synthetic \
        --pbw checkpoints/llama7b_pbw

Runs on CUDA unless ``--device cpu`` is given.  ``--pbw`` installs a PBW v2
checkpoint over the params the other flags build (HF import and dense
checkpoints are not ported yet).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="continuous-batching serving demo")
    p.add_argument("--model_id", type=str, required=True)
    p.add_argument("--pbw", type=str, default=None, help="PBW v2 packed checkpoint dir")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--max_seq", type=int, default=2048)
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--kv_dtype", type=str, default="auto", choices=["auto", "int8", "f32"],
                   help="KV cache dtype; auto = int8 on CUDA, f32 on the CPU")
    p.add_argument("--prefill_batch", type=int, default=4,
                   help="prefill up to K same-bucket prompts in one forward")
    p.add_argument("--decode_dot", type=str, default=None,
                   choices=["auto", "f32", "int8", "dma", "bf16", "pair"],
                   help="PBW-v2 decode dot arm (auto = int8; only int8 is ported)")
    p.add_argument("--prefill_kernel", type=str, default=None,
                   choices=["auto", "int8", "hybrid", "hybrid_bf16"],
                   help="PBW-v2 prefill arm (auto = int8 on CUDA; only int8 is ported)")
    p.add_argument("--prompts", type=str, default=None, help="file with one prompt per line")
    p.add_argument("--n_requests", type=int, default=16)
    p.add_argument("--synthetic", action="store_true",
                   help="byte tokenizer + a tiny random llama (offline)")
    p.add_argument("--demo", action="store_true", help="run the built-in prompt batch and exit")
    p.add_argument("--device", type=str, default=None, help="default: cuda")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import dataclasses
    import time

    import torch

    from .. import resolve_device
    from ..models.registry import family_for
    from ..ops import kernel_config as _kc
    from ..runtime.batching import ContinuousBatcher, Request
    from ..runtime.engine import Engine, EngineConfig
    from ..runtime.sampler import SamplingParams

    device = resolve_device(args.device)
    fam = family_for(args.model_id)
    if not args.synthetic:
        raise NotImplementedError("HF model import is not ported yet (ROADMAP): use --synthetic")
    from ..data.synthetic import ByteTokenizer
    from ..models.llama import LlamaConfig, init_params

    cfg = LlamaConfig(vocab_size=259, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=256)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed), device=device)
    tokenizer = ByteTokenizer()
    max_seq = min(args.max_seq, 128)
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
    over = {k: v for k, v in (("decode_dot", args.decode_dot),
                              ("prefill", args.prefill_kernel)) if v}
    kernels = dataclasses.replace(_kc.from_env(), **over) if over else None
    ecfg = EngineConfig(
        n_slots=args.slots, max_seq=max_seq, prefill_buckets=buckets,
        cache_dtype={"auto": "auto", "int8": torch.int8, "f32": torch.float32}[args.kv_dtype],
        max_prefill_batch=args.prefill_batch, kernels=kernels)
    eng = Engine(params, cfg, fam, ecfg, SamplingParams(temperature=args.temperature),
                 device=device, seed=args.seed)
    batcher = ContinuousBatcher(eng)
    reqs = [Request(request_id=i, prompt_ids=tokenizer.encode(t)[: max_seq // 2],
                    max_new_tokens=args.max_new_tokens)
            for i, t in enumerate(texts)]
    t0 = time.time()
    done = batcher.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    for r in done[:4]:
        print(f"[{r.request_id}] {tokenizer.decode(r.output_ids)!r}")
    s = batcher.stats
    print(f"device={device} requests={len(done)} tokens={s.generated_tokens} "
          f"steps={s.decode_steps} wall={dt:.2f}s tokens/s={s.generated_tokens / dt:.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
