"""Streamed HF → PBW conversion CLI (port of `pb_llm_tpu/cli/convert.py`),
for checkpoints larger than host RAM.  Runs on CUDA unless --device cpu.

    python -m pb_llm_tpu_torch.cli.convert /ckpts/llama-7b out/llama7b_pbw \\
        --family llama --method xnor --low_frac 0.9 --format packed_v2

Walks the checkpoint shard by shard (`models.hf_stream`, torch alone: no
`transformers` or `safetensors` needed), packs each decoder layer as soon as
its weights are complete, and writes a sharded PBW artifact
(`core.pbw.PBWShardWriter`) that `load_pbw` and `cli.serve --pbw` read.
"""

from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="streamed HF -> PBW conversion")
    p.add_argument("model_dir", type=str, help="HF checkpoint directory (safetensors or torch bins)")
    p.add_argument("out_dir", type=str, help="output PBW artifact directory")
    p.add_argument("--family", type=str, required=True, choices=["llama", "opt"])
    p.add_argument("--method", type=str, default="xnor",
                   choices=["xnor", "sign", "rtn", "prune"])
    p.add_argument("--low_frac", type=float, default=0.9)
    p.add_argument("--high_bit", type=int, default=8)
    p.add_argument("--format", dest="fmt", type=str, default="packed_v2",
                   choices=["packed", "packed_v2"])
    p.add_argument("--groupsize", type=int, default=-1, help="v1 format only")
    p.add_argument("--minlayer", type=int, default=0)
    p.add_argument("--maxlayer", type=int, default=10 ** 9)
    p.add_argument("--device", type=str, default=None, help="packing device; default: cuda")
    return p


def main(argv=None) -> int:
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    args = build_parser().parse_args(argv)
    from ..models.hf_stream import rtn_pack_fn, stream_pack_to_pbw

    pack = rtn_pack_fn(method=args.method, low_frac=args.low_frac, high_bit=args.high_bit,
                       fmt=args.fmt, groupsize=args.groupsize, device=args.device)
    t0 = time.time()
    done = stream_pack_to_pbw(args.model_dir, args.out_dir, args.family,
                              pack_fn=pack, min_layer=args.minlayer, max_layer=args.maxlayer)
    print(f"packed {len(done)} linears -> {args.out_dir} in {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
