#!/usr/bin/env python3
"""Ring attention at sp = 8 and the pipeline at pp = 8 (the MULTICHIP
lines "dryrun sp=8" and "dryrun pp=8") as 8 gloo ranks of this host.

    python3 scripts/torch_ring_pp_world.py            # from the repository root, the CPU
    python3 scripts/torch_ring_pp_world.py --device cuda   # ranks sharing the card(s)

Each rank holds its block of q, k, v [2, 256, 4, 32] (from a seed) and
runs `parallel.ring_attention.ring_attention` ("xla" inner on the CPU,
"auto" on a card); the gathered output is held to the masked softmax over
the whole sequence at 2e-5.  Then an 8-layer llama (hidden 64, random from
a seed, stacked) runs `parallel.pipeline.pipeline_forward` over 8 stages
with 2 micro-batches, held to the single-device forward at 2e-5.  Prints
one line each and exits 1 when either is off.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = 8


def _rank(rank: int, device: str) -> dict:
    import torch

    from pb_llm_tpu_torch.models import llama
    from pb_llm_tpu_torch.models.attention import causal_allowed, masked_softmax_attention
    from pb_llm_tpu_torch.models.stacking import stack_layers
    from pb_llm_tpu_torch.parallel import mesh as pmesh
    from pb_llm_tpu_torch.parallel.pipeline import pipeline_forward
    from pb_llm_tpu_torch.parallel.ring_attention import ring_attention_global

    torch.set_num_threads(1)
    dev = pmesh.rank_device(rank, device)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 256, 4, 32), generator=gen).to(dev) for _ in range(3))
    scale = 32 ** -0.5
    with torch.inference_mode():
        got = ring_attention_global(q, k, v, scale, pmesh.make_sp_mesh(N),
                                    inner="xla" if dev.type == "cpu" else "auto")
        ref = masked_softmax_attention(q, k, v, causal_allowed(0, 256, 256, None, device=dev),
                                       scale)
    ring_err = (got - ref).abs().max().item()
    cfg = llama.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                            num_hidden_layers=N, num_attention_heads=4, num_key_value_heads=4,
                            max_position_embeddings=64)
    params = llama.init_params(cfg, torch.Generator().manual_seed(1), device=dev)
    ids = torch.randint(0, 128, (4, 16), generator=torch.Generator().manual_seed(3)).to(dev)
    with torch.inference_mode():
        want, _ = llama.forward(params, ids, cfg)
        out = pipeline_forward(stack_layers(params), ids, cfg, pmesh.make_pp_mesh(N), n_micro=2)
    return {"ring_err": ring_err, "pp_err": (out - want.float()).abs().max().item()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    from pb_llm_tpu_torch.parallel.mesh import run_ranks

    res = run_ranks(_rank, N, (args.device,), device=args.device)
    ring, pp = max(r["ring_err"] for r in res), max(r["pp_err"] for r in res)
    print(f"sp={N} ring attention ({args.device}, gloo): max|err| {ring:.3e} from full attention "
          f"({'ok' if ring <= 2e-5 else 'OFF'})")
    print(f"pp={N} pipeline_forward ({args.device}, gloo): max|err| {pp:.3e} from the "
          f"single-device forward ({'ok' if pp <= 2e-5 else 'OFF'})")
    return 0 if ring <= 2e-5 and pp <= 2e-5 else 1


if __name__ == "__main__":
    sys.exit(main())
