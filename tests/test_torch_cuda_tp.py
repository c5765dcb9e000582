"""Tensor-parallel serving (`pb_llm_tpu_torch.runtime.tp_engine`) on the card.

Every test carries the `cuda` marker and skips without a card; the file
imports no JAX, so it runs on the card's machine without the repository's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_tp.py

The card's machine has one card, so the backend rule (`parallel.mesh`)
gives one rank NCCL and two ranks gloo (sharing the card).  A 1-rank NCCL
`TPEngine`, its decode step graphed with the all_reduce captured, equals
the plain `Engine` bit for bit (the same kernels on the same inputs; a sum
over one rank is the identity).  A tp = 2 gloo pair equals one process on
the exact arms (decode_dot f32, the hybrid prefill, f32 KV): the greedy
tokens equal and the prefill logits within 1e-4 of max|logit| (the shards'
partial sums add in another order than one device's).  A shard no kernel
arm takes raises at construction on the card, naming the layer and a
pack_block that divides its ic.
"""

import numpy as np
import pytest
import torch

from pb_llm_tpu_torch.data.synthetic import random_packed_llama
from pb_llm_tpu_torch.models.llama import LlamaConfig
from pb_llm_tpu_torch.models.registry import family_for
from pb_llm_tpu_torch.ops.kernel_config import KernelConfig
from pb_llm_tpu_torch.parallel import mesh as pmesh
from pb_llm_tpu_torch.parallel.mesh import Mesh
from pb_llm_tpu_torch.runtime.engine import Engine, EngineConfig
from pb_llm_tpu_torch.runtime.tp_engine import TPEngine

torch.set_num_threads(2)

EXACT = dict(decode_dot="f32", prefill="hybrid")
LOGIT_RTOL = 1e-4  # of max|logit|: the shards' partial sums add in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _cfg(hidden=256, ffn=512, heads=2, layers=2):
    return LlamaConfig(vocab_size=256, hidden_size=hidden, intermediate_size=ffn,
                       num_hidden_layers=layers, num_attention_heads=heads,
                       max_position_embeddings=512)


def _run(eng):
    """Two prompts, 6 greedy steps; (tokens by slot, prefill logits, each
    step's logits of the active rows)."""
    r = np.random.default_rng(1)
    prompts = [r.integers(0, 256, n).tolist() for n in (20, 90)]
    toks = {s: [eng.prefill(s, p)] for s, p in enumerate(prompts)}
    pre = [eng._prefill_logits[s].float().cpu() for s in range(2)]
    steps, inner = [], eng._step_logits

    def recorded():
        out = inner()
        steps.append(out[:2].float().cpu())
        return out

    eng._step_logits = recorded
    for _ in range(6):
        for s, t in eng.decode_step().items():
            toks[s].append(t)
    return toks, pre, steps


@pytest.mark.cuda
def test_nccl_one_rank_tp_engine_graphed_equals_engine(cuda):
    """TPEngine(tp=1) over a 1-rank NCCL group, graphed, against Engine:
    the same tokens, every logit bit for bit, the same launches; the step
    replays a graph."""
    import torch.distributed as dist

    from pb_llm_tpu_torch.ops import counters

    cfg = _cfg()
    params = random_packed_llama(cfg, torch.Generator().manual_seed(0))
    ecfg = EngineConfig(n_slots=2, max_seq=256, prefill_buckets=(32, 128))
    assert pmesh.multihost_initialize(pmesh.free_address(), 1, 0, device="cuda") == "nccl"
    try:
        mesh = pmesh.make_mesh(dp=1, tp=1)
        out = {}
        for name in ("engine", "tp"):
            eng = (Engine(params, cfg, family_for("llama"), ecfg, device=cuda) if name == "engine"
                   else TPEngine(params, cfg, family_for("llama"), ecfg, mesh, device=cuda))
            before = counters.read()
            res = _run(eng)
            torch.cuda.synchronize()
            after = counters.read()
            out[name] = res + ({k: after[k] - before[k] for k in after}, eng._step.replays)
    finally:
        dist.destroy_process_group()
    e, t = out["engine"], out["tp"]
    assert t[0] == e[0]
    assert all(torch.equal(a, b) for a, b in zip(t[1] + t[2], e[1] + e[2]))
    assert t[3] == e[3] and t[4] > 0


def _pair_rank(rank: int) -> dict:
    """A rank of the tp = 2 gloo pair on the card."""
    cfg = _cfg()
    eng = TPEngine(random_packed_llama(cfg, torch.Generator().manual_seed(2), pack_block=128,
                                       row_shards=2),
                   cfg, family_for("llama"),
                   EngineConfig(n_slots=2, max_seq=256, prefill_buckets=(32, 128),
                                cache_dtype=torch.float32, kernels=KernelConfig(**EXACT)),
                   pmesh.make_mesh(dp=1, tp=2), device="cuda")
    toks, pre, steps = _run(eng)
    return {"tokens": toks, "prefill": pre, "steps": steps, "describe": eng.describe()}


@pytest.mark.cuda
def test_tp2_gloo_pair_on_the_card_equals_one_process(cuda):
    """Two gloo ranks sharing the card against one process on the same
    planes, exact arms: the same greedy tokens, prefill logits within
    LOGIT_RTOL of max|logit|, both ranks bit for bit alike."""
    cfg = _cfg()
    params = random_packed_llama(cfg, torch.Generator().manual_seed(2), pack_block=128,
                                 row_shards=2)
    eng = Engine(params, cfg, family_for("llama"),
                 EngineConfig(n_slots=2, max_seq=256, prefill_buckets=(32, 128),
                              cache_dtype=torch.float32, kernels=KernelConfig(**EXACT)),
                 device=cuda)
    want_toks, want_pre, _ = _run(eng)
    ranks = pmesh.run_ranks(_pair_rank, 2, device="cuda", timeout=600)
    r0 = ranks[0]
    assert "backend=gloo" in r0["describe"] and "eager" in r0["describe"]
    assert ranks[1]["tokens"] == r0["tokens"]
    assert all(torch.equal(a, b) for a, b in zip(ranks[1]["prefill"] + ranks[1]["steps"],
                                                 r0["prefill"] + r0["steps"]))
    assert r0["tokens"] == want_toks
    for a, b in zip(r0["prefill"], want_pre):
        assert (a - b).abs().max() <= LOGIT_RTOL * b.abs().max()


@pytest.mark.cuda
def test_a_shard_no_kernel_takes_raises_at_construction(cuda):
    """pack_block 256 at ic/tp = 5504 (llama-7b's down_proj at tp = 2)
    raises, naming the layer and pack_block 128; a column shard of 192
    output columns (no multiple of 128) raises on the card only."""
    mesh = Mesh(1, 2)
    ecfg = EngineConfig(n_slots=1, max_seq=64, prefill_buckets=(32,))
    cfg = _cfg(hidden=512, ffn=11008, heads=4, layers=1)
    params = random_packed_llama(cfg, torch.Generator().manual_seed(3), pack_block=256,
                                 row_shards=2)
    with pytest.raises(ValueError, match=r"down_proj.*128"):
        TPEngine(params, cfg, family_for("llama"), ecfg, mesh, device=cuda)
    cfg = _cfg(hidden=384, ffn=768, heads=6, layers=1)
    params = random_packed_llama(cfg, torch.Generator().manual_seed(4), row_shards=2)
    with pytest.raises(ValueError, match=r"q_proj.*oc 192.*plain version"):
        TPEngine(params, cfg, family_for("llama"), ecfg, mesh, device=cuda)
    TPEngine(params, cfg, family_for("llama"), ecfg, mesh, device="cpu")
