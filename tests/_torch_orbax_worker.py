"""The rank side of `tests/test_torch_orbax_ckpt.py`: save trees sharded
at tp = 4, restore them at tp = 4, at (dp 2, tp 2) and whole, on four gloo
ranks.  This module imports the port, torch and numpy only: the rank
processes import no JAX."""

from __future__ import annotations

import os

import torch


def _leaves(tree):
    from pb_llm_tpu_torch.utils.orbax_ckpt import _walk

    return dict(_walk(tree))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    t = t.detach().contiguous()
    return t.view(torch.uint8) if t.dtype.is_floating_point else t


def same_bits(a, b) -> bool:
    """Every tensor of two trees equal bit for bit (dtype and shape too)."""
    la, lb = _leaves(a), _leaves(b)
    return la.keys() == lb.keys() and all(
        la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape
        and torch.equal(_bytes(la[k]), _bytes(lb[k])) for k in la)


def _greedy(eng, prompt, steps: int = 4):
    toks = [eng.prefill(0, prompt)]
    for _ in range(steps):
        toks.append(int(eng.decode_step()[0]))
    return toks


def save_restore(rank: int, root: str, trees: dict, placed: str, cfg) -> dict:
    """Each tree (name -> (tree, fsdp at dp 2)): saved by its tp = 4 blocks
    under root/name; restored at tp = 4 and at (dp 2, tp 2), each rank's
    blocks held to `shard_params`' cut, and whole on every rank.  The dense
    llama's restored tp = 4 blocks (``cfg``) serve greedy tokens through
    `TPEngine(sharded=True)`, as its never-saved tree does.  ``placed``: a
    whole [64, 16] ``w`` saved from one process, restored under
    P(None, "tp")."""
    from pb_llm_tpu_torch.models.registry import FAMILIES
    from pb_llm_tpu_torch.parallel import sharding
    from pb_llm_tpu_torch.parallel.mesh import make_mesh
    from pb_llm_tpu_torch.runtime.engine import EngineConfig
    from pb_llm_tpu_torch.runtime.tp_engine import TPEngine
    from pb_llm_tpu_torch.utils.orbax_ckpt import restore_sharded, save_sharded

    torch.set_num_threads(1)
    mesh4, mesh22 = make_mesh(dp=1, tp=4), make_mesh(dp=2, tp=2)
    out = {}
    for name, (tree, fsdp) in trees.items():
        path = os.path.join(root, name)
        specs4 = sharding.param_specs(tree, "llama", mesh4)
        blocks4 = sharding.shard_params(tree, mesh4, "llama")
        save_sharded(path, blocks4, mesh4, specs4)
        specs22 = sharding.param_specs(tree, "llama", mesh22, fsdp=fsdp)
        restored4 = restore_sharded(path, tree, mesh4, specs4)
        out[name] = {
            "tp4": same_bits(restored4, blocks4),
            "tp2": same_bits(restore_sharded(path, tree, mesh22, specs22),
                             sharding.shard_params(tree, mesh22, "llama", fsdp=fsdp)),
            "whole": same_bits(restore_sharded(path, tree), tree),
        }
        if name == "dense":
            ecfg = EngineConfig(n_slots=1, max_seq=64, prefill_buckets=(16,),
                                cache_dtype=torch.float32)
            fam = FAMILIES["llama"]
            out["served"] = [
                _greedy(TPEngine(t, cfg, fam, ecfg, mesh4, device="cpu", sharded=sharded),
                        [3, 1, 4, 1, 5, 9, 2, 6])
                for t, sharded in ((tree, False), (restored4, True))]
    w = torch.arange(64.0 * 16).reshape(64, 16)
    got = restore_sharded(placed, {"w": w}, mesh4, {"w": sharding.P(None, "tp")})["w"]
    out["placed"] = torch.equal(got, w[:, rank * 4:(rank + 1) * 4])
    return out
