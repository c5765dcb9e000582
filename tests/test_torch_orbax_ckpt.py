"""Port parity of sharded checkpoints (`pb_llm_tpu_torch.utils.orbax_ckpt`
on `torch.distributed.checkpoint`), the cases of JAX's
tests/test_orbax_ckpt.py: a dense tree and a packed v2 tree (its static
fields from the template) round-trip, and a whole tensor restores onto a
mesh under P(None, "tp").  Added: trees saved by their tp = 4 blocks (four
gloo ranks, one world for the module; the ranks run
`tests/_torch_orbax_worker.py`, which imports no JAX) restore bit for bit at
tp = 4, at (dp 2, tp 2) (the QAT tree under fsdp) and whole on each rank,
and in one process here: a dense llama, a packed v2 pair (one
column-parallel, one row-parallel) and a QAT tree; the dense llama's
restored blocks serve through `TPEngine(sharded=True)`.  The leaves are held to JAX's trees after `from_jax_params`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_orbax_worker import same_bits, save_restore
from pb_llm_tpu.models import llama as jllama
from pb_llm_tpu_torch.interop import from_jax_params
from pb_llm_tpu_torch.models import llama as tllama
from pb_llm_tpu_torch.models.registry import FAMILIES
from pb_llm_tpu_torch.parallel.mesh import run_ranks
from pb_llm_tpu_torch.train import qat as ttq
from pb_llm_tpu_torch.utils.orbax_ckpt import restore_sharded, save_sharded
from tests.test_pbw_v2 import _make_v2

torch.set_num_threads(2)


def _tcfg(jcfg):
    return tllama.LlamaConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "max_position_embeddings")})


def _np(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def trees():
    jcfg = jllama.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                              num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=8,
                              max_position_embeddings=64)
    dense = _np(jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    _, _, col, _, _ = _make_v2(oc=256, ic=256, col_tile=0, bias=True)
    _, _, row, _, _ = _make_v2(oc=256, ic=256, col_tile=0, bias=True, seed=1)
    v2 = {"layers": [{"up_proj": _np(col), "down_proj": _np(row)}]}
    qat = ttq.replace_linears(_np(jllama.init_params(jcfg, jax.random.PRNGKey(0))),
                              FAMILIES["llama"], ttq.QATConfig())
    # the v2 entry also carries JAX's column-parallel leaf
    return {"dense": (dense, False, _tcfg(jcfg)), "v2": (v2, False, col), "qat": (qat, True)}


@pytest.fixture(scope="module")
def world(trees, tmp_path_factory):
    root = tmp_path_factory.mktemp("dcp")
    placed = str(root / "placed")
    save_sharded(placed, {"w": torch.arange(64.0 * 16).reshape(64, 16)})
    cases = {k: v[:2] for k, v in trees.items()}
    return root, run_ranks(save_restore, 4, (str(root), cases, placed, trees["dense"][2]), "cpu")


def test_dense_tree_roundtrip(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4), "nested": {"b": torch.ones(5, dtype=torch.int32)}}
    save_sharded(str(tmp_path / "ck"), tree)
    got = restore_sharded(str(tmp_path / "ck"), tree)
    assert same_bits(got, tree)


def test_packed_v2_tree_roundtrip(tmp_path, trees):
    p = trees["v2"][2]
    tree = {"layer0": {"up_proj": _np(p)}}
    save_sharded(str(tmp_path / "ck"), tree)
    got = restore_sharded(str(tmp_path / "ck"), tree)
    q = got["layer0"]["up_proj"]
    assert q.ic == p.ic and q.oc == p.oc and q.col_tile == p.col_tile
    assert same_bits(got, tree)
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if isinstance(v, jnp.ndarray):
            # the port keeps uint32 words as int32 bits: compare the bytes
            assert np.array_equal(getattr(q, f.name).numpy().view(np.uint8),
                                  np.ascontiguousarray(np.asarray(v)).view(np.uint8)), f.name


def test_sharded_restore_placement(world):
    """A whole [64, 16] tensor restored under P(None, "tp") at tp = 4: each
    rank gets its four columns."""
    _, ranks = world
    assert all(r["placed"] for r in ranks)


def test_restored_blocks_serve_through_tp_engine(world):
    """`TPEngine(sharded=True)` on the dense llama's restored tp = 4 blocks
    serves the never-saved tree's greedy tokens, on every rank."""
    _, ranks = world
    for r in ranks:
        never, restored = r["served"]
        assert restored == never and len(never) == 5
    assert all(r["served"] == ranks[0]["served"] for r in ranks)


@pytest.mark.parametrize("name", ["dense", "v2", "qat"])
def test_tp4_save_restores_at_tp2_whole_and_in_one_process(world, trees, name):
    root, ranks = world
    for r in ranks:
        assert r[name] == {"tp4": True, "tp2": True, "whole": True}
    tree = trees[name][0]
    got = restore_sharded(str(root / name), tree)
    assert same_bits(got, tree)
    if name == "qat":
        lin = got["layers"][0]["q_proj"]
        assert lin.method == "xnor_outlier" and lin.weight.requires_grad
