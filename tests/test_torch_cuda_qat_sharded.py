"""QAT across ranks (`train.qat` under a mesh, `parallel.collectives`'
autograd collectives) on the card.

Every test carries the `cuda` marker and skips without a card; the file
imports no JAX, so it runs on the card's machine without the repository's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_qat_sharded.py

The card's machine has one card: a 1-rank NCCL group's sharded step (dp =
tp = 1 through the mesh path: the local config, the training linear_fn,
the global loss count, the all-reduced binary scale over a group of one)
equals the plain card step bit for bit, with and without fsdp.  The
collectives run forward and backward on CUDA tensors: over the 1-rank
NCCL group (the autograd functions themselves, past the one-rank
shortcut) and over two gloo ranks sharing the card (the reduce-scatter
crossing through the host), each against its plain version.
"""

import copy

import numpy as np
import pytest
import torch

from pb_llm_tpu_torch.data.synthetic import synthetic_model
from pb_llm_tpu_torch.models.registry import FAMILIES
from pb_llm_tpu_torch.parallel import collectives as coll
from pb_llm_tpu_torch.parallel import mesh as pmesh
from pb_llm_tpu_torch.parallel import sharding
from pb_llm_tpu_torch.train import qat as tq

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _train(params, cfg, mesh, fsdp):
    fam = FAMILIES["llama"]
    qcfg = tq.QATConfig(train_steps=4, learning_rate=1e-3)
    qp = tq.replace_linears(copy.deepcopy(params), fam, qcfg)
    specs = None
    if mesh is not None:
        specs = sharding.param_specs(qp, fam.name, mesh, fsdp=fsdp)
        qp = sharding.shard_params(qp, mesh, fam.name, fsdp=fsdp)
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(2, 48)),
                "attention_mask": (rng.random((2, 48)) > 0.1).astype(np.int64)}
               for _ in range(qcfg.train_steps)]
    qp, losses = tq.train(qp, cfg, fam, qcfg, iter(batches), mesh=mesh, specs=specs)
    return losses, [v.weight.detach().cpu() for lp in qp["layers"] for v in lp.values()
                    if isinstance(v, tq.QATLinear)]


@pytest.mark.cuda
def test_nccl_one_rank_sharded_step_equals_plain_step(cuda):
    import torch.distributed as dist

    cfg, params = synthetic_model("llama", device=cuda)
    plain = _train(params, cfg, None, False)
    assert pmesh.multihost_initialize(pmesh.free_address(), 1, 0, device="cuda") == "nccl"
    try:
        mesh = pmesh.make_mesh(dp=1, tp=1)
        sharded = [_train(params, cfg, mesh, fsdp) for fsdp in (False, True)]
    finally:
        dist.destroy_process_group()
    for losses, weights in sharded:
        assert losses == plain[0]
        assert all(torch.equal(a, b) for a, b in zip(weights, plain[1]))


def _inputs(device):
    g = torch.Generator().manual_seed(5)
    return [torch.randn(6, 8, generator=g).to(device) for _ in range(2)]


def _collectives(mesh, xs, rank: int):
    """(forward, grad) of fsdp_gather over dp along dim 0 and of
    reduce_from_tp, for the loss sum(out · w) with a fixed w (multiples of
    1/8: the same bits on the card and on the host)."""
    out = {}
    for name, fn in (("fsdp_gather", lambda t: coll.fsdp_gather(t, 0, mesh)),
                     ("reduce_from_tp", lambda t: coll.reduce_from_tp(t, mesh))):
        x = xs[rank].clone().requires_grad_(True)
        y = fn(x)
        w = torch.arange(y.numel(), dtype=y.dtype, device=y.device).reshape(y.shape) / 8
        (y * w).sum().backward()
        out[name] = (y.detach().cpu(), x.grad.cpu())
    return out


def _gloo_pair_rank(rank: int) -> dict:
    """A rank of the 2-rank gloo pair on the card: dp = 2 for fsdp_gather,
    tp = 2 for reduce_from_tp."""
    dev = torch.device("cuda", 0)
    xs = _inputs(dev)
    return {"dp": _collectives(pmesh.make_mesh(dp=2, tp=1), xs, rank)["fsdp_gather"],
            "tp": _collectives(pmesh.make_mesh(dp=1, tp=2), xs, rank)["reduce_from_tp"]}


@pytest.mark.cuda
def test_collectives_forward_backward_equal_plain_versions(cuda):
    """Two gloo ranks sharing the card: fsdp_gather is the concatenation of
    the ranks' blocks, its gradient the sum of the ranks' gradients of the
    rank's rows (reduce-scatter); reduce_from_tp the sum, its gradient the
    output's.  Over the 1-rank NCCL group the autograd functions themselves
    are the identity forward and backward."""
    import torch.distributed as dist

    xs = _inputs("cpu")
    full = torch.cat(xs, 0)
    w_full = torch.arange(full.numel(), dtype=full.dtype).reshape(full.shape) / 8
    w_sum = torch.arange(xs[0].numel(), dtype=full.dtype).reshape(xs[0].shape) / 8
    ranks = pmesh.run_ranks(_gloo_pair_rank, 2, (), device="cuda")
    for r, got in enumerate(ranks):
        y, g = got["dp"]
        assert torch.equal(y, full)
        # both ranks' losses weight the gathered rows alike: the gradient of
        # rank r's rows is the sum over the two ranks of w's rows
        assert torch.equal(g, 2 * w_full[r * 6:(r + 1) * 6])
        y, g = got["tp"]
        assert torch.equal(y, xs[0] + xs[1]) and torch.equal(g, w_sum)
    assert pmesh.multihost_initialize(pmesh.free_address(), 1, 0, device="cuda") == "nccl"
    try:
        group = dist.group.WORLD
        x = _inputs(cuda)[0].requires_grad_(True)
        for fn in (lambda t: coll._GatherDim.apply(t, 0, group, True),
                   lambda t: coll._GatherDim.apply(t, 1, group, False),
                   lambda t: coll._ReduceFromTP.apply(t, group),
                   lambda t: coll._CopyToTP.apply(t, group),
                   lambda t: coll._AllReduceSum.apply(t, group)):
            x.grad = None
            y = fn(x)
            w = torch.randn_like(y)
            (y * w).sum().backward()
            assert torch.equal(y, x) and torch.equal(x.grad, w)
    finally:
        dist.destroy_process_group()
