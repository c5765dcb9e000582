"""The rank side of `tests/test_torch_qat_sharded.py`: each case trains its
tree for a few steps on a (dp, tp) mesh of gloo ranks (`train.qat` under a
mesh) and hands back the losses, the tree gathered back, and each rank's
block and Adam-moment sizes.  This module imports the port, torch and numpy
only: the rank processes import no JAX.

A case is plain data: {"family": "llama" | "opt", "cfg": the port's
config, "params": the port's unsharded tree, "qcfg": QATConfig kwargs,
"batches": [{"input_ids": np[B, T], ...}, ...], "fsdp": bool}.
"""

from __future__ import annotations

import copy

import torch

DP, TP = 2, 4


def train_case(case, mesh=None):
    """Train ``case`` for as many steps as it has batches: on ``mesh`` (this
    rank's blocks) or, without one, on the whole tree.  Returns (losses, the
    whole trained tree (gathered on a mesh), the QAT leaves' local sizes
    {layer/name: (weight, mask, exp_avg, exp_avg_sq numels)})."""
    from pb_llm_tpu_torch.models.registry import FAMILIES
    from pb_llm_tpu_torch.parallel import sharding
    from pb_llm_tpu_torch.quant.qat import QATLinear
    from pb_llm_tpu_torch.train import qat as tq

    fam = FAMILIES[case["family"]]
    qcfg = tq.QATConfig(**case["qcfg"])
    params = tq.replace_linears(copy.deepcopy(case["params"]), fam, qcfg)
    specs = None
    if mesh is not None:
        specs = sharding.param_specs(params, fam.name, mesh, fsdp=case["fsdp"])
        params = sharding.shard_params(params, mesh, fam.name, fsdp=case["fsdp"])
    tq.freeze_base(params)
    opt, sched = tq.make_optimizer(qcfg, params)
    step = tq.make_train_step(case["cfg"], fam, qcfg, opt, sched, mesh, specs)
    losses = [float(step(params, {k: torch.as_tensor(v) for k, v in b.items()}))
              for b in case["batches"]]
    sizes = {}
    for i, lp in enumerate(params["layers"]):
        for n, v in lp.items():
            if isinstance(v, QATLinear):
                st = opt.state[v.weight]
                sizes[f"{i}/{n}"] = (v.weight.numel(), v.outlier_mask.numel(),
                                     st["exp_avg"].numel(), st["exp_avg_sq"].numel())
    if mesh is not None:
        params = sharding.gather_params(params, mesh, specs)
    return losses, params, sizes


def snapshot(params):
    """{layer/name/field: numpy} of every QAT leaf's weight, mask and bias."""
    from pb_llm_tpu_torch.quant.qat import QATLinear

    out = {}
    for i, lp in enumerate(params["layers"]):
        for n, v in lp.items():
            if isinstance(v, QATLinear):
                out[f"{i}/{n}/weight"] = v.weight.detach().numpy().copy()
                out[f"{i}/{n}/mask"] = v.outlier_mask.numpy().copy()
                if v.bias is not None:
                    out[f"{i}/{n}/bias"] = v.bias.detach().numpy().copy()
    return out


def row_parallel_linear(lin, x, g, mesh=None):
    """A row-parallel QAT linear's output and weight gradient for the loss
    sum(y · g): on ``mesh`` each rank takes its ic block of the weight, mask
    and x (the row statistics all-reduced over tp), the partial outputs
    summed by `reduce_from_tp`, the gradient gathered back; without one, the
    whole layer."""
    import dataclasses

    from pb_llm_tpu_torch.parallel import collectives as coll
    from pb_llm_tpu_torch.quant.qat import apply_qat_linear

    lin = dataclasses.replace(lin, weight=lin.weight.detach().clone().requires_grad_(True))
    if mesh is None:
        y = apply_qat_linear(lin, x)
        (y * g).sum().backward()
        return y.detach().numpy(), lin.weight.grad.numpy()
    n = lin.weight.shape[1] // mesh.tp
    cols = slice(mesh.coord("tp") * n, (mesh.coord("tp") + 1) * n)
    local = dataclasses.replace(
        lin, bias=None, weight=lin.weight.detach()[:, cols].clone().requires_grad_(True),
        outlier_mask=lin.outlier_mask[:, cols])
    y = coll.reduce_from_tp(apply_qat_linear(local, x[:, cols], group=mesh.tp_group,
                                             split_ic=True), mesh)
    if lin.bias is not None:
        y = y + lin.bias
    (y * g).sum().backward()
    grad = coll._gather_dim(local.weight.grad, 1, mesh.tp_group)
    return y.detach().numpy(), grad.numpy()


def run_cases(rank: int, cases: dict, layers: dict) -> dict:
    """Every case on the (DP, TP) mesh: rank 0 returns the losses and the
    gathered tree, every rank its losses and local sizes; then every
    row-parallel layer case (``layers``: name -> (QATLinear, x, g))."""
    from pb_llm_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(dp=DP, tp=TP)
    out = {}
    for name, case in cases.items():
        losses, params, sizes = train_case(case, mesh)
        out[name] = {"losses": losses, "sizes": sizes,
                     "tree": snapshot(params) if rank == 0 else None}
    for name, (lin, x, g) in layers.items():
        out[name] = row_parallel_linear(lin, x, g, mesh)
    return out
