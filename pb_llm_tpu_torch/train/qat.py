"""QAT fine-tuning loop (port of `pb_llm_tpu/train/qat.py`): the reference's
HF Trainer run (`qat/run_qat.py:83-148`) with torch autograd and AdamW.

  * every decoder linear becomes a partially-binarized STE layer
    (`quant.qat.QATLinear`), masks fixed before training, master weights
    frozen to sim-8bit;
  * only the QAT weights and biases train; every other tensor (embeddings,
    norms, the head) has ``requires_grad=False`` and stays bit-unchanged;
  * AdamW (β 0.9 / 0.999, eps 1e-8, ``weight_decay``) under optax's
    `warmup_cosine_decay_schedule(0, lr, max(int(steps·warmup_frac), 1),
    steps)`, read before its count increments as optax does, so the first
    update runs at lr 0; causal-LM loss with pad positions left out;
  * remat: `torch.utils.checkpoint` per layer, non-reentrant (layer 0's
    input comes from the frozen embedding and requires no grad; the
    reentrant variant would then give the QAT weights inside no gradient).

The forward runs attention as the masked softmax (``attention="xla"``), the
arm JAX's trainer takes: the flash kernel has no backward, in either
package, and raises under grad (`ops.flash_attention`).  Matmuls are f32
with TF32 off (`no_tf32`).

JAX's `trainable_labels` (optax's train / freeze partition) has no
counterpart: AdamW here takes the QAT weights and biases alone, and every
other tensor is frozen by ``requires_grad=False`` (`freeze_base`).

Across ranks (``mesh``, the (dp, tp) mesh of `parallel.mesh`; ``specs``,
the spec tree `parallel.sharding.shard_params` placed the blocks by, i.e.
`param_specs` of the global tree).  JAX hands `shard_params`' placements
to its jitted step and GSPMD inserts the collectives; here each rank runs
its block of the same step, with the collectives written out:

  * the layers run the local config (`runtime.tp_engine._local_cfg`: the
    rank's heads); a column-parallel QAT linear is `copy_to_tp`, then the
    local fake-quant matmul; a row-parallel one the local matmul, then
    `reduce_from_tp`, then its bias; the statistics of a split weight are
    all-reduced over tp (`quant.qat`);
  * a vocab-parallel lm_head's logits go through `gather_from_tp` (where
    the specs replicated it there is no gather);
  * a leaf split over dp by ``fsdp`` is gathered where it is used, inside
    the layer (`fsdp_gather`: its gradient is reduce-scattered, summed over
    dp), and so is a frozen one; remat recomputes the gathers and every
    other collective, in the same order on every rank;
  * each micro-batch (the global batch split first, as JAX's reshape does)
    is split over dp by rows; its loss is normalised by its GLOBAL count
    (its mask sum all-reduced over dp, or its B·(T−1) without a mask), as
    JAX's `causal_lm_loss` over the whole micro-batch;
  * the gradients of the trainable leaves not split over dp are summed
    over dp; AdamW and LambdaLR run on the local blocks, so the moments are
    sharded as the weights are (ZeRO-3 under fsdp).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from .. import no_tf32
from ..models.linear import apply_linear
from ..models.registry import Family
from ..ops import kernel_config as _kc
from ..parallel import collectives as coll
from ..parallel.mesh import Mesh
from ..parallel.sharding import COL_PARALLEL
from ..quant import qat as qat_layers
from ..quant.qat import QATLinear, apply_qat_linear


@dataclasses.dataclass(frozen=True)
class QATConfig:
    binarization_method: str = "xnor_outlier"
    outlier_fraction: float = 0.1
    train_steps: int = 1000
    learning_rate: float = 1e-4
    warmup_frac: float = 0.05
    weight_decay: float = 0.0
    grad_accum: int = 1
    remat: bool = True
    # the reference's uint8 WRAP when freezing the sim-8bit master
    # (quant.qat.weight_quant_8bit wrap_compat); default the clamp fix
    wrap_compat_8bit: bool = False


def replace_linears(
    params: Dict[str, Any],
    fam: Family,
    qcfg: QATConfig,
    gptq_masks: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, Any]:
    """Swap every decoder linear for a QATLinear, masks made eagerly.
    Returns a new tree sharing the unchanged tensors."""
    params = dict(params)
    new_layers = []
    for i, lp in enumerate(params["layers"]):
        lp = dict(lp)
        for n in fam.linear_names:
            lin = lp[n]
            gm = (gptq_masks or {}).get(f"layer_{i}/{n}")
            lp[n] = qat_layers.make_qat_linear(
                lin["w"].T, lin.get("b"), qcfg.outlier_fraction,
                method=qcfg.binarization_method, gptq_mask=gm,
                wrap_compat=qcfg.wrap_compat_8bit,
            )
        new_layers.append(lp)
    params["layers"] = new_layers
    return params


def qat_linears(params: Dict[str, Any]) -> List[QATLinear]:
    return [v for lp in params["layers"] for v in lp.values() if isinstance(v, QATLinear)]


def mean_bits_report(params: Dict[str, Any], fam: Family) -> float:
    """Mean effective bit-width over all QAT linears."""
    tot_bits, tot_params = 0.0, 0
    for q in qat_linears(params):
        tot_bits += qat_layers.mean_effective_bits(q) * q.weight.numel()
        tot_params += q.weight.numel()
    return tot_bits / max(tot_params, 1)


def qat_linear_fn(name, lin, x):
    if isinstance(lin, QATLinear):
        return apply_qat_linear(lin, x)
    return apply_linear(lin, x)


def causal_lm_loss(logits: torch.Tensor, input_ids: torch.Tensor,
                   pad_mask: Optional[torch.Tensor] = None,
                   count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Labels are the inputs shifted by one; pad positions are left out of
    the loss (attention does not mask them, as in the JAX package).  With
    ``count`` (a dp rank's rows of a micro-batch) the sum of its losses over
    the micro-batch's global count of positions."""
    lg = logits[:, :-1].float()
    tg = input_ids[:, 1:]
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tg[..., None])[..., 0]
    nll = logz - gold
    if pad_mask is not None:
        m = pad_mask[:, 1:].float()
        total = torch.sum(nll * m)
        return total / torch.clamp(torch.sum(m) if count is None else count, min=1.0)
    if count is not None:
        return torch.sum(nll) / count
    return torch.mean(nll)


def _forward_remat(params, ids, cfg, fam: Family, remat: bool) -> torch.Tensor:
    """The QAT forward, attention on the masked softmax: the config is
    entered inside each layer, so remat's recompute in the backward takes
    the same arm."""
    x = fam.embed(params, ids, cfg)
    kcfg = dataclasses.replace(_kc.current(), attention="xla")

    def layer(lp, h):
        with _kc.use_kernels(kcfg):
            return fam.decoder_layer(lp, h, cfg, linear_fn=qat_linear_fn)[0]

    for lp in params["layers"]:
        x = checkpoint(layer, lp, x, use_reentrant=False) if remat else layer(lp, x)
    return fam.head(params, x, cfg)


def _axis_dim(spec, axis: str) -> Optional[int]:
    """The dimension ``spec`` splits over ``axis``, or None."""
    if not isinstance(spec, tuple):
        return None
    return next((d for d, ax in enumerate(spec) if ax == axis), None)


def _gather_dp(v, spec, mesh: Mesh):
    """``v`` (a tensor, a QATLinear, a dense dict) with each dimension its
    spec splits over dp gathered (`collectives.fsdp_gather`; a bool mask
    crosses as uint8)."""
    if v is None or spec is None or mesh.dp == 1:
        return v
    if isinstance(v, torch.Tensor):
        d = _axis_dim(spec, "dp")
        if d is None:
            return v
        if v.dtype == torch.bool:
            return coll.fsdp_gather(v.to(torch.uint8), d, mesh).bool()
        return coll.fsdp_gather(v, d, mesh)
    if isinstance(v, QATLinear):
        return dataclasses.replace(v, weight=_gather_dp(v.weight, spec.weight, mesh),
                                   outlier_mask=_gather_dp(v.outlier_mask, spec.outlier_mask,
                                                           mesh))
    if isinstance(v, dict):
        return {k: _gather_dp(x, spec.get(k), mesh) for k, x in v.items()}
    return v


def _tp_split(spec) -> bool:
    """Whether a leaf's spec (a QATLinear's, a dense dict's) splits its
    weight over tp."""
    if isinstance(spec, QATLinear):
        spec = spec.weight
    elif isinstance(spec, dict):
        spec = spec.get("w")
    return _axis_dim(spec, "tp") is not None


def _mesh_linear_fn(mesh: Mesh, lspec: Dict[str, Any]) -> Callable:
    """The training ``linear_fn`` of a rank's layer: a QAT linear its spec
    splits over tp runs its Megatron half (see the module docstring); any
    other linear runs whole."""
    def fn(name, lin, x):
        if not _tp_split(lspec.get(name)):
            return qat_linear_fn(name, lin, x)
        if name in COL_PARALLEL:
            return apply_qat_linear(lin, coll.copy_to_tp(x, mesh), group=mesh.tp_group)
        y = apply_qat_linear(dataclasses.replace(lin, bias=None), x, group=mesh.tp_group,
                             split_ic=True)
        y = coll.reduce_from_tp(y, mesh)
        return y if lin.bias is None else y + lin.bias.to(y.dtype)

    return fn


def _forward_mesh(params, ids, cfg, fam: Family, remat: bool, mesh: Mesh,
                  specs: Dict[str, Any]) -> torch.Tensor:
    """A rank's share of the QAT forward (``ids``: its dp rows): logits over
    the whole vocab, the same on every tp rank of its dp row."""
    from ..runtime.tp_engine import _local_cfg

    lcfg = _local_cfg(cfg, fam, mesh.tp)
    top = {k: (v if k == "layers" else _gather_dp(v, specs.get(k), mesh))
           for k, v in params.items()}
    x = fam.embed(top, ids, cfg)
    kcfg = dataclasses.replace(_kc.current(), attention="xla")

    def layer(lspec, lp, h):
        lp = {n: _gather_dp(v, lspec.get(n), mesh) for n, v in lp.items()}
        with _kc.use_kernels(kcfg):
            return fam.decoder_layer(lp, h, lcfg, linear_fn=_mesh_linear_fn(mesh, lspec))[0]

    for lp, lspec in zip(params["layers"], specs["layers"]):
        fn = functools.partial(layer, lspec)
        x = checkpoint(fn, lp, x, use_reentrant=False) if remat else fn(lp, x)
    vocab_parallel = specs.get("lm_head") is not None and _tp_split(specs["lm_head"])
    if vocab_parallel:
        x = coll.copy_to_tp(x, mesh)
    logits = fam.head(top, x, cfg)
    return coll.gather_from_tp(logits, mesh) if vocab_parallel else logits


def lr_schedule(qcfg: QATConfig) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, steps), end value 0,
    exponent 1, evaluated in Python floats."""
    peak = qcfg.learning_rate
    warmup = max(int(qcfg.train_steps * qcfg.warmup_frac), 1)
    decay = qcfg.train_steps - warmup
    if not decay > 0:  # optax's cosine_decay_schedule refuses it too
        raise ValueError(f"the cosine decay needs train_steps > warmup steps ({warmup}), got "
                         f"train_steps={qcfg.train_steps}")

    def schedule(count: int) -> float:
        if count < warmup:  # linear_schedule(0, peak, warmup)
            return (0.0 - peak) * (1 - count / warmup) + peak
        c = min(count - warmup, decay)
        return peak * (0.5 * (1 + math.cos(math.pi * c / decay)))

    return schedule


def make_optimizer(qcfg: QATConfig, params: Dict[str, Any]):
    """(AdamW over the QAT weights and biases, its LambdaLR): optax's adamw
    settings passed explicitly, the schedule's count read before the
    update, so the first update runs at lr 0."""
    train = [t for q in qat_linears(params) for t in (q.weight, q.bias) if t is not None]
    opt = torch.optim.AdamW(train, lr=qcfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=qcfg.weight_decay)
    schedule = lr_schedule(qcfg)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: schedule(count) / qcfg.learning_rate)
    return opt, sched


def freeze_base(params: Any) -> None:
    """requires_grad=False on every tensor outside the QAT linears."""
    if isinstance(params, QATLinear):
        return
    if isinstance(params, torch.Tensor):
        params.requires_grad_(False)
    elif isinstance(params, dict):
        for v in params.values():
            freeze_base(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            freeze_base(v)


def _dp_rows(v: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This dp rank's rows of a (micro-)batch tensor."""
    n = v.shape[0] // mesh.dp
    return v.narrow(0, mesh.coord("dp") * n, n)


def _replicated_over_dp(params, specs) -> List[torch.Tensor]:
    """The trainable tensors whose spec does not split them over dp: their
    gradients are summed over dp after the backward."""
    out = []
    for lp, lspec in zip(params["layers"], specs["layers"]):
        for n, v in lp.items():
            if isinstance(v, QATLinear):
                out += [t for t, sp in ((v.weight, lspec[n].weight), (v.bias, lspec[n].bias))
                        if t is not None and _axis_dim(sp, "dp") is None]
    return out


def make_train_step(cfg, fam: Family, qcfg: QATConfig, optimizer, scheduler,
                    mesh: Optional[Mesh] = None,
                    specs: Optional[Dict[str, Any]] = None) -> Callable:
    """``step(params, batch) -> loss``: one optimizer update.  ``batch``:
    {"input_ids": [B, T], optional "attention_mask": [B, T]} tensors on the
    params' device; with ``grad_accum`` > 1 the leading dimension splits
    into that many micro-batches whose gradients are summed and divided by
    ``grad_accum``.  With ``mesh`` (and the ``specs`` the rank's blocks were
    placed by), ``params`` are this rank's blocks and ``batch`` the global
    batch, the same on every rank; the loss returned is the global one."""
    train = [p for g in optimizer.param_groups for p in g["params"]]
    if mesh is not None and specs is None:
        raise ValueError("make_train_step: a mesh needs the spec tree the blocks were placed by "
                         "(sharding.param_specs of the global tree)")

    def loss_of(params, batch, count=None):
        if mesh is None:
            logits = _forward_remat(params, batch["input_ids"], cfg, fam, qcfg.remat)
        else:
            logits = _forward_mesh(params, batch["input_ids"], cfg, fam, qcfg.remat, mesh, specs)
        return causal_lm_loss(logits, batch["input_ids"], batch.get("attention_mask"), count)

    def step(params, batch):
        with no_tf32():
            return _step(params, batch) if mesh is None else _mesh_step(params, batch)

    def _step(params, batch):
        optimizer.zero_grad(set_to_none=True)
        ga = qcfg.grad_accum
        if ga > 1:
            loss = 0.0
            for i in range(ga):
                micro = {k: v.reshape(ga, v.shape[0] // ga, *v.shape[1:])[i]
                         for k, v in batch.items()}
                micro_loss = loss_of(params, micro)
                micro_loss.backward()
                loss = loss + micro_loss.detach()
            loss = loss / ga
            for p in train:
                if p.grad is not None:
                    p.grad.div_(ga)
        else:
            loss = loss_of(params, batch)
            loss.backward()
            loss = loss.detach()
        optimizer.step()
        scheduler.step()
        return loss

    def _mesh_step(params, batch):
        optimizer.zero_grad(set_to_none=True)
        ga = qcfg.grad_accum
        rows = batch["input_ids"].shape[0]
        if rows % (ga * mesh.dp):
            raise ValueError(f"a batch of {rows} rows does not split into grad_accum={ga} "
                             f"micro-batches over dp={mesh.dp}")
        loss = 0.0
        for i in range(ga):
            micro = {k: _dp_rows(v.reshape(ga, rows // ga, *v.shape[1:])[i], mesh)
                     for k, v in batch.items()}
            mask = micro.get("attention_mask")
            if mask is not None:
                count = mask[:, 1:].float().sum()
                if mesh.dp > 1:
                    dist.all_reduce(count, group=mesh.dp_group)
            else:
                t = micro["input_ids"].shape[1]
                count = torch.tensor(float(rows // ga * (t - 1)),
                                     device=micro["input_ids"].device)
            micro_loss = loss_of(params, micro, count)
            micro_loss.backward()
            loss = loss + micro_loss.detach()
        if mesh.dp > 1:
            for p in _replicated_over_dp(params, specs):
                if p.grad is not None:
                    dist.all_reduce(p.grad, group=mesh.dp_group)
            dist.all_reduce(loss, group=mesh.dp_group)
        if ga > 1:
            loss = loss / ga
            for p in train:
                if p.grad is not None:
                    p.grad.div_(ga)
        optimizer.step()
        scheduler.step()
        return loss

    return step


def export_dense(params: Dict[str, Any], fam: Family) -> Dict[str, Any]:
    """Every QAT layer back to a dense leaf (`quant.qat.to_dense`), for
    `utils.checkpoint.save_dense_checkpoint` / `models.hf_export`."""
    params = dict(params)
    new_layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        for n in fam.linear_names:
            if isinstance(lp[n], QATLinear):
                lp[n] = qat_layers.to_dense(lp[n])
        new_layers.append(lp)
    params["layers"] = new_layers
    return params


def train(
    params: Dict[str, Any],
    cfg,
    fam: Family,
    qcfg: QATConfig,
    batches,                       # iterable of {"input_ids": np[B, T], ...}
    log: Optional[Callable[[int, float], None]] = None,
    mesh: Optional[Mesh] = None,
    specs: Optional[Dict[str, Any]] = None,
) -> Tuple[Dict[str, Any], list]:
    """Run qcfg.train_steps steps over ``batches``; the QAT weights update in
    place.  Returns (params, per-step losses).  With ``mesh`` and ``specs``
    (see the module docstring) ``params`` are this rank's blocks, every rank
    iterates the same global batches and the losses are the global ones."""
    freeze_base(params)
    optimizer, scheduler = make_optimizer(qcfg, params)
    step = make_train_step(cfg, fam, qcfg, optimizer, scheduler, mesh, specs)
    device = params["embed_tokens"].device
    losses = []
    it = iter(batches)
    for i in range(qcfg.train_steps):
        batch = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in next(it).items()}
        losses.append(float(step(params, batch)))
        if log:
            log(i, losses[-1])
    return params, losses
