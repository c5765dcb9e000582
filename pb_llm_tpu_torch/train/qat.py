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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import no_tf32
from ..models.linear import apply_linear
from ..models.registry import Family
from ..ops import kernel_config as _kc
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
                   pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Labels are the inputs shifted by one; pad positions are left out of
    the loss (attention does not mask them, as in the JAX package)."""
    lg = logits[:, :-1].float()
    tg = input_ids[:, 1:]
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tg[..., None])[..., 0]
    nll = logz - gold
    if pad_mask is not None:
        m = pad_mask[:, 1:].float()
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
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


def make_train_step(cfg, fam: Family, qcfg: QATConfig, optimizer, scheduler) -> Callable:
    """``step(params, batch) -> loss``: one optimizer update.  ``batch``:
    {"input_ids": [B, T], optional "attention_mask": [B, T]} tensors on the
    params' device; with ``grad_accum`` > 1 the leading dimension splits
    into that many micro-batches whose gradients are summed and divided by
    ``grad_accum``."""
    train = [p for g in optimizer.param_groups for p in g["params"]]

    def loss_of(params, batch):
        logits = _forward_remat(params, batch["input_ids"], cfg, fam, qcfg.remat)
        return causal_lm_loss(logits, batch["input_ids"], batch.get("attention_mask"))

    def step(params, batch):
        with no_tf32():
            return _step(params, batch)

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
) -> Tuple[Dict[str, Any], list]:
    """Run qcfg.train_steps steps over ``batches``; the QAT weights update in
    place.  Returns (params, per-step losses)."""
    freeze_base(params)
    optimizer, scheduler = make_optimizer(qcfg, params)
    step = make_train_step(cfg, fam, qcfg, optimizer, scheduler)
    device = params["embed_tokens"].device
    losses = []
    it = iter(batches)
    for i in range(qcfg.train_steps):
        batch = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in next(it).items()}
        losses.append(float(step(params, batch)))
        if log:
            log(i, losses[-1])
    return params, losses
