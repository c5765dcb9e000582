"""Pipeline parallelism: a GPipe-style microbatched forward over a ``pp``
mesh (port of `pb_llm_tpu/parallel/pipeline.py`).

The stacked decoder (`models.stacking`) is cut on its layer axis into
``pp`` stages, one a rank of a 1-D mesh (`parallel.mesh.make_pp_mesh`); a
stage keeps only its slice (`stacking.take_layers`).  Microbatches flow
stage to stage by `parallel.collectives.ppermute`.

Schedule: ``n_micro + pp - 1`` steps.  At step s stage k runs microbatch
s - k when it exists: stage 0 embeds it, every stage runs its layers, the
activations move one stage on, and the last stage writes norm + lm_head
logits (f32) into its output.  The output is summed over the stages (the
others hold zeros, JAX's `psum`), so every rank returns the whole logits.
Bubble steps skip their compute (the port is eager), but every rank takes
part in every send/recv of the schedule.

Scope: batch / eval forwards of the llama family (prefill, windowed
scoring), as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..models import llama as mllama
from ..models import stacking
from .collectives import all_sum, ppermute


def stage_params(params: Dict[str, Any], mesh, axis: str = "pp") -> Dict[str, Any]:
    """This rank's stage of a stacked tree: its slice of the layers
    (`stacking.take_layers`), the rest as it is.  Raises ValueError on
    unstacked params or a layer count the axis does not divide."""
    if not stacking.is_stacked(params):
        raise ValueError("pipeline_forward needs stacked params (stack_layers)")
    n_stages = mesh.shape[axis]
    total = params["layer_range"][2] if "layer_range" in params else params["num_layers"]
    if total % n_stages:
        raise ValueError(f"{total} layers not divisible by {axis}={n_stages}")
    per = total // n_stages
    lo = mesh.coord(axis) * per
    if "layer_range" in params:
        if params["layer_range"][:2] != (lo, lo + per):
            raise ValueError(f"params hold layers {params['layer_range'][:2]}, stage "
                             f"{mesh.coord(axis)} runs [{lo}, {lo + per})")
        return params
    return stacking.take_layers(params, lo, lo + per)


def pipeline_forward(params: Dict[str, Any], input_ids: torch.Tensor, cfg, mesh,
                     n_micro: int, axis: str = "pp") -> torch.Tensor:
    """input_ids [B, T] → logits [B, T, V] f32 on every rank, the layers
    pipelined over ``axis``.  ``params``: a stacked tree
    (`stacking.stack_layers`), whole or this stage's slice
    (`stage_params`).  B must divide by ``n_micro``."""
    stage = stage_params(params, mesh, axis)
    n_stages, k = mesh.shape[axis], mesh.coord(axis)
    group = getattr(mesh, "group", None)
    b, t = input_ids.shape
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    bm = b // n_micro
    embed = stage["embed_tokens"]
    device = embed.device
    ids = input_ids.to(device).reshape(n_micro, bm, t)
    act = torch.zeros((bm, t, embed.shape[1]), dtype=embed.dtype, device=device)
    cos, sin = mllama.layer_rope(cfg, act, 0)
    outs = None
    with torch.inference_mode():
        for s in range(n_micro + n_stages - 1):
            mi = s - k  # the microbatch at this stage now
            if 0 <= mi < n_micro:
                x = embed[ids[mi]] if k == 0 else act
                h = stacking.run_layers(
                    stage, x, lambda lp, hh, c: mllama.decoder_layer(lp, hh, cfg, cos, sin))
                if k == n_stages - 1:
                    logits = mllama.final_logits(stage, h, cfg).float()
                    if outs is None:
                        outs = torch.zeros((n_micro, *logits.shape), dtype=torch.float32,
                                           device=device)
                    outs[mi] = logits
            else:  # a bubble: pass zeros on
                h = torch.zeros_like(act)
            act = ppermute(h, group)
        if outs is None:
            outs = torch.zeros((n_micro, bm, t, cfg.vocab_size), dtype=torch.float32,
                               device=device)
        outs = all_sum(outs, group)
    return outs.reshape(b, t, -1)
