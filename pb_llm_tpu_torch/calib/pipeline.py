"""Layer-by-layer PTQ driver (port of `pb_llm_tpu/calib/pipeline.py`, the
reference's `quant_sequential`, `gptq_pb/run.py:34-189`):

  1. embed all calibration windows → layer-0 inputs;
  2. per decoder layer:
     a. a capture pass with the layer's original weights folds each
        linear's input Hessian H = (2/n)·Σ XᵀX, one XᵀX per distinct
        captured tensor (q/k/v share one input, gate/up another);
     b. per linear: the GPTQ-PB solve → fake-quant weight, salient mask and
        quantizer states;
     c. write back as "sim" (dense fake-quant floats), "packed" (PBW v1
        planes, element-wise masks and per-group scales) or "packed_v2"
        (PBW v2 planes), packed on the layer's device;
     d. the quantized layer's outputs become the next layer's inputs.

`quantize_model_ptq` keeps the whole model resident on its device;
`quantize_model_ptq_streamed` reads one decoder layer at a time from an HF
checkpoint (`models.hf_stream.StreamedLayerLoader`) and writes each packed
layer out as it finishes (`core.pbw.PBWShardWriter`).  Activations are
kept per ``capture_batch`` windows.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import pbw
from ..interop import to_device
from ..models.linear import apply_linear
from ..models.registry import Family
from .hessian import fold_coefficients, hessian_fold_chunk
from .solver import SolverConfig, gptq_pb


@dataclasses.dataclass
class PTQReport:
    errors: Dict[str, float]          # per "layer_i/name" GPTQ reconstruction error
    masks: Dict[str, np.ndarray]      # per "layer_i/name" binarized mask (True ⇔ binary)
    seconds: float
    format: str
    # per "layer_i": mean squared distance between the quantized layer's
    # outputs and the original-weight outputs on the calibration set
    layer_output_mse: Dict[str, float] = dataclasses.field(default_factory=dict)
    # per "layer_i": seconds of the capture pass, of the GPTQ-PB solves and
    # of packing their results (device synchronised)
    layer_seconds: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)


def _ic(lin) -> int:
    return lin["w"].shape[0] if isinstance(lin, dict) else lin.ic_local


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _capture_fold(fam: Family, cfg, lp, xs: torch.Tensor, hs: Dict[str, torch.Tensor],
                  coef_a, coef_b):
    """One layer forward over a chunk of windows xs [B, T, hidden] that folds
    each selected linear's input into its running Hessian; linears that
    share an input tensor fold it once."""
    captured: Dict[str, torch.Tensor] = {}

    def lf(name, lin, h):
        if name in hs:
            captured[name] = h
        return apply_linear(lin, h)

    ys, _ = fam.decoder_layer(lp, xs, cfg, linear_fn=lf)
    groups: Dict[int, List[str]] = {}
    for n in hs:
        groups.setdefault(id(captured[n]), []).append(n)
    new_hs = dict(hs)
    for members in groups.values():
        x = captured[members[0]]
        h = hessian_fold_chunk(hs[members[0]], x.reshape(xs.shape[0], -1, x.shape[-1]),
                               coef_a, coef_b)
        for n in members:
            new_hs[n] = h
    return ys, new_hs


def _capture(fam: Family, cfg, lp, inps, names, device):
    """The capture pass of layer ``lp`` over every chunk of windows: (each
    named linear's Hessian, the layer's original-weight outputs)."""
    hs = {n: torch.zeros((_ic(lp[n]),) * 2, dtype=torch.float32, device=device) for n in names}
    orig_outs = []
    start = 0
    for x in inps:
        a, b = fold_coefficients(start, x.shape[0])
        y, hs = _capture_fold(fam, cfg, lp, x, hs, a, b)
        orig_outs.append(y)
        start += x.shape[0]
    return hs, orig_outs


def _output_mse(orig_outs, outs) -> float:
    """Mean over windows of the squared distance between a layer's
    quantized and original-weight outputs."""
    mse = [torch.mean((o[r] - q[r]) ** 2).item()
           for o, q in zip(orig_outs, outs) for r in range(o.shape[0])]
    return sum(mse) / len(mse)


def _solve_layer_linears(lp, hs, i, solver_cfg: SolverConfig, fmt: str, pack_block, errors,
                         masks, log) -> float:
    """GPTQ-PB solve and write-back for every captured linear of layer i;
    returns the seconds spent packing and writing back."""
    pack_s = 0.0
    for n in sorted(hs):
        lin = lp[n]
        dev = lin["w"].device
        out = gptq_pb(lin["w"].T.float(), hs[n], solver_cfg)  # [ic, oc] → reference [oc, ic]
        _sync(dev)
        tp = time.time()
        key = f"layer_{i}/{n}"
        errors[key] = float(out["error"])
        masks[key] = out["mask"].cpu().numpy()
        if log:
            log(f"{key}: error {errors[key]:.4f}")
        if fmt == "packed":
            packed, diag = pbw.pack_linear(
                out["w_q"], out["mask"], out["low_state"], out["high_state"],
                solver_cfg.low_method, solver_cfg.groupsize, bias=lin.get("b"),
                pack_block=pack_block)
        elif fmt == "packed_v2":
            packed, diag = pbw.pack_linear_v2(
                out["w_q"], out["mask"], out["low_state"], out["high_state"],
                solver_cfg.low_method, col_tile=solver_cfg.col_tile, bias=lin.get("b"),
                pack_block=pack_block, ic_shards=solver_cfg.ic_shards)
        else:
            lp[n] = {"w": out["w_q"].T.to(lin["w"].dtype).contiguous(), "b": lin.get("b")}
        if fmt != "sim":
            if diag["pack_mismatch"] > 0 and log:
                log(f"{key}: pack mismatch fraction {diag['pack_mismatch']:.2e}")
            lp[n] = packed
        del out
        _sync(dev)
        pack_s += time.time() - tp
    return pack_s


def quantize_model_ptq(
    params: Dict[str, Any],
    cfg: Any,
    fam: Family,
    calib_ids,                       # [nsamples, seqlen] int
    solver_cfg: SolverConfig,
    fmt: str = "sim",                # "sim" | "packed" | "packed_v2"
    minlayer: int = -1,
    maxlayer: int = 100000,
    quant_only: str = "",
    invert: bool = False,
    log: Optional[Callable[[str], None]] = print,
    resume_dir: Optional[str] = None,
    pack_block: Optional[int] = None,
    capture_batch: int = 8,
):
    """Quantize every selected decoder linear, in place on ``params``'s
    layers (on their device).  Returns (params, report).

    ``resume_dir``: each finished layer's quantized leaves (plus errors and
    masks) are checkpointed there, and a rerun skips solving those layers.
    ``capture_batch``: calibration windows per capture/propagate forward
    (the Hessian protocol is sample-sequential either way)."""
    if fmt not in ("sim", "packed", "packed_v2"):
        raise ValueError(f"unknown fmt {fmt!r}")
    if fmt == "packed_v2" and solver_cfg.mask_structure != "column":
        raise ValueError("fmt='packed_v2' requires SolverConfig(mask_structure='column') "
                         "so the salient mask satisfies the v2 format constraint")
    t0 = time.time()
    device = params["embed_tokens"].device
    calib = torch.as_tensor(np.asarray(calib_ids), dtype=torch.long, device=device)
    nsamples = calib.shape[0]
    names = fam.linear_names
    cb = max(1, min(capture_batch, nsamples))

    errors: Dict[str, float] = {}
    masks: Dict[str, np.ndarray] = {}
    layer_mse: Dict[str, float] = {}
    layer_s: Dict[str, Dict[str, float]] = {}
    with torch.inference_mode():
        inps = [fam.embed(params, calib[j : j + cb], cfg) for j in range(0, nsamples, cb)]

        def propagate(lp):
            return [fam.decoder_layer(lp, x, cfg)[0] for x in inps]

        for i, lp in enumerate(params["layers"]):
            selected = {n for n in names if (minlayer <= i < maxlayer and quant_only in n) != invert}
            if not selected:
                inps = propagate(lp)
                continue
            if resume_dir and _load_layer_ckpt(resume_dir, i, lp, errors, masks, device):
                if log:
                    log(f"layer_{i}: resumed from checkpoint")
                inps = propagate(lp)
                continue

            _sync(device)
            tc = time.time()
            hs, orig_outs = _capture(fam, cfg, lp, inps, selected, device)
            _sync(device)
            ts = time.time()
            pack_s = _solve_layer_linears(lp, hs, i, solver_cfg, fmt, pack_block, errors, masks, log)
            _sync(device)
            layer_s[f"layer_{i}"] = {"capture_s": ts - tc, "solve_s": time.time() - ts - pack_s,
                                     "pack_s": pack_s}
            del hs
            if resume_dir:
                _save_layer_ckpt(resume_dir, i, lp, names, errors, masks)

            inps = propagate(lp)
            layer_mse[f"layer_{i}"] = _output_mse(orig_outs, inps)
            del orig_outs
            if log:
                log(f"layer_{i}: output mse vs original weights {layer_mse[f'layer_{i}']:.3e}")

    report = PTQReport(errors=errors, masks=masks, seconds=time.time() - t0, format=fmt,
                       layer_output_mse=layer_mse, layer_seconds=layer_s)
    return params, report


def quantize_model_ptq_streamed(
    loader,                          # models.hf_stream.StreamedLayerLoader
    cfg: Any,
    fam: Family,
    calib_ids,                       # [nsamples, seqlen] int
    solver_cfg: SolverConfig,
    out_dir: str,
    fmt: str = "packed_v2",
    log: Optional[Callable[[str], None]] = print,
    capture_batch: int = 8,
    pack_block: Optional[int] = None,
    device=None,
) -> PTQReport:
    """GPTQ-PB with ONE decoder layer resident at a time: each layer is read
    from the checkpoint (`StreamedLayerLoader`), moved to ``device``
    (default: CUDA), captured, solved, packed, written through
    `PBWShardWriter` and freed, so a model calibrates on a host whose RAM
    holds one layer and the calibration activations.

    The protocol of `quantize_model_ptq` (the same capture fold, solver
    and write-back, on the same device): masks and planes equal the
    resident pipeline's bit for bit.  The artifact holds the packed
    linears; embeddings and norms stay in the source checkpoint
    (`cli.serve --pbw` installs the packed leaves over them)."""
    if fmt not in ("packed", "packed_v2"):
        raise ValueError("streamed calibration writes packed formats only")
    if fmt == "packed_v2" and solver_cfg.mask_structure != "column":
        raise ValueError("fmt='packed_v2' requires SolverConfig(mask_structure='column')")
    t0 = time.time()
    device = resolve_device(device)
    calib = torch.as_tensor(np.asarray(calib_ids), dtype=torch.long, device=device)
    nsamples = calib.shape[0]
    cb = max(1, min(capture_batch, nsamples))
    names = fam.linear_names
    writer = pbw.PBWShardWriter(out_dir)

    errors: Dict[str, float] = {}
    masks: Dict[str, np.ndarray] = {}
    layer_mse: Dict[str, float] = {}
    with torch.inference_mode():
        head = to_device(loader.non_layer_params(cfg), device)
        head["layers"] = []
        inps = [fam.embed(head, calib[j : j + cb], cfg) for j in range(0, nsamples, cb)]
        del head
        for i in range(loader.n_layers()):
            lp = to_device(loader.layer_params(i), device)
            hs, orig_outs = _capture(fam, cfg, lp, inps, names, device)
            _solve_layer_linears(lp, hs, i, solver_cfg, fmt, pack_block, errors, masks, log)
            del hs
            for n in names:
                writer.add_layer(f"layer_{i}/{n}", lp[n])
            inps = [fam.decoder_layer(lp, x, cfg)[0] for x in inps]
            layer_mse[f"layer_{i}"] = _output_mse(orig_outs, inps)
            del orig_outs
            if log:
                log(f"layer_{i}: output mse vs original weights {layer_mse[f'layer_{i}']:.3e}")
            loader.release(i)
            del lp

    writer.finalize({"source": loader.model_dir, "family": loader.family,
                     "gptq": True, "low_frac": solver_cfg.low_frac})
    return PTQReport(errors=errors, masks=masks, seconds=time.time() - t0, format=fmt,
                     layer_output_mse=layer_mse)


def _save_layer_ckpt(resume_dir: str, i: int, lp: Dict[str, Any], names, errors, masks) -> None:
    from ..utils import checkpoint as ckpt

    os.makedirs(resume_dir, exist_ok=True)
    quantized = {n: lp[n] for n in names if n in lp}
    extra = {
        "errors": {k: v for k, v in errors.items() if k.startswith(f"layer_{i}/")},
        "mask_keys": [k for k in masks if k.startswith(f"layer_{i}/")],
    }
    layer_dir = os.path.join(resume_dir, f"layer_{i}")
    ckpt.save_dense_checkpoint(layer_dir, quantized, extra)
    np.savez_compressed(os.path.join(layer_dir, "masks.npz"),
                        **{k.replace("/", "__"): masks[k] for k in extra["mask_keys"]})


def _load_layer_ckpt(resume_dir: str, i: int, lp: Dict[str, Any], errors, masks,
                     device: torch.device) -> bool:
    from ..utils import checkpoint as ckpt

    layer_dir = os.path.join(resume_dir, f"layer_{i}")
    if not os.path.exists(os.path.join(layer_dir, "manifest.json")):
        return False
    quantized, extra = ckpt.load_dense_checkpoint(layer_dir)
    lp.update(to_device(quantized, device))
    errors.update(extra.get("errors", {}))
    with np.load(os.path.join(layer_dir, "masks.npz")) as z:
        for k in z.files:
            masks[k.replace("__", "/")] = z[k]
    return True


def save_masks(path: str, masks: Dict[str, np.ndarray], low_frac: float) -> None:
    """Persist salient masks for the QAT-Hessian handoff (one npz; the
    reference writes per-layer pickles, `gptq_pb/gptq.py:108-114`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, __low_frac__=np.float64(low_frac), **masks)


def load_masks(path: str):
    with np.load(path) as z:
        masks = {k: z[k] for k in z.files if k != "__low_frac__"}
        return masks, float(z["__low_frac__"])
