"""The plain reference that decides `correct`, and its lower-precision
controls.

`forward_gaps` regenerates a run's inputs from its seed
(`benchmark/weights`), dequantizes each layer with its own code
(`dequant.py`) and runs the family's plain f32 forward (`llama.py`,
`opt.py`) over whole sequences, one layer at a time, so that it fits beside
nothing else on the card.  For each sequence (prompt + served tokens) it
reads, at every served position, the gap by which the served token's logit
lies below the reference's best, and for each further precision (a
control: `controls`, one stated precision a step lower) the same gap for
the token that it puts first.  It imports torch and the benchmark's own modules: nothing of the
port, and nothing the port made.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Sequence, Tuple

import torch

from ..weights import pbw
from . import dequant

# the step below each precision a configuration states (its control)
LOWER = {"f32": "bf16", "int8": "int4"}
# what a configuration states a precision of: the inputs of the decoder
# linears, the K/V rows, and the rest of the forward (`Precision.hid`)
STATED = ("linear_input", "kv", "hidden")


def _round_absmax(a: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric absmax rounding over the last axis at ``bits`` bits (int8:
    ±127, int4: ±7), round half to even, back in f32."""
    qmax = 2 ** (bits - 1) - 1
    scale = torch.clamp(a.abs().amax(dim=-1, keepdim=True) / qmax, min=1e-8)
    return torch.clamp(torch.round(a / scale), -qmax, qmax) * scale


def _round(a: torch.Tensor, prec: str) -> torch.Tensor:
    """``a`` (f32) at ``prec``: "f32" as it is, "bf16" rounded to the
    nearest bf16, "int8" / "int4" absmax-rounded over the last axis."""
    if prec == "f32":
        return a
    if prec == "bf16":
        return a.to(torch.bfloat16).float()
    return _round_absmax(a, {"int8": 8, "int4": 4}[prec])


class Precision:
    """Where the forward rounds, and to what ("f32", "bf16", "int8",
    "int4"): ``linear_input`` the inputs of the decoder linears (int8 and
    int4 per row into the centred part of a PBW-v2 weight, as the int8 arms
    do: the row sums against the offset part stay exact; bf16 the whole
    input), ``kv`` the K/V rows (per token and head), ``hidden`` the rest
    (`hid`: the residual stream, the attention's q and probabilities, the
    head's input and weight)."""

    def __init__(self, linear_input: str = "f32", kv: str = "f32", hidden: str = "f32",
                 reorder: bool = False):
        """``reorder`` sums each product's two halves of the inputs apart
        (a witness of what the order of f32 sums alone does)."""
        self.linear_input, self.kv_prec, self.hidden = linear_input, kv, hidden
        self.reorder = reorder

    def _mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if not self.reorder:
            return a @ w
        h = w.shape[0] // 2
        return a[..., h:] @ w[h:] + a[..., :h] @ w[:h]

    def linear(self, a: torch.Tensor, lin: dict) -> torch.Tensor:
        integer = self.linear_input.startswith("int")
        if "w" in lin:
            if integer:
                raise ValueError("integer inputs are defined for PBW-v2 layers only")
            y = self._mm(_round(a, self.linear_input), lin["w"])
        elif integer:
            y = self._mm(a, lin["w_off"]) + self._mm(_round(a, self.linear_input), lin["w_cen"])
        else:
            a = _round(a, self.linear_input)
            y = self._mm(a, lin["w_off"]) + self._mm(a, lin["w_cen"])
        return y if lin["b"] is None else y + lin["b"]

    def kv(self, a: torch.Tensor) -> torch.Tensor:
        return _round(a, self.kv_prec)

    def hid(self, a: torch.Tensor) -> torch.Tensor:
        return _round(a, self.hidden)


EXACT = Precision()  # f32 throughout: a witness, not the reference


def _stated(cfg: dict) -> dict:
    p = cfg["assumed"]["precision"]
    return {k: p[k] for k in STATED}


def stated_precision(cfg: dict, reorder: bool = False) -> Precision:
    """The reference's precision: what the configuration states
    (`assumed.precision`)."""
    return Precision(**_stated(cfg), reorder=reorder)


def controls(cfg: dict) -> Dict[str, Precision]:
    """The controls, one for each precision that the configuration states,
    that one a step lower (`LOWER`) and the others as stated; named
    ``<what>.<precision>``, e.g. ``kv.int4``."""
    out = {}
    for key, prec in _stated(cfg).items():
        out[f"{key}.{LOWER[prec]}"] = Precision(**dict(_stated(cfg), **{key: LOWER[prec]}))
    return out


def _family(cfg: dict):
    ref = importlib.import_module(f"{__package__}.{cfg['family']}")
    weights = importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.weights.{cfg['family']}")
    return ref, weights


def _dense_layer(lp: dict) -> dict:
    return {k: dequant.dense(v) if pbw.is_layer(v) else v for k, v in lp.items()}


def _no_tf32(fn):
    def wrapped(*a, **kw):
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                return fn(*a, **kw)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return wrapped


@_no_tf32
def final_hidden(cfg: dict, seed: int, device, id_lists, precisions):
    """The last layer's output [T, h] of each id sequence, at each precision
    (outer list), the model made again from ``seed`` one layer at a time;
    and the layers outside the decoder (embeddings, final norm, head)."""
    ref, weights = _family(cfg)
    outer = weights.outer(cfg, seed, device)
    ids = [torch.as_tensor(list(i), dtype=torch.long, device=device) for i in id_lists]
    x0 = [ref.embed(cfg, outer, i) for i in ids]
    arms = [[prec.hid(x) for x in x0] for prec in precisions]
    for li in range(cfg["num_hidden_layers"]):
        lp = _dense_layer(weights.layer(cfg, seed, li, device))
        for prec, xs in zip(precisions, arms):
            for j in range(len(xs)):
                xs[j] = ref.block(cfg, lp, xs[j], prec)
        del lp
    return arms, outer


@_no_tf32
def forward_gaps(cfg: dict, seed: int, device, seqs: Sequence[Tuple[List[int], List[int]]],
                 precisions: Sequence[Precision] = ()):
    """For each (prompt_ids, served_ids): the served tokens' gaps below the
    reference's best logit (the reference at the configuration's stated
    precision), f32 [len(served)]; and for each of ``precisions`` (the
    control, a witness) the gaps of the tokens that it puts first at the
    same positions: (gaps, [gaps of each precision])."""
    ref, _ = _family(cfg)
    stated = stated_precision(cfg)
    arms, outer = final_hidden(cfg, seed, device, [list(p) + list(s[:-1]) for p, s in seqs],
                               (stated,) + tuple(precisions))
    gaps, picks = [], [[] for _ in precisions]
    for j, (p, s) in enumerate(seqs):
        rows = slice(len(p) - 1, len(p) - 1 + len(s))
        logits = ref.head(cfg, outer, arms[0][j][rows], stated)
        best = logits.max(dim=-1).values
        served = torch.as_tensor(list(s), dtype=torch.long, device=device)
        valid = (served >= 0) & (served < logits.shape[1])  # an id off the vocabulary: inf
        gap = best - logits.gather(1, torch.where(valid, served, 0)[:, None])[:, 0]
        gaps.append(torch.where(valid, gap, torch.inf).cpu().numpy())
        for k, (prec, arm) in enumerate(zip(precisions, arms[1:])):
            pick = ref.head(cfg, outer, arm[j][rows], prec).argmax(dim=-1)
            picks[k].append((best - logits.gather(1, pick[:, None])[:, 0]).cpu().numpy())
    return gaps, picks

