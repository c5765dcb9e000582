"""Token samplers (port of `pb_llm_tpu/runtime/sampler.py`): greedy is
argmax; temperature / top-k / top-p sampling and the speculative rejection
sampler draw from a torch.Generator (it gives other numbers than jax.random
from the same seed)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0   # 0 → greedy
    top_k: int = 0             # 0 → disabled
    top_p: float = 1.0         # 1 → disabled


def _categorical(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(x); the generator lives on x's device."""
    probs = torch.softmax(x.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def filter_logits_vec(logits, temperature, top_k, top_p) -> torch.Tensor:
    """Per-row temperature-scaled, top-k/top-p-filtered logits."""
    v = logits.shape[-1]
    safe_t = torch.where(temperature > 0.0, temperature, torch.ones_like(temperature))
    x = logits / safe_t[:, None]
    xs = torch.sort(x, dim=-1).values
    kth_idx = torch.where(top_k > 0, torch.clamp(v - top_k, min=0), torch.zeros_like(top_k))
    kth = torch.gather(xs, -1, kth_idx[:, None].long())
    x = torch.where(x < kth, -torch.inf, x)
    sorted_desc = torch.flip(torch.sort(x, dim=-1).values, dims=[-1])
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    cutoff_idx = torch.sum(cum < torch.clamp(top_p, 0.0, 1.0)[:, None], dim=-1)
    cutoff_idx = torch.where(top_p < 1.0, torch.clamp(cutoff_idx, max=v - 1),
                             torch.full_like(cutoff_idx, v - 1))
    cutoff = torch.gather(sorted_desc, -1, cutoff_idx[:, None])
    return torch.where(x < cutoff, -torch.inf, x)


def sample_vec(logits, generator: torch.Generator, temperature, top_k, top_p) -> torch.Tensor:
    """Per-row sampling params; row-wise equal to `sample`."""
    lf = logits.float()
    greedy = torch.argmax(lf, dim=-1)
    if not bool((temperature > 0).any()):
        return greedy
    sampled = _categorical(filter_logits_vec(lf, temperature, top_k, top_p), generator)
    return torch.where(temperature > 0.0, sampled, greedy)


def spec_verify_sample(logits, drafts, generator: torch.Generator, temperature, top_k, top_p):
    """Rejection-sampling speculative verify for deterministic proposals
    (port of `pb_llm_tpu/runtime/sampler.py::spec_verify_sample`).

    logits [B, t, V] over [last, d_1..d_γ], drafts [B, γ] (t = γ+1).
    Accept d_j with probability p_j(d_j) under the request's filtered
    distribution p_j; on rejection emit a sample of p_j with d_j masked out;
    when all γ drafts are accepted the bonus token samples p_γ unmasked.
    Marginally each emitted token has the plain sampler's distribution.
    Greedy rows (temperature 0) reduce to token-match acceptance with
    argmax corrections.  Returns (accept [B, γ] bool, corr [B, t],
    lp_draft [B, γ], lp_corr [B, t]), the logprobs raw log-softmax values.
    The draws come from ``generator``, so the bits differ from JAX's."""
    b, t, v = logits.shape
    gamma = t - 1
    dev = logits.device
    lf = logits.reshape(b * t, v).float()
    tempr = torch.repeat_interleave(temperature, t)
    x = filter_logits_vec(lf, tempr, torch.repeat_interleave(top_k, t),
                          torch.repeat_interleave(top_p, t))
    greedy = torch.argmax(lf, dim=-1)
    dpad = torch.cat([drafts.long(), torch.zeros((b, 1), dtype=torch.long, device=dev)], dim=1)
    dflat = dpad.reshape(b * t)
    lpx = torch.log_softmax(x, dim=-1)
    pd = torch.exp(torch.gather(lpx, 1, dflat[:, None])[:, 0])
    u = torch.rand(b * t, generator=generator, device=dev)
    accept = torch.where(tempr > 0.0, u < pd, dflat == greedy)
    # residual: the rejected draft leaves the support at positions < γ
    pos = torch.arange(t, device=dev).repeat(b)  # row r = slot·t + j → j
    is_draft = (torch.arange(v, device=dev)[None, :] == dflat[:, None]) & (pos[:, None] < gamma)
    xm = torch.where(is_draft, -torch.inf, x)
    # a row whose whole support was the draft accepts it surely (p = 1);
    # its correction is never emitted, but the draw needs a finite row
    xm = torch.where(torch.isinf(xm).all(dim=-1, keepdim=True), x, xm)
    corr = torch.where(tempr > 0.0, _categorical(xm, generator), greedy)
    lp_raw = torch.log_softmax(lf, dim=-1)
    lp_d = torch.gather(lp_raw, 1, dflat[:, None])[:, 0]
    lp_c = torch.gather(lp_raw, 1, corr[:, None])[:, 0]
    return (accept.reshape(b, t)[:, :gamma], corr.reshape(b, t), lp_d.reshape(b, t)[:, :gamma],
            lp_c.reshape(b, t))


def sample(logits: torch.Tensor, generator: torch.Generator, params: SamplingParams) -> torch.Tensor:
    """logits [B, V] → token ids [B]."""
    if params.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / params.temperature
    if params.top_k > 0:
        k = min(params.top_k, logits.shape[-1])
        kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if params.top_p < 1.0:
        sorted_logits = torch.flip(torch.sort(logits, dim=-1).values, dims=[-1])
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < params.top_p, dim=-1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return _categorical(logits, generator)
