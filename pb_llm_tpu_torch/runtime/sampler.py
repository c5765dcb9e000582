"""Token samplers (port of `pb_llm_tpu/runtime/sampler.py`): greedy is
argmax; temperature / top-k / top-p sampling draws from a torch.Generator
(it gives other numbers than jax.random from the same seed)."""

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
