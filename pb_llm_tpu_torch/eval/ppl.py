"""Windowed perplexity (port of `pb_llm_tpu/eval/ppl.py`), the reference's
evaluation protocol (`gptq_pb/eval_ppl_utils.py:8-88`):

  * nsamples = total_tokens // seqlen non-overlapping windows (tail dropped);
  * per window: forward, shift-by-one cross-entropy in f32 (mean over
    seqlen − 1 positions), nll = loss · seqlen;
  * ppl = exp(Σ nll / (nsamples · seqlen)).

The model runs on the device of its embeddings, under `torch.inference_mode`.
`perplexity_sp` runs the same protocol with each window's sequence cut
over an sp mesh: every rank holds only its T/sp rows through the whole
forward (attention is the ring, `parallel.ring_attention`), so a window
too long for one card evaluates across ranks.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def cross_entropy_shifted(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE of logits[:, :-1] predicting targets[:, 1:], in float32."""
    lg = logits[:, :-1, :].float()
    gold = torch.gather(lg, -1, targets[:, 1:, None].long())[..., 0]
    return torch.mean(torch.logsumexp(lg, dim=-1) - gold)


def _windows(token_ids, seqlen: int, window_limit: Optional[int]):
    ids = np.asarray(token_ids).reshape(-1)
    nsamples = ids.size // seqlen
    if window_limit is not None:
        nsamples = min(nsamples, window_limit)
    if nsamples == 0:
        raise ValueError(f"eval text shorter than one {seqlen}-token window")
    return ids, nsamples


def perplexity(params: Dict[str, Any], cfg: Any, forward: Callable, token_ids,
               seqlen: Optional[int] = None, window_limit: Optional[int] = None,
               window_batch: int = 1) -> float:
    """``token_ids``: [1, N] or [N] ints of the joined eval text.

    ``window_batch`` > 1 runs that many windows per forward (the protocol is
    a sum of per-window NLLs, so batching changes throughput, not the
    number); a short tail batch repeats window 0 and masks it out."""
    seqlen = seqlen or cfg.seqlen
    ids, nsamples = _windows(token_ids, seqlen, window_limit)
    wb = max(1, min(window_batch, nsamples))
    device = params["embed_tokens"].device

    total = 0.0
    with torch.inference_mode():
        for lo in range(0, nsamples, wb):
            n = min(wb, nsamples - lo)
            rows = [ids[(lo + i) * seqlen : (lo + i + 1) * seqlen] for i in range(n)]
            rows += [rows[0]] * (wb - n)
            windows = torch.as_tensor(np.stack(rows), dtype=torch.long, device=device)
            logits, _ = forward(params, windows, cfg)
            lg = logits[:, :-1, :].float()
            gold = torch.gather(lg, -1, windows[:, 1:, None])[..., 0]
            per_window = torch.mean(torch.logsumexp(lg, dim=-1) - gold, dim=1) * seqlen
            total += float(torch.sum(per_window[:n]))
    return float(np.exp(total / (nsamples * seqlen)))


def perplexity_sp(params: Dict[str, Any], cfg: Any, forward: Callable, token_ids, mesh,
                  seqlen: Optional[int] = None, window_limit: Optional[int] = None) -> float:
    """`perplexity`'s protocol with each window's sequence over ``mesh``'s
    "sp" axis; every rank of it calls this with the whole text.  Rank r
    embeds its rows r·T/sp .. (r+1)·T/sp − 1 at their global positions,
    runs the forward under `models.attention.sequence_parallel`, and scores
    those rows against the next ids of the window; the rows' NLL sums join
    over the axis (`collectives.all_sum`) into each window's mean.  seqlen
    must divide by sp.  Returns the same number on every rank."""
    from ..models.attention import sequence_parallel
    from ..parallel.collectives import all_sum

    seqlen = seqlen or cfg.seqlen
    n, r = mesh.shape["sp"], mesh.coord("sp")
    if seqlen % n:
        raise ValueError(f"seqlen {seqlen} not divisible by sp={n}")
    ids, nsamples = _windows(token_ids, seqlen, window_limit)
    tl = seqlen // n
    lo = r * tl
    rows = min(tl, seqlen - 1 - lo)  # the window's last row predicts nothing
    device = params["embed_tokens"].device
    group = getattr(mesh, "group", None)
    total = 0.0
    with torch.inference_mode(), sequence_parallel(mesh):
        for w in range(nsamples):
            win = torch.as_tensor(ids[w * seqlen : (w + 1) * seqlen], dtype=torch.long,
                                  device=device)
            logits, _ = forward(params, win[None, lo : lo + tl], cfg, pos=lo)
            lg = logits[0, :rows].float()
            gold = torch.gather(lg, -1, win[lo + 1 : lo + 1 + rows, None])[..., 0]
            nll = torch.sum(torch.logsumexp(lg, dim=-1) - gold).reshape(1)
            total += float(all_sum(nll, group)) / (seqlen - 1) * seqlen
    return float(np.exp(total / (nsamples * seqlen)))
