"""Windowed perplexity (port of `pb_llm_tpu/eval/ppl.py`), the reference's
evaluation protocol (`gptq_pb/eval_ppl_utils.py:8-88`):

  * nsamples = total_tokens // seqlen non-overlapping windows (tail dropped);
  * per window: forward, shift-by-one cross-entropy in f32 (mean over
    seqlen − 1 positions), nll = loss · seqlen;
  * ppl = exp(Σ nll / (nsamples · seqlen)).

The model runs on the device of its embeddings, under `torch.inference_mode`.
The sequence-parallel variant (`perplexity_sp`) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def perplexity(params: Dict[str, Any], cfg: Any, forward: Callable, token_ids,
               seqlen: Optional[int] = None, window_limit: Optional[int] = None,
               window_batch: int = 1) -> float:
    """``token_ids``: [1, N] or [N] ints of the joined eval text.

    ``window_batch`` > 1 runs that many windows per forward (the protocol is
    a sum of per-window NLLs, so batching changes throughput, not the
    number); a short tail batch repeats window 0 and masks it out."""
    seqlen = seqlen or cfg.seqlen
    ids = np.asarray(token_ids).reshape(-1)
    nsamples = ids.size // seqlen
    if window_limit is not None:
        nsamples = min(nsamples, window_limit)
    if nsamples == 0:
        raise ValueError(f"eval text shorter than one {seqlen}-token window")
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
