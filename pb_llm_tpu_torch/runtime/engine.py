"""Inference engine over strip KV caches (port of the strip path of
`pb_llm_tpu/runtime/engine.py`): bucketed prefill, batched prefill of
same-bucket prompts, and batched decode over the whole slot pool with
inactive slots masked.

PyTorch runs eagerly, so there are no per-bucket compiled programs: each
call runs the forward under this engine's `KernelConfig`
(`ops.kernel_config.use_kernels`).  The KV caches are updated in place.
Paged pools, speculative decoding, chunked prefill, prefix caching, scanned
layers and fused linears are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..interop import to_device
from ..models.registry import Family
from ..ops.kernel_config import use_kernels
from . import kv_cache as kvmod
from .sampler import SamplingParams, sample, sample_vec


def _chosen_logprob(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """log P(tok) under log-softmax(logits); logits [..., V], toks [...]."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, toks[..., None].long())[..., 0]


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 8
    max_seq: int = 2048
    prefill_buckets: Sequence[int] = (32, 128, 512, 2048)
    # "auto" = int8 on CUDA, f32 on the CPU (resolved at Engine init); or a
    # torch dtype (torch.int8 / torch.float32)
    cache_dtype: Any = "auto"
    max_prefill_batch: int = 4
    # kernel arms for this engine (ops.kernel_config.KernelConfig; None =
    # the process default)
    kernels: Optional[Any] = None
    # not ported yet: anything but the defaults raises NotImplementedError
    scan_layers: bool = False
    page_size: int = 0
    n_pages: int = 0
    prefix_cache: bool = False
    spec_gamma: int = 0
    prefill_chunk: int = 0
    fuse_linears: bool = False


_NOT_PORTED = ("scan_layers", "page_size", "prefix_cache", "spec_gamma", "prefill_chunk",
               "fuse_linears")


def resolve_cache_dtype(cache_dtype, device: torch.device):
    """"auto" → int8 on CUDA (the serving default), f32 on the CPU."""
    if cache_dtype == "auto":
        return torch.int8 if device.type == "cuda" else torch.float32
    return cache_dtype


class Engine:
    """Low-level engine: claims slots, prefills prompts, steps decode."""

    def __init__(self, params, cfg, fam: Family, ecfg: EngineConfig,
                 sampling: SamplingParams = SamplingParams(), device=None, seed: int = 0):
        for f in _NOT_PORTED:
            if getattr(ecfg, f):
                raise NotImplementedError(
                    f"EngineConfig.{f} is not ported yet (ROADMAP Queue 1): the port "
                    "serves strip caches with plain decode")
        self.device = resolve_device(device)
        self.params = to_device(params, self.device)
        self.cfg = cfg
        self.fam = fam
        self.ecfg = ecfg
        self.sampling = sampling
        n_layers, kv_heads, head_dim = kvmod.cache_spec_for(cfg, fam.name)
        self.cache_dtype = resolve_cache_dtype(ecfg.cache_dtype, self.device)
        self.caches = kvmod.make_caches(cfg, ecfg.n_slots, ecfg.max_seq, n_layers, kv_heads,
                                        head_dim, self.cache_dtype, self.device)
        self.lengths = np.zeros(ecfg.n_slots, np.int32)
        self.active = np.zeros(ecfg.n_slots, bool)
        self.last_token = np.zeros(ecfg.n_slots, np.int32)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._slot_sampling: Dict[int, SamplingParams] = {}
        self._prefill_logits: Dict[int, torch.Tensor] = {}
        self.token_logprobs: Dict[int, List[float]] = {}

    def _forward(self, ids: np.ndarray, caches, pos):
        with torch.inference_mode(), use_kernels(self.ecfg.kernels):
            ids_t = torch.as_tensor(ids, dtype=torch.long, device=self.device)
            logits, _ = self.fam.forward(self.params, ids_t, self.cfg, kv_caches=caches, pos=pos)
        return logits

    # ---------------- slot management ----------------

    def free_slots(self) -> List[int]:
        return [i for i in range(self.ecfg.n_slots) if not self.active[i]]

    def can_admit(self, prompt_len: int, reserved_pages: int = 0) -> bool:
        return True  # strip caches: a free slot always fits a prompt < max_seq

    def release(self, slot: int) -> None:
        self.active[slot] = False
        self.lengths[slot] = 0
        self._slot_sampling.pop(slot, None)
        self._prefill_logits.pop(slot, None)
        self.token_logprobs.pop(slot, None)

    def set_slot_sampling(self, slot: int, sp: Optional[SamplingParams]) -> None:
        if sp is None:
            self._slot_sampling.pop(slot, None)
        else:
            self._slot_sampling[slot] = sp

    def _sampling_for(self, slot: int) -> SamplingParams:
        return self._slot_sampling.get(slot, self.sampling)

    def _sampling_vectors(self):
        n = self.ecfg.n_slots
        temp = np.full(n, self.sampling.temperature, np.float32)
        tk = np.full(n, self.sampling.top_k, np.int64)
        tp = np.full(n, self.sampling.top_p, np.float32)
        for s, sp in self._slot_sampling.items():
            temp[s], tk[s], tp[s] = sp.temperature, sp.top_k, sp.top_p
        return tuple(torch.as_tensor(a, device=self.device) for a in (temp, tk, tp))

    # ---------------- prefill ----------------

    def _bucket(self, n: int) -> int:
        for b in self.ecfg.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket")

    def _prefill_rows(self, pairs: Sequence) -> torch.Tensor:
        """Run ``pairs`` [(slot, prompt_ids)] as one [K, bucket] forward at
        pos 0 over the slots' cache rows [0, bucket) and write those rows
        back; returns the next-token logits [K, V]."""
        lens = [len(p) for _, p in pairs]
        if max(lens) >= self.ecfg.max_seq:
            raise ValueError("prompt longer than max_seq")
        bucket = self._bucket(max(lens))
        ids = np.zeros((len(pairs), bucket), np.int64)
        for r, (_, p) in enumerate(pairs):
            ids[r, : len(p)] = p
        slots = torch.as_tensor([s for s, _ in pairs], device=self.device)
        rows = [{k: v[slots, :bucket] for k, v in c.items()} for c in self.caches]
        logits = self._forward(ids, rows, 0)
        for c, nc in zip(self.caches, rows):
            for k in c:
                c[k][slots, :bucket] = nc[k]
        last = torch.as_tensor([n - 1 for n in lens], device=self.device)
        return logits[torch.arange(len(pairs), device=self.device), last]

    def _finish(self, slot: int, n: int, next_logits: torch.Tensor, tok: int, lp: float) -> int:
        self.lengths[slot] = n
        self.active[slot] = True
        self.last_token[slot] = tok
        self._prefill_logits[slot] = next_logits
        self.token_logprobs[slot] = [lp]
        return tok

    def prefill(self, slot: int, prompt_ids: Sequence[int]) -> int:
        """Fill a slot's cache with the prompt; returns the first generated token."""
        return self.prefill_batch([(slot, prompt_ids)])[slot]

    def prefill_batch(self, pairs: Sequence) -> Dict[int, int]:
        """Prefill several same-bucket-able slots in one forward (m =
        K·bucket through every linear).  Returns {slot: first token}."""
        pairs = list(pairs)
        if not pairs:
            return {}
        next_logits = self._prefill_rows(pairs)
        toks = [int(sample(next_logits[r : r + 1], self.generator, self._sampling_for(s))[0])
                for r, (s, _) in enumerate(pairs)]
        lps = _chosen_logprob(next_logits, torch.as_tensor(toks, device=self.device)).tolist()
        return {s: self._finish(s, len(p), next_logits[r], toks[r], lps[r])
                for r, (s, p) in enumerate(pairs)}

    # ---------------- decode ----------------

    def _step_logits(self) -> torch.Tensor:
        """One token for every slot at its own position; logits [n_slots, V]."""
        pos = torch.as_tensor(self.lengths, dtype=torch.long, device=self.device)
        return self._forward(self.last_token[:, None], self.caches, pos)[:, 0]

    def decode_step(self) -> Dict[int, int]:
        """Advance every active slot one token.  Returns {slot: token}."""
        if not self.active.any():
            return {}
        logits = self._step_logits()
        if self._slot_sampling:
            toks = sample_vec(logits, self.generator, *self._sampling_vectors())
        else:
            toks = sample(logits, self.generator, self.sampling)
        active = torch.as_tensor(self.active, device=self.device)
        toks = torch.where(active, toks, torch.zeros_like(toks))
        lps = _chosen_logprob(logits, toks).cpu().numpy()
        toks = toks.cpu().numpy()
        out = {}
        for i in range(self.ecfg.n_slots):
            if self.active[i]:
                self.lengths[i] += 1  # cache row written at the old length
                self.last_token[i] = int(toks[i])
                out[i] = int(toks[i])
                self.token_logprobs[i] = [float(lps[i])]
        return out

    def forced_decode_nll(self, slot: int, tokens: Sequence[int]) -> float:
        """Teacher-forced decode: mean NLL per token of ``tokens`` after the
        slot's prompt.  tokens[0] is scored from the prefill logits, each
        later token from a decode step fed the previous forced token; only
        ``slot`` advances."""
        if slot not in self._prefill_logits:
            raise ValueError(f"slot {slot} has no prefill logits; prefill first")
        lp0 = torch.log_softmax(self._prefill_logits[slot].float(), dim=-1)
        nll = -float(lp0[tokens[0]])
        self.last_token[slot] = int(tokens[0])
        for t in tokens[1:]:
            logits = self._step_logits()
            nll -= float(torch.log_softmax(logits[slot].float(), dim=-1)[t])
            self.lengths[slot] += 1
            self.last_token[slot] = int(t)
        return nll / max(len(tokens), 1)
