"""Inference engine (port of `pb_llm_tpu/runtime/engine.py`): bucketed
prefill, batched prefill of same-bucket prompts and batched decode over the
whole slot pool with inactive slots masked, over strip caches or a paged
pool (`runtime.paged_kv`) with prefix caching; chunked prefill; speculative
decoding with greedy token-match or rejection-sampled verify.

Each call runs the forward under this engine's `KernelConfig`
(`ops.kernel_config.use_kernels`).  The decode step's forward, the program
JAX jits once per engine, runs as one CUDA graph on the card
(`runtime.step_graph`: captured on the second step, replayed from static
buffers; `step_graph.eager()` runs it op by op); prefill buckets, chunks,
speculative verify and sampling run eagerly.  The KV caches and pages are
updated in place.  ``scan_layers`` stacks the layers and the caches
(`models.stacking`: the forward loops over layer views, PBW-v2 linears
through the stacked kernels); ``fuse_linears`` merges q|k|v and gate|up
(`models.fusion`).
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
from .sampler import SamplingParams, sample, sample_vec, spec_verify_sample
from .step_graph import StepGraph


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
    # torch dtype (torch.int8 / torch.bfloat16 / torch.float32)
    cache_dtype: Any = "auto"
    max_prefill_batch: int = 4
    # kernel arms for this engine (ops.kernel_config.KernelConfig; None =
    # the process default)
    kernels: Optional[Any] = None
    # paged KV pool: page_size > 0 replaces the strips by a global page pool
    # of n_pages pages (0 = full strip capacity; fewer oversubscribe the
    # slots, and ContinuousBatcher preempts when the pool runs out).  Every
    # prefill bucket must divide by page_size.
    page_size: int = 0
    n_pages: int = 0
    # prefix caching over the paged pool: a request sharing a page-aligned
    # prompt prefix with an earlier one reuses its pages and prefills only
    # its suffix (`runtime.paged_kv.PagePool`)
    prefix_cache: bool = False
    # speculative decoding: verify spec_gamma draft tokens + 1 correction in
    # one forward; greedy streams equal plain decode; 0 disables
    spec_gamma: int = 0
    # chunked prefill: prompts longer than this prefill one chunk per
    # scheduler tick, interleaved with decode steps; 0 disables
    prefill_chunk: int = 0
    # stacked layers (models.stacking): params and caches carry a leading
    # [L] axis; the forward loops over layer li's views and runs PBW-v2
    # linears through the stacked kernels (one launch signature for every
    # layer).  Composes with the paged pool: the stacked cache carries
    # [L]-axis pages and table.
    scan_layers: bool = False
    # fuse q/k/v and gate/up into single packed matmuls (models.fusion):
    # 7 → 4 per llama block, the dequantized weights unchanged (each part
    # keeps its salient columns and scales as a row group).  PBW-v2
    # global-selection layers only; others stay unfused.
    fuse_linears: bool = False


def resolve_cache_dtype(cache_dtype, device: torch.device):
    """"auto" → int8 on CUDA (the serving default), f32 on the CPU."""
    if cache_dtype == "auto":
        return torch.int8 if device.type == "cuda" else torch.float32
    return cache_dtype


class PoolExhausted(RuntimeError):
    """A step needs more pages than the paged pool has free.  Raised BEFORE
    any slot grows (the step is not taken), so the scheduler can preempt a
    request and retry (`runtime.batching.ContinuousBatcher`)."""


def _with_extras(caches, **extras):
    """Per-call cache extras (``slot_pages`` / ``chunk_table``) in shallow
    copies of the layer dicts, or broadcast over the stacked cache's [L]
    axis (scan_layers); the page tensors stay shared."""
    if isinstance(caches, dict):
        n = caches["k_pages"].shape[0]
        return dict(caches, **{k: v.expand(n, *v.shape) for k, v in extras.items()})
    return [dict(c, **extras) for c in caches]


def _rows(caches, idx):
    """Each layer's strip entries at ``idx`` (an index over [slots, rows]):
    per-layer dicts, or one dict of [L]-leading tensors (scan_layers).  A
    slice index gives views; a tensor index, copies (see `_set_rows`)."""
    if isinstance(caches, dict):
        return {k: v[(slice(None),) + idx] for k, v in caches.items()}
    return [{k: v[idx] for k, v in c.items()} for c in caches]


def _set_rows(caches, idx, new) -> None:
    """Write `_rows` copies back into the strips at ``idx``."""
    if isinstance(caches, dict):
        for k, v in caches.items():
            v[(slice(None),) + idx] = new[k]
        return
    for c, nc in zip(caches, new):
        for k in c:
            c[k][idx] = nc[k]


class Engine:
    """Low-level engine: claims slots, prefills prompts, steps decode."""

    def __init__(self, params, cfg, fam: Family, ecfg: EngineConfig,
                 sampling: SamplingParams = SamplingParams(), device=None, seed: int = 0):
        if ecfg.prefill_chunk:
            if ecfg.page_size and ecfg.prefill_chunk % ecfg.page_size:
                raise ValueError(f"prefill_chunk {ecfg.prefill_chunk} must be a multiple of "
                                 f"page_size {ecfg.page_size}")
            if ecfg.max_seq % ecfg.prefill_chunk:
                # the final chunk's fixed-size window must stay inside the cache
                raise ValueError(f"max_seq {ecfg.max_seq} must be a multiple of "
                                 f"prefill_chunk {ecfg.prefill_chunk}")
            if ecfg.prefill_chunk > max(ecfg.prefill_buckets):
                # prompts of length (max_bucket, prefill_chunk] would have
                # neither a bucket nor the chunked path
                raise ValueError(f"prefill_chunk {ecfg.prefill_chunk} exceeds the largest "
                                 f"prefill bucket {max(ecfg.prefill_buckets)}")
        self.device = resolve_device(device)
        self.params = to_device(params, self.device)
        self.cfg = cfg
        self.fam = fam
        self.ecfg = ecfg
        self.sampling = sampling
        n_layers, kv_heads, head_dim = kvmod.cache_spec_for(cfg, fam.name)
        self.cache_dtype = resolve_cache_dtype(ecfg.cache_dtype, self.device)
        self.pool = None
        if ecfg.page_size:
            from . import paged_kv

            for b in ecfg.prefill_buckets:
                if b % ecfg.page_size:
                    raise ValueError(f"prefill bucket {b} not divisible by page_size "
                                     f"{ecfg.page_size}")
            n_pages = ecfg.n_pages or ecfg.n_slots * ecfg.max_seq // ecfg.page_size
            self.pool = paged_kv.PagePool(n_pages, ecfg.page_size, ecfg.n_slots, ecfg.max_seq,
                                          prefix_cache=ecfg.prefix_cache)
            self.caches = self.pool.make_layer_cache(n_layers, kv_heads, head_dim,
                                                     self.cache_dtype, self.device)
        else:
            if ecfg.prefix_cache:
                raise ValueError("prefix_cache requires a paged pool (page_size > 0)")
            self.caches = kvmod.make_caches(cfg, ecfg.n_slots, ecfg.max_seq, n_layers, kv_heads,
                                            head_dim, self.cache_dtype, self.device)
        if ecfg.fuse_linears and "layers" in self.params:
            from ..models.fusion import fuse_parallel_linears

            self.params = fuse_parallel_linears(self.params, fam.name)
        if ecfg.scan_layers:
            from ..models import stacking

            if not stacking.is_stacked(self.params):
                self.params = stacking.stack_layers(self.params)
            self.caches = stacking.stack_caches(self.caches)
        self.lengths = np.zeros(ecfg.n_slots, np.int32)
        self.active = np.zeros(ecfg.n_slots, bool)
        self.last_token = np.zeros(ecfg.n_slots, np.int32)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._slot_sampling: Dict[int, SamplingParams] = {}
        self._prefill_logits: Dict[int, torch.Tensor] = {}
        self._chunk_jobs: Dict[int, list] = {}  # slot -> [prompt_ids, offset]
        self.token_logprobs: Dict[int, List[float]] = {}
        # the decode step reads self.params and self.caches in place from
        # here on (its CUDA graph holds their addresses): never reassign them
        self._step = StepGraph(self)

    def _forward(self, ids: np.ndarray, caches, pos):
        """A forward of host token ids [K, T] (prefill, chunk, verify)."""
        return self._run(torch.as_tensor(ids, dtype=torch.long, device=self.device), caches, pos)

    def _run(self, ids: torch.Tensor, caches, pos):
        with torch.inference_mode(), use_kernels(self.ecfg.kernels):
            logits, _ = self.fam.forward(self.params, ids, self.cfg, kv_caches=caches, pos=pos)
        return logits

    def _tensor(self, a, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ---------------- slot management ----------------

    def free_slots(self) -> List[int]:
        return [i for i in range(self.ecfg.n_slots) if not self.active[i]]

    def can_admit(self, prompt_len: int, reserved_pages: int = 0) -> bool:
        """With a paged pool the prompt's whole bucket of pages must be
        allocatable up front, plus one page of decode headroom;
        ``reserved_pages`` counts co-admissions planned this tick but not
        yet allocated.  A free strip slot always fits."""
        if self.pool is None:
            return True
        bucket = self._bucket(prompt_len)
        return self.pool.free_pages - reserved_pages >= self.pool.pages_needed(bucket) + 1

    def release(self, slot: int) -> None:
        self.active[slot] = False
        self.lengths[slot] = 0
        self._slot_sampling.pop(slot, None)
        self._prefill_logits.pop(slot, None)
        self.token_logprobs.pop(slot, None)
        self._chunk_jobs.pop(slot, None)  # abandon any in-flight chunk job
        if self.pool is not None:
            self.pool.release(slot)
            self._refresh_table()

    def set_slot_sampling(self, slot: int, sp: Optional[SamplingParams]) -> None:
        if sp is None:
            self._slot_sampling.pop(slot, None)
        else:
            self._slot_sampling[slot] = sp

    def _sampling_for(self, slot: int) -> SamplingParams:
        return self._slot_sampling.get(slot, self.sampling)

    def greedy_ok(self) -> bool:
        """True when every slot samples greedily (the token-match verify is
        exact only then)."""
        if self.sampling.temperature != 0.0:
            return False
        return all(sp.temperature == 0.0 for sp in self._slot_sampling.values())

    def _sampling_vectors(self):
        n = self.ecfg.n_slots
        temp = np.full(n, self.sampling.temperature, np.float32)
        tk = np.full(n, self.sampling.top_k, np.int64)
        tp = np.full(n, self.sampling.top_p, np.float32)
        for s, sp in self._slot_sampling.items():
            temp[s], tk[s], tp[s] = sp.temperature, sp.top_k, sp.top_p
        return tuple(torch.as_tensor(a, device=self.device) for a in (temp, tk, tp))

    def _refresh_table(self) -> None:
        """Copy the host page table into the device table all layers share
        (every layer's row of the stacked [L] table under scan_layers)."""
        table = torch.from_numpy(self.pool.table)
        if isinstance(self.caches, dict):
            self.caches["table"][:] = table.to(self.device)
        else:
            self.caches[0]["table"].copy_(table)

    def _ensure_pages(self, slots_lengths) -> None:
        """Grow each (slot, length)'s pages; one table refresh if any grew."""
        grew = False
        for slot, length in slots_lengths:
            before = len(self.pool.owned[slot])
            self.pool.ensure(slot, length)
            grew |= len(self.pool.owned[slot]) != before
        if grew:
            self._refresh_table()

    def _grow_active(self, extra: int, what: str) -> None:
        """Pages for every active slot's next ``extra`` rows, or
        PoolExhausted before any slot grows."""
        if self.pool is None:
            return
        want = [(i, int(self.lengths[i]) + extra) for i in range(self.ecfg.n_slots)
                if self.active[i]]
        need = sum(max(0, self.pool.pages_needed(n) - len(self.pool.owned[i])) for i, n in want)
        if need > self.pool.free_pages:
            raise PoolExhausted(f"{what} needs {need} new pages, pool has "
                                f"{self.pool.free_pages} free — preempt a request")
        self._ensure_pages(want)

    # ---------------- prefill ----------------

    def _bucket(self, n: int) -> int:
        for b in self.ecfg.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket")

    def _prefill_rows(self, pairs: Sequence) -> torch.Tensor:
        """Run ``pairs`` [(slot, prompt_ids)] as one [K, bucket] forward at
        pos 0 and write their K/V: through the slots' pages (paged pool) or
        into the slots' strip rows [0, bucket).  Returns the next-token
        logits [K, V]."""
        lens = [len(p) for _, p in pairs]
        bucket = self._bucket(max(lens))
        ids = np.zeros((len(pairs), bucket), np.int64)
        for r, (_, p) in enumerate(pairs):
            ids[r, : len(p)] = p
        if self.pool is not None:
            # pages for the whole bucket: page-aligned writes, and decode
            # grows into the already-owned tail before allocating more
            self._ensure_pages([(s, bucket) for s, _ in pairs])
            slot_pages = self._tensor(np.stack([self.pool.table[s] for s, _ in pairs]))
            logits = self._forward(ids, _with_extras(self.caches, slot_pages=slot_pages), 0)
        else:
            idx = (torch.as_tensor([s for s, _ in pairs], device=self.device), slice(None, bucket))
            rows = _rows(self.caches, idx)
            logits = self._forward(ids, rows, 0)
            _set_rows(self.caches, idx, rows)
        last = torch.as_tensor([n - 1 for n in lens], device=self.device)
        return logits[torch.arange(len(pairs), device=self.device), last]

    def _finish_prompt(self, slot: int, n: int, next_logits: torch.Tensor) -> int:
        """Common prefill tail: sample the first token, activate the slot,
        keep the logits for teacher-forced scoring."""
        tok = int(sample(next_logits[None], self.generator, self._sampling_for(slot))[0])
        self.token_logprobs[slot] = [float(_chosen_logprob(next_logits, self._tensor(tok)))]
        self.lengths[slot] = n
        self.active[slot] = True
        self.last_token[slot] = tok
        self._prefill_logits[slot] = next_logits
        return tok

    def prefill(self, slot: int, prompt_ids: Sequence[int]) -> int:
        """Fill a slot's cache with the prompt; returns the first generated token."""
        return self.prefill_batch([(slot, prompt_ids)])[slot]

    def prefill_batch(self, pairs: Sequence) -> Dict[int, int]:
        """Prefill several slots in one forward (m = K·bucket through every
        linear).  With the prefix cache, prompts with a cached prefix take
        the suffix path one by one; only the misses batch (same-tick
        identical prompts do not share: a prompt's pages register only
        after its prefill).  Returns {slot: first token}."""
        pairs = list(pairs)
        for _, p in pairs:
            if len(p) >= self.ecfg.max_seq:
                raise ValueError("prompt longer than max_seq")
        out: Dict[int, int] = {}
        rest = []
        for s, p in pairs:
            matched, pages = self._match_prefix(p)
            if matched:
                out[s] = self._prefill_suffix(s, p, matched, pages)
            else:
                rest.append((s, p))
        if rest:
            next_logits = self._prefill_rows(rest)
            for r, (s, p) in enumerate(rest):
                out[s] = self._finish_prompt(s, len(p), next_logits[r])
                if self.pool is not None:
                    self.pool.register_chain(s, p)
        return out

    # ---------------- chunked prefill and prefix-cache suffixes ----------------

    def _run_window(self, slot: int, ids: np.ndarray, offset: int, n_valid: int,
                    chunk_pages: Optional[np.ndarray]) -> torch.Tensor:
        """One prompt window at global position ``offset`` with the slot's
        cache as context; returns the logits of its row n_valid-1.  Strips:
        the forward runs on a view of the slot's rows, so the write lands in
        place.  Pages: writes go through ``chunk_pages`` (the window's
        pages, trash-padded), attention through the slot's whole table row
        with base = offset."""
        if self.pool is None:
            caches = _rows(self.caches, (slice(slot, slot + 1),))
        else:
            caches = _with_extras(self.caches, slot_pages=self._tensor(chunk_pages[None]),
                                  chunk_table=self._tensor(self.pool.table[slot][None]))
        return self._forward(ids[None], caches, offset)[0, n_valid - 1]

    def start_chunked_prefill(self, slot: int, prompt_ids: Sequence[int]) -> None:
        """Begin a chunked prefill job on ``slot``; drive it with
        `prefill_chunk_step` (one chunk per call).  Decode steps for other
        slots can interleave between chunks."""
        if len(prompt_ids) >= self.ecfg.max_seq:
            raise ValueError("prompt longer than max_seq")
        if not self.ecfg.prefill_chunk:
            raise ValueError("EngineConfig.prefill_chunk is 0")
        start = 0
        matched, pages = self._match_prefix(prompt_ids)
        if matched:
            # chunk offsets stay prefill_chunk-aligned: align the hit DOWN,
            # attach only the aligned pages and start the job mid-prompt
            ps, c = self.ecfg.page_size, self.ecfg.prefill_chunk
            start = (matched * ps // c) * c
            if start:
                self.pool.attach(slot, pages[: start // ps])
                self._refresh_table()
        self._chunk_jobs[slot] = [list(prompt_ids), start]
        # PARK the slot at max_seq-1 while chunks land: batched decode steps
        # write a garbage row for every inactive slot at lengths[slot]; at 0
        # that would corrupt the chunk rows.  Position max_seq-1 is never
        # legitimately written (requests retire at lengths+1 >= max_seq), and
        # for pages it maps to the trash page or an unowned tail offset.
        self.lengths[slot] = self.ecfg.max_seq - 1

    def prefill_chunk_step(self, slot: int) -> Optional[int]:
        """Advance ``slot``'s prefill by one chunk.  Returns None while the
        prompt is unfinished; on the final chunk, activates the slot and
        returns the first generated token."""
        ids, offset = self._chunk_jobs[slot]
        c = self.ecfg.prefill_chunk
        n = len(ids)
        end = min(offset + c, n)
        chunk = np.zeros(c, np.int64)
        chunk[: end - offset] = ids[offset:end]
        chunk_pages = None
        if self.pool is not None:
            need = max(0, self.pool.pages_needed(end) - len(self.pool.owned[slot]))
            if need > self.pool.free_pages:
                raise PoolExhausted(f"prefill chunk needs {need} new pages, pool has "
                                    f"{self.pool.free_pages} free — preempt a request")
            self._ensure_pages([(slot, end)])
            ps = self.ecfg.page_size
            chunk_pages = self.pool.table[slot][offset // ps : (offset + c) // ps]
        next_logits = self._run_window(slot, chunk, offset, end - offset, chunk_pages)
        if end < n:
            self._chunk_jobs[slot][1] = end
            return None
        del self._chunk_jobs[slot]
        tok = self._finish_prompt(slot, n, next_logits)
        if self.pool is not None:
            self.pool.register_chain(slot, ids)
        return tok

    def _match_prefix(self, prompt_ids: Sequence[int]):
        """(matched_pages, page_ids) from the pool's prefix cache, capped so
        the prompt's final token always runs prefill (the next-token logits
        must come from a real forward)."""
        if self.pool is None or not self.ecfg.prefix_cache:
            return 0, []
        cap = (len(prompt_ids) - 1) // self.ecfg.page_size
        return self.pool.match_prefix(prompt_ids, cap)

    def _prefill_suffix(self, slot: int, prompt_ids: Sequence[int], matched: int,
                        pages: Sequence[int]) -> int:
        """Prefix-cache hit: adopt ``matched`` cached pages, run only the
        prompt suffix as one window (its rows attend the cached history
        through the slot's table row), then register new full pages."""
        pool, ps = self.pool, self.ecfg.page_size
        n = len(prompt_ids)
        pool.attach(slot, pages)
        self._refresh_table()
        offset = matched * ps
        c = self._bucket(n - offset)  # suffix padded to a (page-aligned) bucket
        # Clamp the ensured/written window to the bucket(n) footprint that
        # admission reserved (`can_admit`): offset + bucket(n - offset) can
        # exceed it; suffix rows past the clamp pad into the trash page.
        limit = pool.pages_needed(self._bucket(n)) * ps
        target = min(offset + c, limit, self.ecfg.max_seq)
        need = pool.pages_needed(target) - len(pool.owned[slot])
        if need > pool.free_pages:
            pool.release(slot)  # roll back the attach so preemption can retry
            pool.prefix_hit_pages -= matched
            self._refresh_table()
            raise PoolExhausted(f"prefix-hit suffix needs {need} new pages, pool has "
                                f"{pool.free_pages} free — preempt a request")
        self._ensure_pages([(slot, target)])
        row = pool.table[slot]
        chunk_pages = np.full(c // ps, pool.trash_page, np.int32)
        valid = row[offset // ps : min(pool.pages_needed(target), row.shape[0])]
        chunk_pages[: len(valid)] = valid
        ids = np.zeros(c, np.int64)
        ids[: n - offset] = prompt_ids[offset:]
        next_logits = self._run_window(slot, ids, offset, n - offset, chunk_pages)
        tok = self._finish_prompt(slot, n, next_logits)
        pool.register_chain(slot, prompt_ids)
        return tok

    # ---------------- decode ----------------

    def _step_logits(self) -> torch.Tensor:
        """One token for every slot at its own position; logits [n_slots, V]
        (on the card, the step graph's buffer: read before the next step)."""
        return self._step(self.last_token, self.lengths)

    def decode_step(self) -> Dict[int, int]:
        """Advance every active slot one token.  Returns {slot: token}."""
        if not self.active.any():
            return {}
        self._grow_active(1, "decode step")
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
            if self.pool is not None:
                self._ensure_pages([(slot, int(self.lengths[slot]) + 1)])
            logits = self._step_logits()
            nll -= float(torch.log_softmax(logits[slot].float(), dim=-1)[t])
            self.lengths[slot] += 1
            self.last_token[slot] = int(t)
        return nll / max(len(tokens), 1)

    # ---------------- speculative decoding ----------------

    def _verify_logits(self, drafts: np.ndarray) -> torch.Tensor:
        """Feed [last_token, d_1..d_γ] per slot in one forward at per-slot
        positions; logits [n_slots, γ+1, V].  The cache ends up holding rows
        for all γ+1 inputs; rows past the accepted prefix are stale but
        invisible (the causal mask admits keys < the rolled-back length) and
        the next step overwrites them in place."""
        self._grow_active(drafts.shape[1] + 1, "speculative verify")
        inputs = np.concatenate([self.last_token[:, None], drafts.astype(np.int32)], axis=1)
        return self._forward(inputs, self.caches, self._tensor(self.lengths))

    def spec_decode_step(self, drafts: np.ndarray) -> Dict[int, List[int]]:
        """Speculative decode over the slot pool.

        drafts [n_slots, γ] int (any values: a wrong draft costs only the
        wasted verify work).  Returns {slot: tokens}, the accepted draft
        prefix + one correction, 1 to γ+1 tokens per active slot.
        All-greedy pools run the token-match verify (streams EXACTLY equal
        to plain greedy decode); pools with stochastic requests run the
        rejection-sampling verify (`sampler.spec_verify_sample`)."""
        if not self.active.any():
            return {}
        gamma = drafts.shape[1]
        logits = self._verify_logits(drafts)
        if self.greedy_ok():
            preds = torch.argmax(logits, dim=-1)
            lps = _chosen_logprob(logits, preds).cpu().numpy()
            preds = preds.cpu().numpy()
            accept = drafts == preds[:, :gamma]
            corr, lp_d, lp_c = preds, lps, lps
        else:
            acc, corr, lp_d, lp_c = spec_verify_sample(
                logits, self._tensor(drafts), self.generator, *self._sampling_vectors())
            accept, corr, lp_d, lp_c = (a.cpu().numpy() for a in (acc, corr, lp_d, lp_c))
        out: Dict[int, List[int]] = {}
        for i in range(self.ecfg.n_slots):
            if not self.active[i]:
                continue
            k = 0
            while k < gamma and bool(accept[i, k]):
                k += 1
            toks = [int(t) for t in drafts[i, :k]] + [int(corr[i, k])]
            self.lengths[i] += len(toks)
            self.last_token[i] = toks[-1]
            out[i] = toks
            self.token_logprobs[i] = [float(lp_d[i, j]) for j in range(k)] + [float(lp_c[i, k])]
        return out
