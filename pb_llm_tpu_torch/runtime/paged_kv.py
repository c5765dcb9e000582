"""Paged KV-cache pool (port of `pb_llm_tpu/runtime/paged_kv.py`): global
page tensors on the engine's device plus host-side page tables.

A pool of fixed-size pages shared by all slots replaces the [n_slots,
max_seq] strips (`runtime.kv_cache`): memory per request is
ceil(len/page)·page rows instead of max_seq.  Pages live in head-major
[n_pages + 1, Hkv, page, D] tensors per layer; slots reference them through
an int32 page table that the paged-attention kernel reads
(`ops.paged_attention`).

Allocation is host-side and incremental: `ensure(slot, length)` grows the
slot's page list from a free list; `release(slot)` returns pages.  Table
rows always hold VALID page indices (unused entries point at the trash
page) because the kernel masks by length, not by a table sentinel.

**Prefix caching** (``prefix_cache=True``): full prompt pages are indexed by
a rolling chain hash over their token ids (page i's key covers tokens
[0, (i+1)·page), exactly the causal dependency of its K/V rows), so a new
request whose prompt shares a page-aligned prefix with an earlier prompt
ATTACHES the cached pages (refcount++) instead of recomputing them; only
the suffix runs prefill (`Engine._prefill_suffix`).  Shared full pages are
read-only by construction: every write lands at positions >= the writing
slot's length, past every full shared page, so no copy-on-write is needed.
Released pages whose refcount reaches 0 stay cached in an LRU
(`evictable`) and are reclaimed only when allocation would otherwise fail.
The bookkeeping is the JAX package's, hash seed included, so both pools
driven through the same calls hold the same tables.

The port writes pages IN PLACE (`write_tokens`, `write_prompts`), where
JAX returns new arrays.  JAX's single-token `write_token` and single-prompt
`write_prompt` are the t = 1 and K = 1 cases of these two.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

_CHAIN_SEED = 0x9E3779B9  # fixed root of the page-chain hash


class PagePool:
    def __init__(self, n_pages: int, page_size: int, n_slots: int, max_seq: int,
                 prefix_cache: bool = False):
        """Host-side page bookkeeping; the page tensors live in the engine's
        per-layer cache dicts (`make_layer_cache`).

        One extra TRASH page (index ``n_pages``) absorbs writes from
        inactive slots: their table rows point at it, so the batched decode
        write (which scatters for every slot, active or not) can never
        corrupt a live page.  Reads from it are masked by length."""
        if max_seq % page_size:
            raise ValueError(f"max_seq {max_seq} not divisible by page_size {page_size}")
        self.page_size = page_size
        self.n_pages = n_pages
        self.trash_page = n_pages  # tensors are sized n_pages + 1
        self.max_pages_per_slot = max_seq // page_size
        self.n_slots = n_slots
        self.table = np.full((n_slots, self.max_pages_per_slot), self.trash_page, np.int32)
        self.owned: List[List[int]] = [[] for _ in range(n_slots)]
        self.free_list: List[int] = list(range(n_pages - 1, -1, -1))
        self.prefix_cache = prefix_cache
        self.ref = np.zeros(n_pages, np.int32)       # owners per page
        self.hash_page: Dict[int, int] = {}          # chain hash -> page id
        self.page_hash: Dict[int, int] = {}          # page id -> chain hash
        self.evictable: "OrderedDict[int, None]" = OrderedDict()  # ref == 0, cached (LRU)
        self.prefix_queries = 0
        self.prefix_hit_pages = 0

    # -- host-side bookkeeping ----------------------------------------------

    def pages_needed(self, length: int) -> int:
        return -(-length // self.page_size)

    def can_admit(self, length: int) -> bool:
        return self.free_pages >= self.pages_needed(length)

    def _alloc_page(self) -> int:
        if self.free_list:
            pg = self.free_list.pop()
        elif self.evictable:
            # reclaim the least-recently-released cached page
            pg, _ = self.evictable.popitem(last=False)
            h = self.page_hash.pop(pg)
            self.hash_page.pop(h, None)
        else:
            raise RuntimeError("page pool exhausted")
        self.ref[pg] = 1
        return pg

    def ensure(self, slot: int, length: int) -> None:
        """Grow slot's page list to cover ``length`` tokens."""
        need = self.pages_needed(length)
        if need > self.max_pages_per_slot:
            raise ValueError(f"length {length} exceeds max_seq")
        while len(self.owned[slot]) < need:
            pg = self._alloc_page()
            self.table[slot, len(self.owned[slot])] = pg
            self.owned[slot].append(pg)

    def release(self, slot: int) -> None:
        for pg in reversed(self.owned[slot]):
            self.ref[pg] -= 1
            if self.ref[pg] == 0:
                if pg in self.page_hash:  # stays cached, reclaimable (LRU)
                    self.evictable[pg] = None
                else:
                    self.free_list.append(pg)
        self.owned[slot] = []
        self.table[slot, :] = self.trash_page

    @property
    def free_pages(self) -> int:
        """Allocatable pages: truly free + cached-but-unreferenced."""
        return len(self.free_list) + len(self.evictable)

    # -- prefix cache --------------------------------------------------------

    def _chain_hashes(self, tokens: Sequence[int], n_full: int) -> List[int]:
        """Rolling hashes h_i over tokens[0:(i+1)·page] for i < n_full."""
        ps = self.page_size
        out, h = [], _CHAIN_SEED
        for i in range(n_full):
            h = hash((h, tuple(tokens[i * ps : (i + 1) * ps])))
            out.append(h)
        return out

    def match_prefix(self, tokens: Sequence[int], max_pages: int) -> Tuple[int, List[int]]:
        """Longest cached page chain covering tokens' page-aligned prefix,
        capped at ``max_pages`` (callers cap at (len-1)//page so at least one
        token always runs prefill).  Returns (n_pages, page_ids); the pages
        are NOT attached yet (`attach` does the refcounting)."""
        if not self.prefix_cache or max_pages <= 0:
            return 0, []
        self.prefix_queries += 1
        pages: List[int] = []
        for h in self._chain_hashes(tokens, max_pages):
            pg = self.hash_page.get(h)
            if pg is None:
                break
            pages.append(pg)
        return len(pages), pages

    def attach(self, slot: int, pages: Sequence[int]) -> None:
        """Adopt cached pages as the slot's leading table entries (ref++);
        `prefix_hit_pages` counts the pages actually adopted."""
        if self.owned[slot]:
            raise RuntimeError(f"attach on non-empty slot {slot}")
        for i, pg in enumerate(pages):
            if self.ref[pg] == 0:
                self.evictable.pop(pg, None)
            self.ref[pg] += 1
            self.table[slot, i] = pg
            self.owned[slot].append(pg)
        self.prefix_hit_pages += len(pages)

    def register_chain(self, slot: int, tokens: Sequence[int]) -> None:
        """Index the slot's full prompt pages by chain hash (first writer
        wins).  Call AFTER the prompt's K/V rows are written."""
        if not self.prefix_cache:
            return
        n_full = min(len(tokens) // self.page_size, len(self.owned[slot]))
        for i, h in enumerate(self._chain_hashes(tokens, n_full)):
            pg = self.owned[slot][i]
            if h not in self.hash_page and pg not in self.page_hash:
                self.hash_page[h] = pg
                self.page_hash[pg] = h

    def make_layer_cache(self, n_layers: int, kv_heads: int, head_dim: int,
                         dtype=torch.float32, device=None) -> List[Dict[str, torch.Tensor]]:
        """Per-layer paged cache dicts on ``device``: head-major pages
        [P+1, Hkv, page, D] (the +1 is the trash page), f32, bf16, or int8
        with f32 absmax scale planes [P+1, Hkv, page] (the scheme of the
        int8 strip cache).  Every layer dict holds the SAME device table tensor [n_slots,
        maxp] int32; the engine refreshes it in place when the host table
        changes (JAX keeps one copy per layer only because it donates
        buffers)."""
        shape = (self.n_pages + 1, kv_heads, self.page_size, head_dim)
        table = torch.as_tensor(self.table, device=device).clone()

        def layer():
            cache = {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
                     "v_pages": torch.zeros(shape, dtype=dtype, device=device),
                     "table": table}
            if dtype == torch.int8:
                cache["k_scale_pages"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
                cache["v_scale_pages"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
            return cache

        return [layer() for _ in range(n_layers)]


# -- device-side writes, in place ---------------------------------------------
#
# Duplicate (page, offset) targets in one write land only on the trash page
# (inactive slots all point there; prefill windows pad with it) or, for a
# parked slot's window clamped to max_seq-1, on a tail offset that no slot
# owns as valid data.  So CUDA's undefined order among duplicate
# `index_put_` writes is harmless.


def write_tokens(pages: torch.Tensor, new: torch.Tensor, page_ids: torch.Tensor,
                 offsets: torch.Tensor) -> None:
    """In place: t new KV tokens per slot (t = 1 at decode, γ+1 at
    speculative verify).  pages [P+1, H, page, D] head-major (or
    [P+1, H, page] scale planes), new [B, t, H, D] (or [B, t, H]),
    page_ids/offsets [B, t]: a slot's tokens may span a page boundary (the
    table lookup is per token); inactive slots' rows point at the trash
    page."""
    b, t = page_ids.shape
    pages[page_ids.reshape(-1), :, offsets.reshape(-1)] = (
        new.reshape(b * t, *new.shape[2:]).to(pages.dtype))


def write_prompts(pages: torch.Tensor, seqs: torch.Tensor, slot_pages: torch.Tensor) -> None:
    """In place: whole (padded) prompts into their slots' pages.  seqs
    [K, T_pad, H, D] (or [K, T_pad, H]) with T_pad % page == 0, slot_pages
    [K, >= T_pad/page].  Positions past a prompt's true length land in
    their page too: masked by length at read time, overwritten by decode."""
    page = pages.shape[2]
    k, t_pad = seqs.shape[:2]
    n = t_pad // page
    # [K, n, page, H, ...] -> [K, n, H, page, ...]
    blocks = seqs.reshape(k, n, page, *seqs.shape[2:]).transpose(2, 3)
    pages[slot_pages[:, :n].reshape(-1)] = blocks.reshape(k * n, *blocks.shape[2:]).to(pages.dtype)
