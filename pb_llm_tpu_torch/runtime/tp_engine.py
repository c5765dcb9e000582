"""Tensor-parallel serving (port of `pb_llm_tpu/runtime/tp_engine.py`).

Megatron-style math over the mesh's ``tp`` ranks (BASELINE.json configs[4]):

  * q/k/v, gate/up, fc1: column-parallel (oc = heads / ffn sharded over tp),
    no collective; attention runs on the rank's head slice;
  * o_proj/out_proj, down_proj, fc2: row-parallel, partial sums
    all-reduced over tp (two collectives a decoder block), the bias added
    after the sum;
  * lm_head: column-parallel over the vocab, all-gathered for sampling;
  * KV caches: head-sharded, each rank holding its kv heads' strips or
    pages (`CACHE_SPEC`, `_cache_spec_for_key`);
  * activations replicated inside the tp group.

JAX builds a `shard_map` program for each engine program: `make_tp_step`,
`make_tp_prefill`, `make_tp_prefill_paged`, `make_tp_spec`,
`make_tp_spec_logits`, `make_tp_prefill_chunk` and `make_tp_prefill_batch`,
plus `make_caches_tp` for the strips.  The port's `Engine` sends every
forward (prefill, batched prefill, chunks, prefix suffixes, speculative
verify, and the decode step through `runtime.step_graph`) through
`Engine._run`, so `TPEngine(Engine)` replaces all of them with one
override of `_run` (the local config, `_tp_linear_fn`, the logits'
all_gather), one of the cache shape (local kv heads for strips, pages and
stacked caches) and the parameter placement (`sharding.shard_params`, then
each packed leaf's local view).  Each rank is a process
(`parallel.mesh`'s execution model).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List

import torch
import torch.distributed as dist

from .. import resolve_device
from ..core.pbw import PackedLinear, PackedLinearV2
from ..models import stacking
from ..models.linear import apply_linear
from ..models.registry import Family
from ..models.stacking import StackedPackedLinearV2
from ..ops import packed_matmul, packed_matmul_v1
from ..ops.kernel_config import current as current_kernels, use_kernels
from ..parallel.collectives import (_local_meta, all_gather_last, check_row_blocks,
                                    row_parallel_local)
from ..parallel.mesh import Mesh
from ..parallel.sharding import COL_PARALLEL, ROW_PARALLEL, P, shard_params
from . import kv_cache as kvmod
from .engine import Engine, EngineConfig
from .sampler import SamplingParams

CACHE_SPEC = P(None, None, "tp", None)
_PACKED = (PackedLinear, PackedLinearV2)


def _local_cfg(cfg, fam: Family, tp: int):
    hd = cfg.head_dim
    if fam.name == "llama":
        return dataclasses.replace(
            cfg,
            num_attention_heads=cfg.num_attention_heads // tp,
            num_key_value_heads=cfg.kv_heads // tp,
            head_dim_override=hd,
        )
    return dataclasses.replace(
        cfg, num_attention_heads=cfg.num_attention_heads // tp, head_dim_override=hd)


def _layer_key(lin) -> int:
    """The address of a linear's weight in this layer: the same on every
    call, whether ``lin`` is the tree's own leaf, a stacked layer's view
    (`stacking.take_layer`) or a stacked v2 marker."""
    if isinstance(lin, StackedPackedLinearV2):
        return lin.stacked.sign_packed[lin.idx].data_ptr()
    return (lin.sign_packed if isinstance(lin, _PACKED) else lin["w"]).data_ptr()


def _take_row_biases(params) -> Dict[int, torch.Tensor]:
    """Take every row-parallel linear's bias out of the tree, in place, so
    that no rank's partial sum carries it (a packed leaf's coefficient rows,
    made once on first use, then hold a zero bias); returns {`_layer_key`
    of each layer that had one: its bias}."""
    stacked = stacking.is_stacked(params)
    out: Dict[int, torch.Tensor] = {}
    for lp in [params["layers_stacked"]] if stacked else params["layers"]:
        for name in [n for n in lp if n in ROW_PARALLEL]:
            v = lp[name]
            if isinstance(v, _PACKED):
                bias, w = v.bias, v.sign_packed
                v.bias = v.coef_cache = None
            else:
                bias, w = v.get("b"), v["w"]
                lp[name] = dict(v, b=None)
            if bias is not None:
                out.update({w[li].data_ptr(): bias[li] for li in range(w.shape[0])} if stacked
                           else {w.data_ptr(): bias})
    return out


def _tp_linear_fn(name, lin, x, group, biases):
    """Column-parallel linears run as they are; row-parallel ones through
    `collectives.row_parallel_local` (matmul, all_reduce, then the bias
    `_take_row_biases` took out of the layer)."""
    if name not in ROW_PARALLEL:
        return apply_linear(lin, x)
    return row_parallel_local(x, lin, biases.get(_layer_key(lin)) if biases else None, group)


def _cache_spec_for_key(k: str) -> tuple:
    """Strip caches carry heads on axis 2 (k/v and int8 scale planes alike);
    paged pools carry heads on axis 1 ([P+1, H, page, D]) and the page table
    is tiny replicated int32."""
    if k in ("k_pages", "v_pages"):
        return P(None, "tp", None, None)
    if k in ("k_scale_pages", "v_scale_pages"):
        return P(None, "tp", None)
    if k == "table":
        return P()
    return CACHE_SPEC


def _cache_specs_like(caches):
    """The spec of every cache tensor: per-layer dicts, or the scan-stacked
    dict with its leading [L] axis unsharded."""
    if isinstance(caches, dict):
        return {k: P(None, *_cache_spec_for_key(k)) for k in caches}
    return [{k: _cache_spec_for_key(k) for k in c} for c in caches]


def make_caches_tp(cfg, fam: Family, mesh: Mesh, n_slots: int, max_seq: int,
                   dtype=torch.float32, device=None) -> List[Dict[str, torch.Tensor]]:
    """This rank's strip caches: [n_slots, max_seq, kv_heads/tp, head_dim]."""
    n_layers, kv_heads, head_dim = kvmod.cache_spec_for(_local_cfg(cfg, fam, mesh.tp), fam.name)
    return kvmod.make_caches(cfg, n_slots, max_seq, n_layers, kv_heads, head_dim, dtype, device)


def _packed_leaves(params):
    """(name, leaf, stacked) of every packed decoder linear."""
    if stacking.is_stacked(params):
        return [(n, v, True) for n, v in params["layers_stacked"].items() if isinstance(v, _PACKED)]
    return [(n, v, False) for lp in params["layers"] for n, v in lp.items()
            if isinstance(v, _PACKED)]


def _local_views(params, mesh: Mesh):
    """Each packed decoder linear of this rank's block with its local static
    fields (`collectives._local_meta`)."""
    tp, rank = mesh.tp, mesh.coord("tp")

    def view(n, v):
        if not isinstance(v, _PACKED) or n not in COL_PARALLEL | ROW_PARALLEL:
            return v
        return _local_meta(v, n in COL_PARALLEL, tp, rank)

    if stacking.is_stacked(params):
        return dict(params, layers_stacked={n: view(n, v)
                                            for n, v in params["layers_stacked"].items()})
    return dict(params, layers=[{n: view(n, v) for n, v in lp.items()}
                                for lp in params["layers"]])


def _check_layout(params, tp: int, sharded: bool = False) -> None:
    """What the unsharded tree (or, ``sharded``, a rank's blocks of it)
    must satisfy for tp ranks: row-parallel pack blocks and v2 sidecars
    split on shard boundaries; multi-bit v2 row-parallel layers, which the
    specs replicate, refused."""
    for name, p, _ in _packed_leaves(params):
        if name not in ROW_PARALLEL or tp == 1:
            continue
        if isinstance(p, PackedLinearV2) and p.low_bits > 1:
            raise NotImplementedError(
                f"{name}: {p.low_bits}-bit v2 row-parallel layers are replicated by the specs "
                "(plane-major sign rows); serve them without --tp")
        check_row_blocks(name, p, tp)
        if isinstance(p, PackedLinearV2) and (p.side_val.shape[-2] * (tp if sharded else 1)
                                              * (8 // p.side_bits) != tp * p.k_pad_shard):
            raise ValueError(f"row-parallel {name} over tp={tp} needs a shard-major sidecar: "
                             f"pack it with ic_shards={tp}")


def _check_kernels(local) -> None:
    """On the card every local packed layer must be taken by a kernel arm:
    a layout no arm takes would silently run the plain version."""
    from ..core.packing import default_pack_block

    for name, p, stacked in _packed_leaves(local):
        lp = stacking.layer_view(p, 0) if stacked else p
        v2 = isinstance(lp, PackedLinearV2)
        if (packed_matmul.kernel_supported_v2 if v2 else packed_matmul_v1.kernel_supported_v1)(lp):
            continue
        ic, oc, pb = lp.ic_local, lp.oc_local, lp.pack_block
        raise ValueError(
            f"{name}: no kernel arm takes its shard (ic {ic}, oc {oc}, pack_block {pb}), so on "
            f"the card it would run the plain version: the arms take oc a multiple of 128 and "
            f"a pack_block dividing ic (here e.g. {default_pack_block(ic, cap=pb)})")


class TPEngine(Engine):
    """An `Engine` over the mesh's tp ranks (usable by the
    `runtime.batching` schedulers unchanged).

    Construct it on every rank with the same UNSHARDED tree (a row-parallel
    packed layer packed with pack_block | ic/tp, a v2 one with
    ic_shards=tp): each rank keeps its block, its caches hold its kv heads,
    and every forward is the rank's share of the Megatron math.  With
    ``sharded=True`` the tree is already this rank's blocks, placed by
    `sharding.param_specs` over ``mesh`` (`shard_params`, or
    `utils.orbax_ckpt.restore_sharded` with those specs)."""

    def __init__(self, params, cfg, fam: Family, ecfg: EngineConfig, mesh: Mesh,
                 sampling: SamplingParams = SamplingParams(), device=None, seed: int = 0,
                 sharded: bool = False):
        if ecfg.fuse_linears:
            raise NotImplementedError(
                "fuse_linears under TP is unsupported: the Megatron shardings are per-name and "
                "a fused layer's oc shards would cross row-group boundaries; use per-name "
                "layers with --tp")
        if sharded and ecfg.scan_layers and not stacking.is_stacked(params):
            raise ValueError("scan_layers over a sharded tree: stack the layers before sharding")
        if ecfg.scan_layers and not stacking.is_stacked(params):
            # stack BEFORE sharding: the specs place stacked leaves with the
            # [L] axis prepended, and the layer loop runs the stacked kernels
            # on each rank's block
            params = stacking.stack_layers(params)
        tp = mesh.tp
        kvh = cfg.kv_heads if fam.name == "llama" else cfg.num_attention_heads
        if cfg.num_attention_heads % tp or kvh % tp:
            raise ValueError(f"tp={tp} must divide attention heads "
                             f"({cfg.num_attention_heads} q / {kvh} kv)")
        device = resolve_device(device)
        _check_layout(params, tp, sharded)
        local = _local_views(params if sharded else shard_params(params, mesh, fam.name), mesh)
        if device.type == "cuda" and (ecfg.kernels or current_kernels()).backend in ("auto",
                                                                                  "pallas"):
            _check_kernels(local)
        self.mesh = mesh  # before the Engine's constructor: its step graph reads it
        self.lcfg = _local_cfg(cfg, fam, tp)
        super().__init__(local, cfg, fam, ecfg, sampling, device, seed)
        # row-parallel biases come out of the engine's own (moved) leaves:
        # added once, after the sum
        self._linear_fn = functools.partial(_tp_linear_fn, group=mesh.tp_group,
                                            biases=_take_row_biases(self.params))
        # stateless per call: safe inside the stacked-layer loop (the model
        # forwards reject unmarked linear_fns there)
        self._linear_fn.scan_safe = True

    def _cache_shape(self):
        return kvmod.cache_spec_for(self.lcfg, self.fam.name)

    def _run(self, ids: torch.Tensor, caches, pos):
        with torch.inference_mode(), use_kernels(self.ecfg.kernels):
            logits, _ = self.fam.forward(self.params, ids, self.lcfg, kv_caches=caches, pos=pos,
                                         linear_fn=self._linear_fn)
            if logits.shape[-1] != self.cfg.vocab_size:  # a vocab-parallel lm_head
                logits = all_gather_last(logits, self.mesh)
        return logits

    def describe(self) -> str:
        """One line: the mesh, the backend and how the decode step and the
        prefill run."""
        step = ("graphed (collectives captured)" if self._step.capturable else
                "eager: gloo collectives cannot be captured in a CUDA graph"
                if self.device.type == "cuda" else "eager (the CPU)")
        prefill = ("eager (the paged pool)" if self.pool is not None else
                   "graphed a (K, bucket) shape" if self._prefill.capturable else step)
        return (f"TPEngine tp={self.mesh.tp} backend={self.mesh.backend} device={self.device} "
                f"local heads {self.lcfg.num_attention_heads}; decode step {step}; "
                f"prefill {prefill}")

