"""Sharding rules for model parameter trees (port of
`pb_llm_tpu/parallel/sharding.py`): dense, PBW v1, PBW v2 and QAT leaves.

Megatron-style tensor parallelism over the ``tp`` mesh axis:

  column-parallel (shard oc):  q/k/v (heads), gate/up, fc1, lm_head
  row-parallel   (shard ic):  o_proj/out_proj, down_proj, fc2

so each decoder block needs two all-reduces (after the attention output and
after the MLP's down projection), which the TP engine issues
(`runtime.tp_engine._tp_linear_fn`).  Norms and the row-parallel group
scales are replicated.

A spec is a tuple with one entry per dimension: a mesh axis name or None
(JAX's `PartitionSpec`, entry for entry; ``P()`` is ``()``).  Structured
leaves get a spec of their own type: a PackedLinear / PackedLinearV2 /
QATLinear whose tensor fields hold specs and whose static fields are the
leaf's, or a dense ``{"w", "b"}`` dict of specs.

`shard_params` slices each tensor to THIS rank's block (`parallel.mesh`'s
execution model: every rank holds the unsharded tree and keeps its block),
and `gather_params` is its inverse (every rank gets the whole tree back);
the static ``ic`` / ``oc`` / ``groupsize`` of its packed leaves stay the
global ones, as in JAX's sharded tree.  The local view a rank computes with
(those fields as JAX's `_local_meta` makes them inside the body) is
`parallel.collectives.local_linear`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..core.pbw import PackedLinear, PackedLinearV2
from ..quant.qat import QATLinear
from .mesh import Mesh, local_block

# which linears shard which way, per family
COL_PARALLEL = {"q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "fc1", "lm_head"}
ROW_PARALLEL = {"o_proj", "out_proj", "down_proj", "fc2"}
_STRUCTURED = (PackedLinear, PackedLinearV2, QATLinear)


def P(*axes) -> tuple:
    """A spec: one mesh axis name (or None) per dimension."""
    return tuple(axes)


def _replicate_tree(v: Any) -> Any:
    """P() at every tensor of ``v`` (JAX's ``tree_map(lambda _: P(), v)``)."""
    if v is None:
        return None
    if isinstance(v, dict):
        return {k: _replicate_tree(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_replicate_tree(x) for x in v]
    return P()


def _dense_spec(name: str) -> Dict[str, tuple]:
    if name in COL_PARALLEL:
        return {"w": P(None, "tp"), "b": P("tp")}
    if name in ROW_PARALLEL:
        return {"w": P("tp", None), "b": P()}
    return {"w": P(), "b": P()}


def _packed_spec(name: str) -> PackedLinear:
    if name in COL_PARALLEL:
        return PackedLinear(
            sign_packed=P(None, "tp"), mask_packed=P(None, "tp"), sidecar=P(None, "tp"),
            low_scale=P(None, "tp"), low_mean=P(None, "tp"),
            high_scale=P("tp"), high_zero=P("tp"), bias=P("tp"),
            ic=0, oc=0, groupsize=0,
        )
    if name in ROW_PARALLEL:
        # group scales stay replicated: with groupsize=-1 they are [1, oc]
        # (indivisible), and they are tiny either way; each rank takes its
        # own group rows in its local view (`collectives.local_linear`)
        return PackedLinear(
            sign_packed=P("tp", None), mask_packed=P("tp", None), sidecar=P("tp", None),
            low_scale=P(), low_mean=P(),
            high_scale=P(), high_zero=P(), bias=P(),
            ic=0, oc=0, groupsize=0,
        )
    raise ValueError(name)


def _packed_v2_spec(name: str, n_row_groups: int = 0) -> PackedLinearV2:
    if name in COL_PARALLEL:
        # oc shards every plane; side_idx row groups shard with oc.  Global
        # column selection (n_row_groups == 1) shares ONE column set across
        # all oc shards: side_idx replicates.
        return PackedLinearV2(
            sign_packed=P(None, "tp"), side_val=P(None, "tp"),
            side_idx=P() if n_row_groups == 1 else P(None, "tp"),
            low_scale=P(None, "tp"), low_mean=P(None, "tp"),
            high_scale=P("tp"), high_zero=P("tp"), bias=P("tp"),
            ic=0, oc=0, col_tile=0,
        )
    if name in ROW_PARALLEL:
        # shard-major sidecar (packed with ic_shards=tp): axis 0 of
        # side_val/side_idx splits into per-shard [k_pad_shard, ·] blocks
        # with local indices; sign word-rows split on shard boundaries
        return PackedLinearV2(
            sign_packed=P("tp", None), side_val=P("tp", None), side_idx=P("tp", None),
            low_scale=P(), low_mean=P(),
            high_scale=P(), high_zero=P(), bias=P(),
            ic=0, oc=0, col_tile=0,
        )
    raise ValueError(name)


def _qat_spec(name: str) -> QATLinear:
    # QAT weight is [oc, ic]: column-parallel shards axis 0, row-parallel axis 1
    if name in COL_PARALLEL:
        return QATLinear(weight=P("tp", None), bias=P("tp"), outlier_mask=P("tp", None))
    if name in ROW_PARALLEL:
        return QATLinear(weight=P(None, "tp"), bias=P(), outlier_mask=P(None, "tp"))
    return QATLinear(weight=P(), bias=P(), outlier_mask=P())


def _v2_leaf_spec(name: str, leaf: PackedLinearV2, n_row_groups: int) -> PackedLinearV2:
    spec = _packed_v2_spec(name, n_row_groups)
    if leaf.low_bits > 1 and name in ROW_PARALLEL:
        # plane-major sign axis 0 cannot split over tp without mixing planes:
        # multi-bit row-parallel layers replicate (the 2/4-bit ablation
        # formats; the flagship 1-bit layout shards fully)
        spec = dataclasses.replace(spec, sign_packed=P(), side_val=P(), side_idx=P())
    return dataclasses.replace(
        spec,
        bias=None if leaf.bias is None else spec.bias,
        ic=leaf.ic, oc=leaf.oc, col_tile=leaf.col_tile,
        pack_block=leaf.pack_block, k_pad_shard=leaf.k_pad_shard,
    )


def _leaf_spec(name: str, leaf: Any) -> Any:
    if isinstance(leaf, PackedLinearV2):
        return _v2_leaf_spec(name, leaf, leaf.n_row_groups)
    if isinstance(leaf, PackedLinear):
        spec = _packed_spec(name)
        return dataclasses.replace(
            spec,
            bias=None if leaf.bias is None else spec.bias,
            ic=leaf.ic, oc=leaf.oc, groupsize=leaf.groupsize, pack_block=leaf.pack_block,
            sidecar_bits=leaf.sidecar_bits, low_bits=leaf.low_bits,
        )
    if isinstance(leaf, QATLinear):
        spec = _qat_spec(name)
        return dataclasses.replace(
            spec,
            bias=None if leaf.bias is None else spec.bias,
            method=leaf.method, outlier_scale=leaf.outlier_scale,
            train_outlier=leaf.train_outlier,
        )
    if isinstance(leaf, dict) and "w" in leaf:
        d = _dense_spec(name)
        if leaf.get("b") is None:
            d = {"w": d["w"], "b": None}
        return d
    return None


def _add_fsdp(spec: Any, leaf: Any, dp: int) -> Any:
    """Add 'dp' to the first free DIVISIBLE dim of a >=2-D tensor's spec
    (FSDP/ZeRO-3 storage sharding).  Specs already using dp, scalars and
    vectors are untouched.  Divisibility is checked here, per dim: handing
    sanitize_specs a bad dim would replicate the whole leaf, dropping its
    tp sharding."""
    if not isinstance(spec, tuple) or getattr(leaf, "ndim", 0) < 2 or dp <= 1:
        return spec
    used = {a for ax in spec for a in (ax if isinstance(ax, tuple) else (ax,)) if a is not None}
    if "dp" in used:
        return spec
    dims = list(spec) + [None] * (leaf.ndim - len(spec))
    for d in range(leaf.ndim):
        if dims[d] is None and leaf.shape[d] % dp == 0:
            dims[d] = "dp"
            return P(*dims)
    return spec


def _fsdp_leaf(spec: Any, leaf: Any, dp: int) -> Any:
    """FSDP-ify one leaf spec: QATLinear weight and outlier_mask, a dense
    dict's w, plain tensors.  Packed (inference) formats are skipped: their
    plane layout invariants are all-or-nothing (see sanitize_specs)."""
    if isinstance(spec, QATLinear):
        return dataclasses.replace(
            spec,
            weight=_add_fsdp(spec.weight, leaf.weight, dp),
            outlier_mask=_add_fsdp(spec.outlier_mask, leaf.outlier_mask, dp),
        )
    if isinstance(spec, dict) and "w" in spec:
        return dict(spec, w=_add_fsdp(spec["w"], leaf.get("w"), dp))
    if isinstance(spec, tuple):
        return _add_fsdp(spec, leaf, dp)
    return spec


def _prepend_layer_axis(spec: Any) -> Any:
    """[L]-stacked leaves (models.stacking) keep their per-layer sharding
    with the leading layer axis unsharded: P(a, b) → P(None, a, b)."""
    if isinstance(spec, tuple):
        return P(None, *spec)
    if dataclasses.is_dataclass(spec):
        repl = {f.name: P(None, *getattr(spec, f.name)) for f in dataclasses.fields(spec)
                if isinstance(getattr(spec, f.name), tuple)}
        return dataclasses.replace(spec, **repl)
    if isinstance(spec, dict):
        return {k: (P(None, *v) if isinstance(v, tuple) else v) for k, v in spec.items()}
    return spec


def param_specs(params: Dict[str, Any], family_name: str, mesh: Optional[Mesh] = None,
                fsdp: bool = False) -> Dict[str, Any]:
    """The spec tree matching the model's parameter tree.

    With ``mesh`` given, a leaf whose sharded dimension does not divide by
    the mesh axis falls back to replication (an odd vocab under a
    vocab-parallel lm_head): placement and compute must use the SAME
    sanitized tree.

    ``fsdp=True`` also shards every >=2-D leaf's first free divisible
    dimension over ``dp`` (FSDP / ZeRO-3 storage); the trainer gathers each
    where it is used (`train.qat` under a mesh, `collectives.fsdp_gather`)."""
    specs: Dict[str, Any] = {}
    for key, val in params.items():
        if key == "layers":
            specs["layers"] = [
                {n: _leaf_spec(n, leaf) or _replicate_tree(leaf) for n, leaf in lp.items()}
                for lp in val]
        elif key == "layers_stacked":
            # stacked v2 leaves carry an [L]-leading side_idx: the row
            # groups are its last dim
            specs[key] = {
                n: _prepend_layer_axis(
                    (_v2_leaf_spec(n, leaf, leaf.side_idx.shape[-1])
                     if isinstance(leaf, PackedLinearV2) else _leaf_spec(n, leaf))
                    or _replicate_tree(leaf))
                for n, leaf in val.items()}
        elif key == "num_layers":
            specs[key] = P()  # Python int metadata; shard_params passes it through
        elif key == "lm_head":
            specs[key] = _leaf_spec(key, val) or _replicate_tree(val)
        elif key in ("embed_tokens", "embed_positions"):
            specs[key] = P()  # replicated; vocab sharding is a later optimization
        else:
            specs[key] = _replicate_tree(val)

    if fsdp:
        dp = mesh.shape.get("dp", 1) if mesh is not None else 1
        for key, spec in specs.items():
            if key == "layers":
                specs[key] = [{n: _fsdp_leaf(s, lp[n], dp) for n, s in lspec.items()}
                              for lp, lspec in zip(params["layers"], spec)]
            elif spec is not None:
                specs[key] = _fsdp_leaf(spec, params.get(key), dp)

    if mesh is not None:
        specs = sanitize_specs(params, specs, mesh)
    return specs


def sanitize_specs(params: Dict[str, Any], specs: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """Replicate any leaf whose sharded dims do not divide by the mesh axes.

    Structured leaves (PackedLinear / PackedLinearV2 / QATLinear / dense
    dicts) are sanitized ALL-OR-NOTHING: a partly replicated packed layer
    would have inconsistent local plane shapes."""
    sizes = dict(mesh.shape)

    def _arr_ok(arr, spec) -> bool:
        if arr is None or spec is None or not isinstance(spec, tuple):
            return True
        for d, ax in enumerate(spec):
            if ax is None:
                continue
            n = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n *= sizes.get(a, 1)
            if d >= getattr(arr, "ndim", 0) or arr.shape[d] % n:
                return False
        return True

    def _replicate_like(spec):
        if isinstance(spec, tuple):
            return P()
        if dataclasses.is_dataclass(spec):
            return dataclasses.replace(spec, **{f.name: P() for f in dataclasses.fields(spec)
                                                if isinstance(getattr(spec, f.name), tuple)})
        if isinstance(spec, dict):
            return {k: (P() if isinstance(v, tuple) else v) for k, v in spec.items()}
        return spec

    def _san(leaf, spec):
        if leaf is None or spec is None:
            return spec
        if dataclasses.is_dataclass(spec):
            pairs = [(getattr(leaf, f.name, None), getattr(spec, f.name))
                     for f in dataclasses.fields(spec)]
        elif isinstance(spec, dict):
            pairs = [(leaf.get(k), v) for k, v in spec.items()]
        else:
            pairs = [(leaf, spec)]
        return spec if all(_arr_ok(a, s) for a, s in pairs) else _replicate_like(spec)

    out: Dict[str, Any] = {}
    for key, spec in specs.items():
        if key == "layers":
            out["layers"] = [{n: _san(lp[n], s) for n, s in lspec.items()}
                             for lp, lspec in zip(params["layers"], spec)]
        elif key == "layers_stacked":
            out[key] = {n: _san(params[key][n], s) for n, s in spec.items()}
        else:
            out[key] = _san(params.get(key), spec)
    return out


def _shard(leaf: Any, spec: Any, mesh: Mesh) -> Any:
    if leaf is None or spec is None or isinstance(leaf, (int, float, str)):
        return leaf
    if isinstance(leaf, torch.Tensor):
        block = local_block(leaf, spec, mesh)
        # a sharded block is copied, so that the unsharded tree can go; a
        # trainable leaf's block is a leaf that trains
        if block.shape == leaf.shape:
            return leaf
        return block.detach().clone().requires_grad_(leaf.requires_grad)
    if isinstance(leaf, _STRUCTURED):
        return dataclasses.replace(leaf, **{
            f.name: _shard(getattr(leaf, f.name), getattr(spec, f.name), mesh)
            for f in dataclasses.fields(leaf)
            if f.init and isinstance(getattr(leaf, f.name), torch.Tensor)})
    if isinstance(leaf, dict):
        return {k: _shard(v, spec[k], mesh) for k, v in leaf.items()}
    if isinstance(leaf, (list, tuple)):
        return [_shard(v, s, mesh) for v, s in zip(leaf, spec)]
    raise TypeError(f"shard_params: unexpected leaf {type(leaf).__name__}")


def shard_params(params: Dict[str, Any], mesh: Mesh, family_name: str,
                 fsdp: bool = False) -> Dict[str, Any]:
    """This rank's block of every tensor of the tree under `param_specs`
    (JAX's `shard_params` places the global arrays; here each rank keeps
    its own block, the `addressable_shards` of its device)."""
    return _shard(params, param_specs(params, family_name, mesh, fsdp=fsdp), mesh)


def _unshard(leaf: Any, spec: Any, mesh: Mesh) -> Any:
    if leaf is None or spec is None or isinstance(leaf, (int, float, str)):
        return leaf
    if isinstance(leaf, torch.Tensor):
        groups = {"tp": mesh.tp_group, "dp": mesh.dp_group}
        for d in reversed(range(len(spec))):  # a tuple entry: its minor axis first
            for ax in reversed(spec[d] if isinstance(spec[d], tuple) else (spec[d],)):
                if ax is None or mesh.shape[ax] == 1:
                    continue
                parts = [torch.empty_like(leaf) for _ in range(mesh.shape[ax])]
                dist.all_gather(parts, leaf.contiguous(), group=groups[ax])
                leaf = torch.cat(parts, dim=d)
        return leaf
    if isinstance(leaf, _STRUCTURED):
        return dataclasses.replace(leaf, **{
            f.name: _unshard(getattr(leaf, f.name), getattr(spec, f.name), mesh)
            for f in dataclasses.fields(leaf)
            if f.init and isinstance(getattr(leaf, f.name), torch.Tensor)})
    if isinstance(leaf, dict):
        return {k: _unshard(v, spec[k], mesh) for k, v in leaf.items()}
    if isinstance(leaf, (list, tuple)):
        return [_unshard(v, s, mesh) for v, s in zip(leaf, spec)]
    raise TypeError(f"gather_params: unexpected leaf {type(leaf).__name__}")


def gather_params(params: Dict[str, Any], mesh: Mesh, specs: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of `shard_params`: every rank gets the whole tree back,
    each block all-gathered along the dimensions ``specs`` split (a
    collective: every rank calls it).  ``specs`` is the tree `shard_params`
    placed the blocks by, `param_specs(global tree, family, mesh, fsdp=)`: a
    block's shape cannot tell which dimension an axis split (under dp = 2 a
    [3, 4] block is a [6, 4] or a [3, 8] leaf), so the specs come from the
    global tree.  Tensors come back detached from any autograd graph."""
    with torch.no_grad():
        return _unshard(params, specs, mesh)


def kv_cache_spec() -> tuple:
    """[B, T, heads, head_dim]: batch over dp, heads over tp."""
    return P("dp", None, "tp", None)
