"""Sharded checkpoints on `torch.distributed.checkpoint` (port of
`pb_llm_tpu/utils/orbax_ckpt.py`, whose name it keeps so that a reader finds
the counterpart; the format is DCP's, not orbax's).

The flat formats (`utils.checkpoint`, `core.pbw`) gather every tensor on
one host.  Across ranks a checkpoint is written and read sharded: each rank
writes only its blocks, and a restore hands each rank its own block of the
mesh it restores onto, which need not be the mesh that saved (DCP reshards:
tp = 4 → tp = 2 → one process).

A tree is flattened to DCP's state dict by path (``layers/0/q_proj/
sign_packed``): dicts, lists and the structured leaves (`PackedLinear`,
`PackedLinearV2`, `QATLinear`, the stacked layers' leaves) by their tensor
fields.  Their static fields (ic, oc, col_tile, method, ...) are not saved:
a restore takes them, with the structure, from its template, as orbax's
restore takes JAX's treedef.  A block saved over a mesh is a
`DTensor.from_local` over a `DeviceMesh` that mirrors the port's `Mesh`
(rank r at (r // tp, r % tp)), so that DCP records each tensor's global
shape and every block's offset; replicated blocks are written once.
Tensors cross through the host (DCP writes host memory), and a restored
tensor lands on its template's device.

The port does not read JAX's orbax directories and JAX does not read the
port's: the bridge between the packages stays `interop.from_jax_params`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from ..parallel.mesh import Mesh


def _is_leaf(v: Any) -> bool:
    return isinstance(v, torch.Tensor)


def _walk(tree: Any, path: str = ""):
    """(path, tensor) of every tensor of ``tree``, depth first."""
    if _is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}" if path else str(i))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            if f.init:
                yield from _walk(getattr(tree, f.name), f"{path}/{f.name}")


def _rebuild(tree: Any, values: Dict[str, torch.Tensor], path: str = "") -> Any:
    """``tree`` with each tensor replaced by ``values[its path]``."""
    if _is_leaf(tree):
        return values[path]
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, values, f"{path}/{i}" if path else str(i)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), values, f"{path}/{f.name}")
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _specs_by_path(shardings: Any, template: Any) -> Dict[str, tuple]:
    """The spec of every tensor path of ``template`` in the spec tree
    ``shardings`` (`parallel.sharding.param_specs`: the same structure, a
    spec tuple where the tree has a tensor)."""
    out: Dict[str, tuple] = {}

    def walk(t, s, path):
        if s is None:
            return
        if _is_leaf(t):
            out[path] = s
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, s.get(k) if isinstance(s, dict) else None, f"{path}/{k}" if path else str(k))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, s[i], f"{path}/{i}" if path else str(i))
        elif dataclasses.is_dataclass(t) and not isinstance(t, type):
            for f in dataclasses.fields(t):
                if f.init:
                    walk(getattr(t, f.name), getattr(s, f.name, None), f"{path}/{f.name}")

    walk(template, shardings, "")
    return out


def _device_mesh(mesh: Mesh):
    """A DeviceMesh over the host that mirrors ``mesh`` (axes dp, tp).  Its
    groups carry no tensor data here (DCP plans over the default group)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(mesh.dp * mesh.tp).reshape(mesh.dp, mesh.tp),
                      mesh_dim_names=("dp", "tp"))


def _placements(spec: tuple):
    from torch.distributed.tensor import Replicate, Shard

    if any(isinstance(ax, tuple) for ax in spec):
        raise NotImplementedError(f"a spec with a tuple of axes: {spec}")
    return [Shard(spec.index(axis)) if axis in spec else Replicate() for axis in ("dp", "tp")]


def _dtensor(block: torch.Tensor, spec: tuple, mesh: Mesh, dm):
    """``block`` as the DTensor of its global tensor under ``spec``."""
    from torch.distributed.tensor import DTensor

    shape = list(block.shape)
    for d, ax in enumerate(spec):
        if ax is not None:
            shape[d] *= mesh.shape[ax]
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(block, dm, _placements(spec), run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _process_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def save_sharded(path: str, tree: Any, mesh: Optional[Mesh] = None,
                 shardings: Optional[Any] = None) -> None:
    """Write ``tree`` to the DCP directory ``path``.  Without a mesh: whole
    tensors (from one process, or from every rank of a process group with
    the same tree, written once).  With ``mesh`` and ``shardings`` (the spec
    tree the blocks were placed by, `parallel.sharding.param_specs` of the
    global tree): every rank calls it with its own blocks and writes only
    its shards."""
    path = os.path.abspath(path)
    specs = _specs_by_path(shardings, tree) if mesh is not None and shardings is not None else {}
    dm = _device_mesh(mesh) if specs else None
    state = {}
    for p, t in _walk(tree):
        block = t.detach().cpu()
        spec = specs.get(p)
        state[p] = _dtensor(block, spec, mesh, dm) if spec else block
    dcp.save(state, checkpoint_id=path, no_dist=not _process_group())


def restore_sharded(path: str, template: Any, mesh: Optional[Mesh] = None,
                    shardings: Optional[Any] = None) -> Any:
    """Restore a tree saved with `save_sharded` (at any mesh).

    ``template`` gives the structure, the static fields, the dtypes and the
    GLOBAL shapes (a tree of tensors; meta tensors will do), and each
    tensor's device (the host for a meta one).  Without a mesh the tree
    comes back whole, in one process or on each rank of a process group;
    with ``mesh`` and ``shardings`` (a spec tree, `param_specs`) each rank
    gets its own block of every tensor, as `sharding.shard_params` would
    cut it."""
    path = os.path.abspath(path)
    specs = (_specs_by_path(shardings, template)
             if mesh is not None and shardings is not None else {})
    dm = _device_mesh(mesh) if specs else None
    state, devices = {}, {}
    for p, t in _walk(template):
        spec = specs.get(p)
        shape = list(t.shape)
        if spec:
            for d, ax in enumerate(spec):
                if ax is not None:
                    shape[d] //= mesh.shape[ax]
        block = torch.empty(shape, dtype=t.dtype)
        state[p] = _dtensor(block, spec, mesh, dm) if spec else block
        devices[p] = (torch.device("cpu") if t.device.type == "meta" else t.device,
                      t.requires_grad)
    dcp.load(state, checkpoint_id=path, no_dist=not _process_group())
    values = {}
    for p, v in state.items():
        local = v.to_local() if _is_dtensor(v) else v
        dev, grad = devices[p]
        values[p] = local.to(dev).requires_grad_(grad) if grad else local.to(dev)
    return _rebuild(template, values)


def _is_dtensor(v) -> bool:
    """Whether ``v`` is a DTensor (a block of a sharded restore)."""
    from torch.distributed.tensor import DTensor

    return isinstance(v, DTensor)


def bytes_on_disk(path: str) -> int:
    """The bytes of every file of a checkpoint directory."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
