"""Checkpoint save/load for parameter trees (port of
`pb_llm_tpu/utils/checkpoint.py`): one flat-key `weights.npz` plus a JSON
manifest of the tree, in the JAX package's layout, so dense trees cross in
both directions.  PBW-v2 leaves are stored field by field (kind
"packed_v2"; sign planes as uint32, as in `core.pbw`).  PBW v1
(`PackedLinear`, kind "packed") is not ported yet and raises.

Loaded tensors lie on the CPU; move them with `interop.to_device`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import packing
from ..core.pbw import _FIELDS_V2, PackedLinearV2, _from_numpy, _to_numpy

_V2_STATIC = ("ic", "oc", "col_tile", "pack_block", "k_pad_shard", "side_bits", "low_bits")


def _flatten(tree: Any, prefix: str, arrays: Dict[str, np.ndarray], meta: Dict[str, Any]) -> None:
    if tree is None:
        meta[prefix] = {"kind": "none"}
    elif isinstance(tree, PackedLinearV2):
        meta[prefix] = {"kind": "packed_v2", **{f: getattr(tree, f) for f in _V2_STATIC}}
        for f in _FIELDS_V2:
            v = getattr(tree, f)
            if v is not None:
                arrays[f"{prefix}::{f}"] = _to_numpy(f, v)
    elif isinstance(tree, dict):
        meta[prefix] = {"kind": "dict", "keys": sorted(tree.keys())}
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", arrays, meta)
    elif isinstance(tree, (list, tuple)):
        meta[prefix] = {"kind": "list", "n": len(tree)}
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", arrays, meta)
    elif isinstance(tree, torch.Tensor):
        meta[prefix] = {"kind": "array"}
        arrays[prefix] = tree.detach().cpu().numpy()
    else:
        raise TypeError(f"{prefix}: cannot checkpoint a {type(tree).__name__}")


def _unflatten(prefix: str, z, meta: Dict[str, Any]):
    m = meta[prefix]
    kind = m["kind"]
    if kind == "none":
        return None
    if kind == "array":
        return torch.from_numpy(np.array(z[prefix]))
    if kind == "dict":
        return {k: _unflatten(f"{prefix}/{k}", z, meta) for k in m["keys"]}
    if kind == "list":
        return [_unflatten(f"{prefix}/{i}", z, meta) for i in range(m["n"])]
    if kind == "packed_v2":
        kw = {f: _from_numpy(f, z[f"{prefix}::{f}"]) for f in _FIELDS_V2 if f"{prefix}::{f}" in z}
        kw.setdefault("bias", None)
        static = {f: m[f] for f in _V2_STATIC if f in m}
        static.setdefault("pack_block", packing.PACK_BLOCK)
        return PackedLinearV2(**static, **kw)
    if kind == "packed":
        raise NotImplementedError(f"{prefix}: PBW v1 (PackedLinear) is not ported yet (ROADMAP: PBW v1)")
    raise ValueError(kind)


def save_dense_checkpoint(path: str, params: Any, extra: Optional[dict] = None) -> None:
    os.makedirs(path, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {}
    _flatten(params, "params", arrays, meta)
    np.savez(os.path.join(path, "weights.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as fh:
        json.dump({"tree": meta, "extra": extra or {}}, fh)


def load_dense_checkpoint(path: str) -> Tuple[Any, dict]:
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    with np.load(os.path.join(path, "weights.npz")) as z:
        params = _unflatten("params", z, manifest["tree"])
    return params, manifest["extra"]
