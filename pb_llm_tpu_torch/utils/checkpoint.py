"""Checkpoint save/load for parameter trees (port of
`pb_llm_tpu/utils/checkpoint.py`): one flat-key `weights.npz` plus a JSON
manifest of the tree, in the JAX package's layout, so trees cross in both
directions.  Packed leaves are stored field by field, bit planes as uint32
as in `core.pbw`: PBW v1 (`PackedLinear`) as kind "packed", PBW v2 as kind
"packed_v2".

Loaded tensors lie on the CPU; move them with `interop.to_device`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import packing
from ..core.pbw import _FIELDS, _FIELDS_V2, STATIC, STATIC_V2, PackedLinear, PackedLinearV2, \
    _to_numpy, fields_of, layer_from_arrays


def _flatten(tree: Any, prefix: str, arrays: Dict[str, np.ndarray], meta: Dict[str, Any]) -> None:
    if tree is None:
        meta[prefix] = {"kind": "none"}
    elif isinstance(tree, (PackedLinear, PackedLinearV2)):
        v2 = isinstance(tree, PackedLinearV2)
        meta[prefix] = {"kind": "packed_v2" if v2 else "packed",
                        **{f: getattr(tree, f) for f in (STATIC_V2 if v2 else STATIC)}}
        for f in fields_of(tree):
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
    if kind in ("packed", "packed_v2"):
        v2 = kind == "packed_v2"
        arrays = {f: z[f"{prefix}::{f}"] for f in (_FIELDS_V2 if v2 else _FIELDS)
                  if f"{prefix}::{f}" in z}
        static = dict(m, pack_block=m.get("pack_block", packing.PACK_BLOCK))
        return layer_from_arrays(static, arrays, v2)
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
