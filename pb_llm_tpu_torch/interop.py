"""Weight carry-over from the JAX package's parameter trees.

`from_jax_params` turns a tree of numpy arrays shaped like
`pb_llm_tpu.models.llama.init_params` output — ``embed_tokens``,
``layers[i]`` (norm vectors, ``{"w", "b"}`` dense dicts, or PackedLinearV2
leaves given as objects or dicts carrying its fields), ``norm`` and
``lm_head`` — into the port's tree of torch tensors.  The caller converts
JAX arrays with ``np.asarray`` first, so this module never sees a JAX
type.  Sign planes arrive as uint32 and are kept as bit-identical int32.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.pbw import _FIELDS_V2, PackedLinearV2, _from_numpy

_V2_STATIC = ("ic", "oc", "col_tile", "pack_block", "k_pad_shard", "side_bits", "low_bits")


def packed_from_fields(obj: Any) -> PackedLinearV2:
    """PackedLinearV2 from any object (or dict) with the v2 fields, whose
    arrays convert with ``np.asarray``."""
    get = obj.get if isinstance(obj, dict) else (lambda k, d=None: getattr(obj, k, d))
    kw = {}
    for f in _FIELDS_V2:
        v = get(f)
        kw[f] = None if v is None else _from_numpy(f, np.asarray(v))
    kw.update({f: int(get(f)) for f in _V2_STATIC if get(f) is not None})
    return PackedLinearV2(**kw)


def _is_packed(v: Any) -> bool:
    if isinstance(v, dict):
        return "sign_packed" in v
    return hasattr(v, "sign_packed") and hasattr(v, "side_idx")


def _convert(v: Any) -> Any:
    if v is None:
        return None
    if isinstance(v, PackedLinearV2):
        return v
    if _is_packed(v):
        return packed_from_fields(v)
    if isinstance(v, dict):
        return {k: _convert(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_convert(x) for x in v]
    return torch.from_numpy(np.array(np.asarray(v)))


def from_jax_params(tree: Any) -> Any:
    """The JAX package's llama parameter tree (numpy leaves) → the port's."""
    return _convert(tree)


def to_device(tree: Any, device) -> Any:
    """Move every tensor of a parameter tree to ``device`` (no copy where a
    tensor already lies there)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, PackedLinearV2):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree
