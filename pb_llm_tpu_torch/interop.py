"""Weight carry-over from the JAX package's parameter trees.

`from_jax_params` turns a tree of numpy arrays shaped like the output of
`pb_llm_tpu.models.llama.init_params` or `models.opt.init_params` (norm
vectors or LayerNorm ``{"w", "b"}`` dicts, ``{"w", "b"}`` dense linears,
``None`` leaves such as OPT's absent ``project_in``, and PackedLinear /
PackedLinearV2 leaves given as objects or dicts carrying their fields) into
the port's tree of torch tensors.  Trees after `models.stacking.stack_layers`
(``layers_stacked`` with [L]-leading leaves, the int ``num_layers``) and
after `models.fusion.fuse_parallel_linears` (row-grouped ``qkv_proj`` /
``gateup_proj``) convert alike.  The caller converts JAX arrays with
``np.asarray`` first, so this module never sees a JAX type.  Bit planes
arrive as uint32 and are kept as bit-identical int32.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.pbw import _FIELDS, _FIELDS_V2, STATIC, STATIC_V2, PackedLinear, PackedLinearV2, \
    layer_from_arrays


def packed_from_fields(obj: Any):
    """PackedLinear (an object or dict with ``mask_packed``) or
    PackedLinearV2 (with ``side_idx``) from its fields, whose arrays convert
    with ``np.asarray``."""
    get = obj.get if isinstance(obj, dict) else (lambda k, d=None: getattr(obj, k, d))
    v2 = get("side_idx") is not None
    arrays = {f: np.asarray(get(f)) for f in (_FIELDS_V2 if v2 else _FIELDS)
              if get(f) is not None}
    return layer_from_arrays({f: get(f) for f in (STATIC_V2 if v2 else STATIC)}, arrays, v2)


def _is_packed(v: Any) -> bool:
    if isinstance(v, dict):
        return "sign_packed" in v
    return hasattr(v, "sign_packed")


def _convert(v: Any) -> Any:
    if v is None or isinstance(v, int):  # an int: num_layers of a stacked tree
        return v
    if isinstance(v, (PackedLinear, PackedLinearV2)):
        return v
    if _is_packed(v):
        return packed_from_fields(v)
    if isinstance(v, dict):
        return {k: _convert(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_convert(x) for x in v]
    return torch.from_numpy(np.array(np.asarray(v)))


def from_jax_params(tree: Any) -> Any:
    """A JAX package parameter tree (numpy leaves) → the port's."""
    return _convert(tree)


def to_device(tree: Any, device) -> Any:
    """Move every tensor of a parameter tree to ``device`` (no copy where a
    tensor already lies there)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (PackedLinear, PackedLinearV2)):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree
