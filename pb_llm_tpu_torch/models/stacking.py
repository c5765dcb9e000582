"""Layer stacking (port of `pb_llm_tpu/models/stacking.py`): the list of
per-layer param dicts becomes one ``layers_stacked`` dict whose tensors
carry a leading [L] layer axis, and the KV caches likewise.

JAX runs the stacked layer loop as one `lax.scan` body.  Here it is a
Python loop over the layer index li (`run_layers`): a leaf's layer li is a
view (``t[li]``), so nothing is copied per layer and the caches' views are
updated in place.  PBW-v2 leaves go in as `StackedPackedLinearV2` markers,
which `ops.binary_matmul.pb_matmul_stacked` hands to the stacked kernels:
their launch arguments are the same for every layer (the whole [L] planes
and a device pointer to li), the form a CUDA graph of the layer loop needs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from ..core.pbw import PackedLinear, PackedLinearV2, fields_of


@dataclasses.dataclass
class StackedPackedLinearV2:
    """A PackedLinearV2 whose tensor fields carry a leading [L] axis, and
    the layer this step runs: ``idx`` as a Python int (the per-layer views
    of the small fields) and ``idx_t``, the same index as a device int32
    [1] tensor, which the stacked kernels read."""

    stacked: PackedLinearV2
    idx: int
    idx_t: torch.Tensor

    def layer(self) -> PackedLinearV2:
        """Layer ``idx`` as an ordinary PackedLinearV2 of views."""
        return layer_view(self.stacked, self.idx)


def layer_view(sp, li: int):
    """Layer ``li`` of a stacked PackedLinear / PackedLinearV2: its tensors
    are views; a v2 layer takes its row of the stacked coefficient cache."""
    kw = {f: None if getattr(sp, f) is None else getattr(sp, f)[li] for f in fields_of(sp)}
    view = dataclasses.replace(sp, **kw)
    if sp.coef_cache is not None:
        view.coef_cache = sp.coef_cache[li]
    return view


def _structure(v) -> Any:
    if isinstance(v, dict):
        return tuple((k, _structure(x)) for k, x in sorted(v.items()))
    if isinstance(v, (PackedLinear, PackedLinearV2)):
        static = tuple((f.name, getattr(v, f.name)) for f in dataclasses.fields(v)
                       if f.name not in fields_of(v) and f.name != "coef_cache")
        return type(v).__name__, static, tuple(getattr(v, f) is None for f in fields_of(v))
    return None if v is None else "tensor"


def _stack(vs: List[Any]) -> Any:
    v0 = vs[0]
    if isinstance(v0, dict):
        return {k: _stack([v[k] for v in vs]) for k in v0}
    if isinstance(v0, (PackedLinear, PackedLinearV2)):
        return dataclasses.replace(v0, **{f: None if getattr(v0, f) is None
                                          else torch.stack([getattr(v, f) for v in vs])
                                          for f in fields_of(v0)})
    return None if v0 is None else torch.stack(vs)


def take_layer(v: Any, li: int) -> Any:
    """Layer ``li`` of a stacked leaf (dict, packed layer, tensor, None)."""
    if isinstance(v, dict):
        return {k: take_layer(x, li) for k, x in v.items()}
    if isinstance(v, (PackedLinear, PackedLinearV2)):
        return layer_view(v, li)
    return None if v is None else v[li]


def stack_layers(params: Dict[str, Any]) -> Dict[str, Any]:
    """params with ``layers`` replaced by ``layers_stacked`` (leaves gain a
    leading [num_layers] axis) and ``num_layers``.  Non-mutating."""
    layers: List[Any] = params["layers"]
    if not layers:
        raise ValueError("no layers to stack")
    if len({_structure(lp) for lp in layers}) != 1:
        raise ValueError("layers have differing structures; cannot stack (mixed formats "
                         "across layers: quantize uniformly or keep them unrolled)")
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers_stacked"] = _stack(layers)
    out["num_layers"] = len(layers)
    return out


def unstack_layers(params: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of `stack_layers` (the layers are views of the stacked
    tensors)."""
    n = params["num_layers"]
    out = {k: v for k, v in params.items() if k not in ("layers_stacked", "num_layers")}
    out["layers"] = [take_layer(params["layers_stacked"], i) for i in range(n)]
    return out


def is_stacked(params: Dict[str, Any]) -> bool:
    return "layers_stacked" in params


def stack_caches(caches: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-layer KV-cache dicts → one dict with a leading [L] axis."""
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def unstack_caches(caches: Dict[str, torch.Tensor], n: int) -> List[Dict[str, torch.Tensor]]:
    """The per-layer views of a stacked cache."""
    return [{k: v[i] for k, v in caches.items()} for i in range(n)]


def run_layers(params: Dict[str, Any], x: torch.Tensor, layer_fn: Callable,
               kv_caches: Optional[Dict[str, torch.Tensor]] = None,
               linear_fn: Optional[Callable] = None) -> torch.Tensor:
    """The decoder loop over ``params["layers_stacked"]``: for each layer li,
    ``x, _ = layer_fn(lp, x, cache)`` with PBW-v2 leaves as markers, other
    leaves and the [L]-leading caches as their [li] views.

    A ``linear_fn`` must be marked ``scan_safe``, as in JAX: a capture-style
    callback cannot tell the layers apart by name."""
    if linear_fn is not None and not getattr(linear_fn, "scan_safe", False):
        raise ValueError(
            "linear_fn over stacked layers: a capture-style callback would see the "
            "linears by NAME only, not per layer (silently wrong statistics): run "
            "calibration on unrolled layers, or mark a per-call-stateless wrapper with "
            "fn.scan_safe = True")
    stacked = params["layers_stacked"]
    idxs = torch.arange(params["num_layers"], dtype=torch.int32, device=x.device)
    for li in range(params["num_layers"]):
        lp = {k: StackedPackedLinearV2(v, li, idxs[li : li + 1]) if isinstance(v, PackedLinearV2)
              else take_layer(v, li) for k, v in stacked.items()}
        cache = None if kv_caches is None else {k: v[li] for k, v in kv_caches.items()}
        x, _ = layer_fn(lp, x, cache)
    return x
