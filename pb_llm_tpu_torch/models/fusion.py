"""Parallel-linear fusion (port of `pb_llm_tpu/models/fusion.py`): q/k/v and
gate/up share their input, so serving runs each set as one packed matmul
(q|k|v → "qkv_proj", gate|up → "gateup_proj"): 7 → 4 packed matmuls and x
preparations per llama block, 5 → 3 per OPT block.  The merged
`PackedLinearV2` carries one row group per part
(`core.pbw.merge_packed_linears_v2`), so each matrix keeps its salient
columns and scales and the dequantized weights equal the unfused ones.

Serving only (`EngineConfig.fuse_linears`); calibration keeps per-name
linears.
"""

from __future__ import annotations

from typing import Any, Dict

from ..core.pbw import PackedLinearV2, merge_packed_linears_v2

# fusable sets per family: (fused name, member names)
FUSED = {
    "llama": (("qkv_proj", ("q_proj", "k_proj", "v_proj")),
              ("gateup_proj", ("gate_proj", "up_proj"))),
    "opt": (("qkv_proj", ("q_proj", "k_proj", "v_proj")),),
}


def _fusable(lp: Dict[str, Any], names) -> bool:
    parts = [lp.get(n) for n in names]
    if not all(isinstance(p, PackedLinearV2) for p in parts):
        return False
    p0 = parts[0]
    return all(
        p.n_row_groups == 1 and p.shards_local == 1
        and (p.ic, p.oc, p.pack_block, p.side_bits, p.low_bits, p.k_pad)
        == (p0.ic, p0.oc, p0.pack_block, p0.side_bits, p0.low_bits, p0.k_pad)
        and (p.bias is None) == (p0.bias is None)
        for p in parts)


def fuse_parallel_linears(params: Dict[str, Any], family_name: str) -> Dict[str, Any]:
    """params with each layer's fusable sets merged (non-mutating).  Sets
    that do not qualify (dense or v1 leaves, GQA's narrower k/v, sharded or
    row-grouped layouts) stay as they are: the forwards take fused and
    unfused layers alike."""
    out = dict(params)
    new_layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        for fused_name, names in FUSED.get(family_name, ()):
            if _fusable(lp, names):
                lp[fused_name] = merge_packed_linears_v2([lp.pop(n) for n in names])
        new_layers.append(lp)
    out["layers"] = new_layers
    return out
