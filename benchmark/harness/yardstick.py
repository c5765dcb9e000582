"""The yardstick: the chip's published peaks and the least time a kernel
launch or a whole engine call could take on it, from shapes alone.

`bound`, `packed_bytes`, `matmul_bytes` and `v1_plane_bytes` are frozen
copies of the smoke run's arithmetic (`chip_smoke.py`), which the kernel
table of PERF.md was measured against; they take the benchmark's layer
dicts (`benchmark/weights/pbw.py`).  A roofline share is a least time over
a measured time: the larger of operations over the peak of the arithmetic
the work runs on, and bytes over the HBM rate.  Each input byte is counted
once and each output byte once, whatever a kernel reads again; operations
are the products the mathematics needs, counted once (a kernel that splits
a product into several terms on lower-precision units does more work than
this counts, so its share stays below its own ceiling, never above 100%).
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM, dense rates without sparsity, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12


def bound(nbytes: float, ops: float, peak_ops: float):
    """(least ms, what bounds it) of nbytes moved and ops at peak_ops."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _n(t) -> int:
    return t.numel() * t.element_size()


def packed_bytes(p: dict) -> int:
    """A PBW-v2 layer's planes, codes, indices and scales as held."""
    return sum(_n(p[k]) for k in ("sign_packed", "side_val", "side_idx", "low_scale",
                                  "low_mean", "high_scale", "high_zero"))


def matmul_bytes(p: dict, m: int) -> int:
    """The packed matmul's least bytes: sign planes, codes, x and y rows."""
    return 4 * p["sign_packed"].numel() + p["side_val"].numel() + 4 * m * (p["ic"] + p["oc"])


def v1_plane_bytes(p: dict) -> int:
    return sum(_n(p[k]) for k in ("sign_packed", "mask_packed", "sidecar", "low_scale",
                                  "low_mean", "high_scale", "high_zero")) + (
        _n(p["bias"]) if p["bias"] is not None else 0)


# ---------------------------------------------------------------------------
# the model sheet: what a reader needs to know of each linear, made once in
# set-up from the layer dicts and kept as plain numbers


def linear_entry(name: str, p: dict) -> dict:
    if "side_idx" in p:  # PBW v2
        return {"name": name, "format": "v2", "ic": p["ic"], "oc": p["oc"],
                "k_pad": p["side_val"].shape[0] * (8 // p["side_bits"]),
                "n_rg": p["side_idx"].shape[1], "sign_bytes": _n(p["sign_packed"]),
                "side_bytes": _n(p["side_val"]), "idx_bytes": _n(p["side_idx"]),
                "held_bytes": packed_bytes(p) + (_n(p["bias"]) if p["bias"] is not None else 0)}
    return {"name": name, "format": "v1", "ic": p["ic"], "oc": p["oc"],
            "held_bytes": v1_plane_bytes(p)}


def int8_matmul_launch(e: dict, m: int) -> Tuple[float, float]:
    """(bytes, int8 ops) of one int8 matmul launch (`pb_int8_matmul*`) at m
    rows: int8 x and gathered x, f32 row scales and sums, the [5, oc]
    coefficients, the sign planes and codes, the f32 output."""
    nbytes = (m * e["ic"] + e["n_rg"] * m * e["k_pad"] + 4 * (2 * m + e["n_rg"] * m + 5 * e["oc"])
              + e["sign_bytes"] + e["side_bytes"] + 4 * m * e["oc"])
    return nbytes, 2 * m * e["oc"] * (e["ic"] + e["k_pad"])


def int8_prep_launch(e: dict, m: int) -> float:
    """Bytes of one x preparation (`pb_prep_int8`): f32 x and the salient
    indices in; int8 x, gathered int8 x, f32 scales and sums out."""
    return (4 * m * e["ic"] + e["idx_bytes"] + m * e["ic"] + e["n_rg"] * m * e["k_pad"]
            + 4 * (2 * m + e["n_rg"] * m))


def v1_launch(e: dict, m: int) -> Tuple[float, float]:
    """(bytes, products) of one PBW-v1 matmul (planar or select, the x terms
    launch included): f32 x and y, the planes, codes, scales and bias; the
    product 2·m·ic·oc once, at the bf16 tensor cores' rate (what its arms
    run on)."""
    return 4 * (m * e["ic"] + m * e["oc"]) + e["held_bytes"], 2 * m * e["ic"] * e["oc"]


def linear_ops_time(e: dict, m: int) -> float:
    """Seconds of one linear's products at m rows at their peak."""
    if e["format"] == "v2":
        return int8_matmul_launch(e, m)[1] / INT8_OPS_PER_S
    return v1_launch(e, m)[1] / BF16_FLOPS_PER_S


def kv_row_bytes(sheet: dict) -> int:
    """One token's K and V rows in one layer: int8 values and f32 scales."""
    return sheet["kv_heads"] * (2 * sheet["head_dim"] + 8)


def decode_attention_launches(sheet: dict, slots: int, rows: int) -> Tuple[float, float]:
    """(bytes, f32 ops) of one layer's decode attention over ``rows`` cache
    rows in all (every slot's rows up to its position): the rows' K, V and
    scales, f32 q in and out; 4·d operations a (query head, row) pair."""
    hq, d = sheet["heads"], sheet["head_dim"]
    group = hq // sheet["kv_heads"]
    return rows * kv_row_bytes(sheet) + 2 * 4 * slots * hq * d, 4 * d * group * sheet[
        "kv_heads"] * rows


def step_bound(sheet: dict, rows: int, kv_read_rows: int, attn_pairs: float,
               written_rows: int) -> Tuple[float, str]:
    """Least seconds of one forward over ``rows`` useful rows: every linear,
    the lm_head (f32), attention over ``attn_pairs`` (row, key) pairs a
    layer, ``kv_read_rows`` cache rows read and ``written_rows`` written a
    layer.  Bytes are what the forward needs from and leaves in memory: the
    weights as held, the cache rows, the embedding rows in and the logits
    out (activations between its kernels are not counted).  Returns
    (seconds, "bytes" | "operations")."""
    t_ops = sum(linear_ops_time(e, rows) for e in sheet["linears"])
    nbytes = float(sum(e["held_bytes"] for e in sheet["linears"]))
    h, v, layers = sheet["hidden"], sheet["vocab"], sheet["layers"]
    t_ops += (2 * rows * h * v + 4 * sheet["head_dim"] * sheet["heads"] * attn_pairs * layers
              ) / F32_FLOPS_PER_S
    nbytes += sheet["head_bytes"] + 4 * rows * (h + v)
    nbytes += layers * (kv_read_rows + written_rows) * kv_row_bytes(sheet)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else "operations")


def sheet_of(cfg: dict, layer0: Dict[str, dict], head_bytes: int, heads: int, kv_heads: int,
             head_dim: int) -> dict:
    """The model sheet: every linear of every layer (all layers alike, so
    layer 0's linears repeated), the head's bytes and the attention shape."""
    one = [linear_entry(k, v) for k, v in layer0.items() if isinstance(v, dict)
           and "sign_packed" in v]
    return {"linears": one * cfg["num_hidden_layers"], "layer_linears": one,
            "layers": cfg["num_hidden_layers"], "hidden": cfg["hidden_size"],
            "vocab": cfg["vocab_size"], "head_bytes": head_bytes, "heads": heads,
            "kv_heads": kv_heads, "head_dim": head_dim}
