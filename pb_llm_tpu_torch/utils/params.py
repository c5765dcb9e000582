"""Parameter-tree reports (port of `pb_llm_tpu/utils/params.py`):

  count_parameters / print_trainable_parameters  (the reference's `utils.py:14-26`)
  device_memory_report                           (`utils.py:9-11`)
  zero_fraction_report — the post-quantization print of `gptq_pb/run.py:293-296`
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..core.pbw import PackedLinear, PackedLinearV2
from ..quant.qat import QATLinear


def count_parameters(params: Any) -> Tuple[int, int]:
    """(trainable, total).  QATLinear weight/bias count as trainable; dense
    tensors and packed linears (their logical ic·oc) as frozen, the QAT
    setup's frozen base model.  The JAX package counts PBW-v1 linears so
    and skips PBW-v2 ones; here both count."""
    trainable = total = 0

    def visit(node):
        nonlocal trainable, total
        if isinstance(node, QATLinear):
            n = node.weight.numel() + (node.bias.numel() if node.bias is not None else 0)
            trainable += n
            total += n
        elif isinstance(node, (PackedLinear, PackedLinearV2)):
            total += node.ic * node.oc
        elif isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                visit(v)
        elif isinstance(node, torch.Tensor):
            total += node.numel()

    visit(params)
    return trainable, total


def print_trainable_parameters(params: Any) -> str:
    t, a = count_parameters(params)
    msg = f"trainable params: {t} || all params: {a} || trainable%: {100 * t / max(a, 1)}"
    print(msg)
    return msg


def device_memory_report() -> Dict[str, float]:
    """MB allocated by PyTorch on each CUDA device (`torch.cuda.memory_allocated`);
    without CUDA one "cpu" entry, NaN, as JAX reports a device without
    memory statistics."""
    if not torch.cuda.is_available():
        return {"cpu": float("nan")}
    return {f"cuda:{i}": torch.cuda.memory_allocated(i) / 1e6
            for i in range(torch.cuda.device_count())}


def zero_fraction_report(params: Any, limit_substr: str = "fc2") -> Dict[str, float]:
    """Mean zero-fraction per dense leaf until `limit_substr` is hit."""
    report: Dict[str, float] = {}

    def visit(node, prefix):
        if isinstance(node, dict):
            if isinstance(node.get("w"), torch.Tensor):
                report[prefix] = float(torch.mean((node["w"] == 0).float()))
                return limit_substr in prefix
            for k, v in node.items():
                if visit(v, f"{prefix}.{k}" if prefix else k):
                    return True
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                if visit(v, f"{prefix}.{i}"):
                    return True
        return False

    visit(params, "")
    return report
