"""Structured JSONL metrics (port of `pb_llm_tpu/utils/logging.py`): every
event is one JSON line, written to a file and echoed to a stream, on rank 0
only when `torch.distributed` is initialised."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Optional

import torch


def is_host0() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stream=None):
        self.path = path
        self.stream = stream if stream is not None else sys.stderr
        self._fh = None
        if path and is_host0():
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def log(self, event: str, **fields: Any) -> None:
        if not is_host0():
            return
        line = json.dumps({"ts": round(time.time(), 3), "event": event, **fields})
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.stream:
            print(line, file=self.stream, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
