"""Typed job configs (port of `pb_llm_tpu/core/config.py`): the dataclass
replacement for the reference's argparse globals.  Re-exports the
per-subsystem configs (`SolverConfig`, `EngineConfig`, `QATConfig`)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..calib.solver import SolverConfig
from ..runtime.engine import EngineConfig  # noqa: F401
from ..train.qat import QATConfig  # noqa: F401


@dataclasses.dataclass(frozen=True)
class PTQJobConfig:
    """One PTQ run = reference `python gptq_pb/run.py <model> <dataset> <method> …`."""

    model: str
    dataset: str = "c4"                  # calibration set
    low_quant_method: str = "xnor"       # xnor|sign|no|2bit|4bit|prune
    low_frac: float = 0.5
    high_bit: int = 8
    salient_metric: str = "magnitude"    # magnitude|hessian
    groupsize: int = -1
    blocksize: int = 128
    percdamp: float = 0.01
    nsamples: int = 128
    seed: int = 0
    minlayer: int = -1
    maxlayer: int = 1000
    quant_only: str = ""
    invert: bool = False
    disable_gptq: bool = False
    high_sym: bool = False
    high_mse: bool = False
    fmt: str = "sim"                     # sim|packed|packed_v2 (PBW v1 | PBW v2)
    mask_structure: str = "element"      # element|column (column → PBW v2-compatible)
    col_tile: int = 256                  # output-row group width of column masks
    eval_datasets: Sequence[str] = ("wikitext2", "ptb", "c4")
    save_dir: Optional[str] = None
    mask_out: Optional[str] = None       # GPTQ mask export for the QAT handoff

    def solver(self) -> SolverConfig:
        return SolverConfig(
            low_method=self.low_quant_method, low_frac=self.low_frac, high_bit=self.high_bit,
            groupsize=self.groupsize, salient_metric=self.salient_metric,
            blocksize=self.blocksize, percdamp=self.percdamp, disable_gptq=self.disable_gptq,
            high_sym=self.high_sym, high_mse=self.high_mse,
            mask_structure=self.mask_structure, col_tile=self.col_tile)

    @property
    def save_title(self) -> str:
        # reference naming: run.py:276
        t = (f"{self.model}_{self.dataset}_{self.low_quant_method}_{self.low_frac}_"
             f"{self.high_bit}_{self.groupsize}_{self.salient_metric}")
        return t.replace("/", "_")


@dataclasses.dataclass(frozen=True)
class EvalJobConfig:
    """One eval run = reference `qat/eval_after_qat.py` / `evaluate_model`."""

    model: str
    tasks: Sequence[str] = ()
    eval_ppl: Sequence[str] = ("wikitext2", "ptb", "c4")
    limit: int = -1
    seqlen: Optional[int] = None
