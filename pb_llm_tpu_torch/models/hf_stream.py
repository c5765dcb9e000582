"""Streamed HF checkpoint → PBW conversion (port of
`pb_llm_tpu/models/hf_stream.py`), for checkpoints larger than host RAM.

The checkpoint is walked shard by shard, the tensors of layers still
incomplete are buffered, each decoder layer is packed the moment its
weights are all seen, flushed through `core.pbw.PBWShardWriter` and freed:
peak host memory is one shard plus the partial layers.

The files are read with torch alone, so that a machine without the
`safetensors` package converts the same checkpoints:

- ``model.safetensors`` (and its sharded index): an 8-byte little-endian
  header length, a JSON header (per tensor its dtype, shape and
  ``data_offsets`` into the data that follows; an optional
  ``__metadata__``), then the raw little-endian bytes.  `read_safetensors`
  returns what ``safe_open(path, "pt").get_tensor`` returns.
- ``pytorch_model.bin`` (and its sharded index): ``torch.load(...,
  weights_only=True)``, memory-mapped where the file is in torch's zip
  format, so that listing keys or reading one layer touches only those
  tensors' pages.

Packing (`rtn_pack_fn`) is calibration-free (magnitude salience) and runs
on the device the caller names (default: CUDA); the calibrated GPTQ path is
`calib.pipeline.quantize_model_ptq_streamed` over `StreamedLayerLoader`.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core import pbw
from ..quant.high_quant import high_calibrate, high_quantize
from ..quant.low_quant import low_calibrate, low_quantize

# our layer-param name → HF submodule path inside model(.decoder).layers.{i}.
_HF_LINEAR = {
    "llama": {
        "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
        "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
        "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
        "down_proj": "mlp.down_proj",
    },
    "opt": {
        "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
        "v_proj": "self_attn.v_proj", "out_proj": "self_attn.out_proj",
        "fc1": "fc1", "fc2": "fc2",
    },
}
# As in the JAX package, these match only keys under "model." (a checkpoint
# saved from a bare OPTModel stores "decoder.*" and is not streamed).
_LAYER_RE = {
    "llama": re.compile(r"^model\.layers\.(\d+)\.(.+)$"),
    "opt": re.compile(r"^model\.decoder\.layers\.(\d+)\.(.+)$"),
}

# safetensors dtype names → torch dtypes (those this torch build has)
_ST_DTYPES = {name: getattr(torch, attr) for name, attr in (
    ("F64", "float64"), ("F32", "float32"), ("F16", "float16"), ("BF16", "bfloat16"),
    ("I64", "int64"), ("I32", "int32"), ("I16", "int16"), ("I8", "int8"), ("U8", "uint8"),
    ("BOOL", "bool"), ("U16", "uint16"), ("U32", "uint32"), ("U64", "uint64"),
    ("F8_E4M3", "float8_e4m3fn"), ("F8_E5M2", "float8_e5m2")) if hasattr(torch, attr)}


def safetensors_header(path: str) -> Tuple[Dict[str, dict], int]:
    """(header without ``__metadata__``, offset of the data) of a
    safetensors file."""
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def _safetensors_tensors(path: str, keys: Optional[List[str]] = None
                         ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield the tensors ``keys`` (default: all, in file order) of a
    safetensors file, each in its stored dtype and shape on the CPU."""
    header, base = safetensors_header(path)
    if keys is None:
        keys = sorted(header, key=lambda k: header[k]["data_offsets"][0])
    with open(path, "rb") as fh:
        for k in keys:
            info = header[k]
            if info["dtype"] not in _ST_DTYPES:
                raise ValueError(f"{path}: tensor {k!r} has dtype {info['dtype']}, which this "
                                 "torch build cannot hold")
            dtype = _ST_DTYPES[info["dtype"]]
            start, end = info["data_offsets"]
            if end == start:  # an empty tensor has no bytes to view
                yield k, torch.empty(info["shape"], dtype=dtype)
                continue
            fh.seek(base + start)
            raw = np.fromfile(fh, dtype=np.uint8, count=end - start)
            if raw.size != end - start:
                raise ValueError(f"{path}: tensor {k!r} is truncated")
            yield k, torch.from_numpy(raw).view(dtype).reshape(info["shape"])


def read_safetensors(path: str, keys: Optional[List[str]] = None) -> Dict[str, torch.Tensor]:
    """What ``safe_open(path, "pt").get_tensor(k)`` gives for each of
    ``keys`` (default: all), read with torch alone."""
    return dict(_safetensors_tensors(path, keys))


def load_torch_bin(path: str) -> Dict[str, torch.Tensor]:
    """A ``pytorch_model*.bin`` state dict on the CPU: memory-mapped where
    the file is in torch's zip format (only the tensors read are paged
    in), else loaded whole."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    except RuntimeError:  # the legacy (pre-zip) format cannot be mapped
        return torch.load(path, map_location="cpu", weights_only=True)


def _shard_files(model_dir: str) -> Tuple[str, list]:
    """→ (kind, files): kind in {"safetensors", "torch"}."""
    for index, kind in (("model.safetensors.index.json", "safetensors"),
                        ("pytorch_model.bin.index.json", "torch")):
        ip = os.path.join(model_dir, index)
        if os.path.exists(ip):
            with open(ip) as fh:
                files = sorted(set(json.load(fh)["weight_map"].values()))
            return kind, [os.path.join(model_dir, f) for f in files]
    for single, kind in (("model.safetensors", "safetensors"),
                         ("pytorch_model.bin", "torch")):
        sp = os.path.join(model_dir, single)
        if os.path.exists(sp):
            return kind, [sp]
    raise FileNotFoundError(f"no HF weights found under {model_dir}")


def _file_keys(kind: str, f: str) -> List[str]:
    if kind == "safetensors":
        return list(safetensors_header(f)[0])
    return list(load_torch_bin(f).keys())


def _read_file(kind: str, f: str, keys: Optional[List[str]] = None) -> Dict[str, torch.Tensor]:
    """Tensors of one shard in their stored dtype (default: all of them)."""
    if kind == "safetensors":
        return read_safetensors(f, keys)
    sd = load_torch_bin(f)
    return sd if keys is None else {k: sd[k] for k in keys}


def read_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of an HF checkpoint directory, in its stored dtype, on
    the CPU (torch bins memory-mapped)."""
    kind, files = _shard_files(model_dir)
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(_read_file(kind, f))
    return sd


def iter_hf_tensors(model_dir: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (key, float32 CPU tensor) one tensor at a time across all
    shards."""
    kind, files = _shard_files(model_dir)
    for f in files:
        tensors = (_safetensors_tensors(f) if kind == "safetensors"
                   else load_torch_bin(f).items())
        for key, t in tensors:
            yield key, t.float()


class StreamedLayerLoader:
    """Layer-at-a-time checkpoint access for GPTQ calibration of models
    larger than host RAM.

    Builds a key → shard map once (safetensors: from the headers; torch
    bins: from memory-mapped loads), then serves ``layer_params(i)`` —
    exactly one decoder layer's tensors read from disk and assembled into
    the family's layer dict (f32, on the CPU) — and ``non_layer_params()``
    (embeddings, norms, head).  ``release(i)`` drops the layer;
    ``max_live`` records the peak number of layers resident at once, so a
    caller can assert that peak host memory stayed one layer."""

    def __init__(self, model_dir: str, family: str):
        self.model_dir = model_dir
        self.family = family
        self.kind, self.files = _shard_files(model_dir)
        self.key_file: Dict[str, str] = {}
        for f in self.files:
            for k in _file_keys(self.kind, f):
                self.key_file[k] = f
        self._layer_re = _LAYER_RE[family]
        self._live: set = set()
        self.max_live = 0

    def n_layers(self) -> int:
        mx = -1
        for k in self.key_file:
            m = self._layer_re.match(k)
            if m:
                mx = max(mx, int(m.group(1)))
        return mx + 1

    def _read_keys(self, keys) -> Dict[str, torch.Tensor]:
        by_file: Dict[str, list] = {}
        for k in keys:
            by_file.setdefault(self.key_file[k], []).append(k)
        out: Dict[str, torch.Tensor] = {}
        for f, ks in by_file.items():
            out.update({k: t.float() for k, t in _read_file(self.kind, f, ks).items()})
        return out

    def non_layer_params(self, cfg, dtype=torch.float32) -> Dict:
        from . import hf_import

        sd = self._read_keys([k for k in self.key_file if not self._layer_re.match(k)])
        fn = (hf_import.llama_nonlayer_from_sd if self.family == "llama"
              else hf_import.opt_nonlayer_from_sd)
        return fn(sd, cfg, dtype)

    def layer_params(self, i: int, dtype=torch.float32) -> Dict:
        from . import hf_import

        prefix = (f"model.layers.{i}." if self.family == "llama"
                  else f"model.decoder.layers.{i}.")
        sd = self._read_keys([k for k in self.key_file if k.startswith(prefix)])
        self._live.add(i)
        self.max_live = max(self.max_live, len(self._live))
        fn = (hf_import.llama_layer_from_sd if self.family == "llama"
              else hf_import.opt_layer_from_sd)
        return fn(sd, i, dtype)

    def release(self, i: int) -> None:
        self._live.discard(i)


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` (linear interpolation, all in f32) without
    `torch.quantile`'s size limit."""
    a = torch.sort(x.reshape(-1)).values
    n = a.numel()
    pos = torch.tensor(q, dtype=torch.float32) * torch.tensor(n - 1, dtype=torch.float32)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    hw = (pos - lo).to(a.device)
    return a[int(lo)] * (1.0 - hw) + a[min(int(hi), n - 1)] * hw


def rtn_pack_fn(method: str = "xnor", low_frac: float = 0.9, high_bit: int = 8,
                fmt: str = "packed_v2", groupsize: int = -1,
                pack_block: Optional[int] = None, ic_shards: int = 1,
                device=None) -> Callable:
    """Calibration-free packer: |w| salience (the reference's RTN low_frac
    semantics, `gptq_pb/run.py:122-125`), an 8-bit sidecar for salient
    weights.  Packs on ``device`` (default: CUDA, `resolve_device`).

    For tensor-parallel deployment pack with ``ic_shards=tp`` (shard-major
    v2 sidecar; selection balanced per ic shard) and a ``pack_block``
    dividing ic/tp for the row-parallel layers."""
    dev = resolve_device(device)

    def pack(name: str, w_oc_ic, bias):
        w = torch.as_tensor(w_oc_ic).to(dev, torch.float32)
        b = None if bias is None else torch.as_tensor(bias).to(dev, torch.float32)
        if fmt == "packed_v2":
            mask = pbw.column_structured_mask(torch.abs(w), low_frac, col_tile=0,
                                              ic_shards=ic_shards)
        else:
            mask = torch.abs(w) <= _quantile(torch.abs(w), low_frac)
        low_state = low_calibrate(w * mask, method)
        high_state = high_calibrate(w, bits=high_bit)
        w_q = torch.where(mask, low_quantize(w, low_state, method), high_quantize(w, high_state))
        if fmt == "packed_v2":
            p, _diag = pbw.pack_linear_v2(w_q, mask, low_state, high_state, method,
                                          col_tile=0, bias=b, pack_block=pack_block,
                                          ic_shards=ic_shards)
        else:
            p, _diag = pbw.pack_linear(w_q, mask, low_state, high_state, method,
                                       bias=b, groupsize=groupsize, pack_block=pack_block)
        return p

    return pack


def stream_pack_to_pbw(
    model_dir: str,
    out_dir: str,
    family: str,
    pack_fn: Optional[Callable] = None,
    min_layer: int = 0,
    max_layer: int = 10 ** 9,
) -> Dict[str, str]:
    """Convert an HF checkpoint directory to a sharded PBW artifact, one
    decoder layer resident at a time.  Returns {layer_key: shard_file}.
    ``pack_fn`` defaults to `rtn_pack_fn()` (on CUDA)."""
    pack_fn = pack_fn or rtn_pack_fn()
    lin_map = _HF_LINEAR[family]
    sub_to_name = {v: k for k, v in lin_map.items()}
    layer_re = _LAYER_RE[family]

    # expected per-layer keys, from the key listing alone
    expected: Dict[int, set] = {}
    kind, files = _shard_files(model_dir)
    for f in files:
        for key in _file_keys(kind, f):
            m = layer_re.match(key)
            if not m:
                continue
            i, rest = int(m.group(1)), m.group(2)
            if rest.rsplit(".", 1)[0] in sub_to_name:
                expected.setdefault(i, set()).add(rest)

    writer = pbw.PBWShardWriter(out_dir)
    buffers: Dict[int, Dict[str, torch.Tensor]] = {}
    done: Dict[str, str] = {}

    def flush(i: int) -> None:
        buf = buffers.pop(i)
        for sub, name in sub_to_name.items():
            wk, bk = sub + ".weight", sub + ".bias"
            if wk not in buf:
                continue
            key = f"layer_{i}/{name}"
            done[key] = writer.add_layer(key, pack_fn(name, buf[wk], buf.get(bk)))

    for key, tensor in iter_hf_tensors(model_dir):
        m = layer_re.match(key)
        if not m:
            continue  # embeddings and norms stay in the dense checkpoint
        i, rest = int(m.group(1)), m.group(2)
        if i < min_layer or i >= max_layer or i not in expected:
            continue
        buffers.setdefault(i, {})[rest] = tensor
        if set(buffers[i]) >= expected[i]:
            flush(i)
    for i in sorted(buffers):  # layers whose keys arrived out of order
        if set(buffers[i]) >= expected.get(i, set()):
            flush(i)

    writer.finalize({"source": os.path.abspath(model_dir), "family": family})
    return done
