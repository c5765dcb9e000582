"""Offline substitutes (port of `pb_llm_tpu/data/synthetic.py`): the byte
tokenizer and the deterministic synthetic corpora that plug into
`data.loaders`, the CLIs' tiny random-init models, random PBW v1 and v2
weights made on a device from a seed, for smoke runs and kernel checks at
real widths (the recipe of the JAX package's `bench_e2e.build_packed_llama`),
and `write_hf_checkpoint`, an HF checkpoint directory of given weights
written with torch alone, in place of a downloaded one."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core import packing
from ..core.pbw import PackedLinear, PackedLinearV2
from .loaders import TextSource


class ByteTokenizer:
    """UTF-8 byte tokenizer. vocab: 0..255 bytes, 256 bos, 257 eos, 258 pad."""

    vocab_size = 259
    bos_token_id = 256
    eos_token_id = 257
    pad_token_id = 258

    def encode(self, text: str):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")

    def __call__(self, text, **kw):
        return {"input_ids": self.encode(text)}


# the JAX package's word list, verbatim: the corpora are token-identical
_WORDS = (
    "the quantized llama ran over binary weights while salient outliers "
    "kept eight bits of precision and the hessian chose which columns stay "
    "dense on the tpu mesh with packed sign planes streaming from hbm"
).split()


def synthetic_texts(n_docs: int, seed: int, min_words: int = 20, max_words: int = 400):
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        k = int(rng.integers(min_words, max_words))
        docs.append(" ".join(_WORDS[i] for i in rng.integers(0, len(_WORDS), k)))
    return docs


def synthetic_source(n_docs: int = 200, seed: int = 0) -> TextSource:
    """A TextSource covering every dataset/split the loaders ask for."""
    keys = ["wikitext2/train", "wikitext2/test", "ptb/train", "ptb/test", "ptb/validation",
            "c4/train", "c4/validation", "red_pajama/train", "english_quotes/train"]
    return TextSource({key: synthetic_texts(n_docs, seed + i) for i, key in enumerate(keys)})


def random_packed_v2(ic: int, oc: int, generator: torch.Generator, *, low_frac: float = 0.9,
                     col_tile: int = 0, side_bits: int = 8, pack_block: int = 0,
                     bias: bool = False) -> PackedLinearV2:
    """A PBW-v2 layer with random planes, made on the generator's device.

    Each row group of ``col_tile`` output columns (0 = one global group) has
    round((1-low_frac)·ic) random salient input columns; sign bits are
    random and zero at salient rows (the B' convention), codes are random.
    Scales follow bench_e2e.py: low ±0.01 around 0, high 0.004·(code − zero).
    """
    dev = generator.device
    if col_tile <= 0 or col_tile > oc:
        col_tile = oc
    n_rg = -(-oc // col_tile)
    k = int(round(ic * (1.0 - low_frac)))
    k_pad = max(32, -(-k // 32) * 32)
    side_idx = torch.full((k_pad, n_rg), ic, dtype=torch.int32, device=dev)
    bits = torch.randint(0, 2, (ic, oc), generator=generator, device=dev, dtype=torch.int32)
    for t in range(n_rg):
        cols = torch.sort(torch.randperm(ic, generator=generator, device=dev)[:k]).values
        side_idx[:k, t] = cols.to(torch.int32)
        bits[cols[:, None], torch.arange(t * col_tile, min((t + 1) * col_tile, oc), device=dev)] = 0
    pack_block = pack_block or packing.default_pack_block(ic)
    rows = k_pad // 2 if side_bits == 4 else k_pad
    side_val = torch.randint(0, 256, (rows, oc), generator=generator, device=dev,
                             dtype=torch.int32).to(torch.uint8)

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=dev)

    return PackedLinearV2(
        sign_packed=packing.pack_bits(bits, pack_block), side_val=side_val, side_idx=side_idx,
        low_scale=full((1, oc), 0.01), low_mean=full((1, oc), 0.0),
        high_scale=full((oc,), 0.004), high_zero=full((oc,), 8.0 if side_bits == 4 else 128.0),
        bias=torch.randn(oc, generator=generator, device=dev) * 0.01 if bias else None,
        ic=ic, oc=oc, col_tile=col_tile, pack_block=pack_block, k_pad_shard=k_pad,
        side_bits=side_bits, low_bits=1)


def random_packed_llama(cfg, generator: torch.Generator, low_frac: float = 0.9) -> Dict[str, Any]:
    """A llama parameter tree with every decoder linear a random PBW-v2
    layer (global salient selection) and f32 embeddings / lm_head, all made
    on the generator's device."""
    dev = generator.device
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    qo, kv = cfg.num_attention_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    shapes = {"q_proj": (h, qo), "k_proj": (h, kv), "v_proj": (h, kv), "o_proj": (qo, h),
              "gate_proj": (h, ffn), "up_proj": (h, ffn), "down_proj": (ffn, h)}

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=dev) * 0.02

    layers = []
    for _ in range(cfg.num_hidden_layers):
        lp = {"input_layernorm": torch.ones(h, device=dev),
              "post_attention_layernorm": torch.ones(h, device=dev)}
        for name, (ic, oc) in shapes.items():
            lp[name] = random_packed_v2(ic, oc, generator, low_frac=low_frac)
        layers.append(lp)
    return {"embed_tokens": normal(cfg.vocab_size, h), "layers": layers,
            "norm": torch.ones(h, device=dev), "lm_head": {"w": normal(h, cfg.vocab_size), "b": None}}


def random_packed_v1(ic: int, oc: int, generator: torch.Generator, *, low_frac: float = 0.9,
                     groupsize: int = -1, sidecar_bits: int = 8, low_bits: int = 1,
                     bias: bool = False, pack_block: Optional[int] = None) -> PackedLinear:
    """A PBW-v1 layer with random planes, made on the generator's device.

    Each weight is salient with probability 1 − low_frac, independently
    (an element-wise mask).  Low codes are random and zero at salient
    positions (the B' convention), high codes random at salient positions
    and zero elsewhere; the pack block is `core.pbw.pack_linear`'s.  Scales
    vary by group and column: low scale 0.005–0.015 (1-bit lows: mean
    ±0.002; 2/4-bit lows: the mid-code zero point), high scale 0.002–0.006
    around the mid code; ``pack_block`` overrides it (scale groups may then
    lie inside a pack block)."""
    dev = generator.device
    gs = ic if groupsize == -1 else groupsize
    n_groups = -(-ic // gs)
    cap = gs if (gs < ic and ic % gs == 0 and gs % 32 == 0) else 2048
    pack_block = pack_block or packing.default_pack_block(ic, cap=cap)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, device=dev)

    salient = torch.rand((ic, oc), generator=generator, device=dev) >= low_frac
    codes_low = torch.randint(0, 2**low_bits, (ic, oc), generator=generator, device=dev,
                              dtype=torch.int32) * ~salient
    maxq = 15 if sidecar_bits == 4 else 255
    codes = (torch.randint(0, maxq + 1, (ic, oc), generator=generator, device=dev,
                           dtype=torch.int32) * salient).to(torch.uint8)
    sidecar = packing.pack_nibbles(codes, pack_block) if sidecar_bits == 4 else codes
    scale = uniform((n_groups, oc), 0.005, 0.015)
    if low_bits == 1:
        mean = uniform((n_groups, oc), -0.002, 0.002)
    else:
        mean = torch.full((n_groups, oc), (2**low_bits - 1) / 2, device=dev)
    return PackedLinear(
        sign_packed=torch.cat([packing.pack_bits((codes_low >> j) & 1, pack_block)
                               for j in range(low_bits)], dim=0),
        mask_packed=packing.pack_bits(salient, pack_block), sidecar=sidecar,
        low_scale=scale, low_mean=mean, high_scale=uniform((oc,), 0.002, 0.006),
        high_zero=torch.full((oc,), (maxq + 1) / 2, device=dev),
        bias=torch.randn(oc, generator=generator, device=dev) * 0.01 if bias else None,
        ic=ic, oc=oc, groupsize=gs, pack_block=pack_block, sidecar_bits=sidecar_bits,
        low_bits=low_bits)


def random_packed_opt(cfg, generator: torch.Generator, low_frac: float = 0.9,
                      groupsize: int = -1) -> Dict[str, Any]:
    """An OPT parameter tree with every decoder linear a random PBW-v1 layer
    with a random bias, and f32 embeddings (the lm_head is tied to them),
    all made on the generator's device."""
    dev = generator.device
    h, ffn = cfg.hidden_size, cfg.ffn_dim
    shapes = {"q_proj": (h, h), "k_proj": (h, h), "v_proj": (h, h), "out_proj": (h, h),
              "fc1": (h, ffn), "fc2": (ffn, h)}

    def ln():
        return {"w": torch.ones(h, device=dev), "b": torch.zeros(h, device=dev)}

    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=dev) * 0.02

    layers = []
    for _ in range(cfg.num_hidden_layers):
        lp = {"self_attn_layer_norm": ln(), "final_layer_norm": ln()}
        for name, (ic, oc) in shapes.items():
            lp[name] = random_packed_v1(ic, oc, generator, low_frac=low_frac,
                                        groupsize=groupsize, bias=True)
        layers.append(lp)
    if cfg.embed_dim != h:
        raise ValueError("random_packed_opt: word_embed_proj_dim must equal hidden_size")
    return {"embed_tokens": normal(cfg.vocab_size, h),
            "embed_positions": normal(cfg.max_position_embeddings + 2, h), "layers": layers,
            "final_layer_norm": ln(), "project_in": None, "project_out": None}


def synthetic_model(family: str, seed: int = 0, device=None, draft: bool = False):
    """(cfg, params) of the JAX CLIs' tiny synthetic model of a family
    (vocab 259, hidden 64, ffn 128, 2 layers, 4 heads, max_pos 256; with
    ``draft`` the 1-layer draft model, hidden 32, ffn 64), weights from a
    CPU torch generator seeded ``seed`` (so they differ from the JAX CLIs'),
    placed on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    h, ffn, layers = (32, 64, 1) if draft else (64, 128, 2)
    if family == "opt":
        from ..models.opt import OPTConfig, init_params

        cfg = OPTConfig(vocab_size=259, hidden_size=h, ffn_dim=ffn, num_hidden_layers=layers,
                        num_attention_heads=4, max_position_embeddings=256)
    else:
        from ..models.llama import LlamaConfig, init_params

        cfg = LlamaConfig(vocab_size=259, hidden_size=h, intermediate_size=ffn,
                          num_hidden_layers=layers, num_attention_heads=4, num_key_value_heads=4,
                          max_position_embeddings=256)
    return cfg, init_params(cfg, gen, device=device)


def write_hf_checkpoint(params: Dict[str, Any], cfg, family: str, out_dir: str,
                        dtype=torch.float16, max_shard_bytes: int = 0) -> str:
    """Write ``params`` as an HF checkpoint directory with torch alone: the
    state dict of `models.hf_export` in ``dtype`` as ``pytorch_model.bin``,
    or with ``max_shard_bytes`` as ``pytorch_model-0000k-of-0000n.bin``
    shards of at most that many bytes (tensors in state-dict order, so a
    layer may span two shards) with ``pytorch_model.bin.index.json``; and a
    ``config.json`` (`hf_export.hf_config_dict`, the architecture and the
    dtype).  Returns ``out_dir``."""
    from ..models import hf_export

    to_sd = hf_export.llama_to_state_dict if family == "llama" else hf_export.opt_to_state_dict
    sd = to_sd(params, cfg, dtype)
    os.makedirs(out_dir, exist_ok=True)
    shards, size = [[]], 0
    for k, t in sd.items():
        n = t.numel() * t.element_size()
        if max_shard_bytes and shards[-1] and size + n > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(k)
        size += n
    if max_shard_bytes:
        names = [f"pytorch_model-{i + 1:05d}-of-{len(shards):05d}.bin" for i in range(len(shards))]
        index = {"metadata": {"total_size": sum(t.numel() * t.element_size() for t in sd.values())},
                 "weight_map": {k: name for name, keys in zip(names, shards) for k in keys}}
        with open(os.path.join(out_dir, "pytorch_model.bin.index.json"), "w") as fh:
            json.dump(index, fh, indent=1)
    else:
        names = ["pytorch_model.bin"]
    for name, keys in zip(names, shards):
        torch.save({k: sd[k] for k in keys}, os.path.join(out_dir, name))
    config = dict(hf_export.hf_config_dict(cfg, family),
                  architectures=["LlamaForCausalLM" if family == "llama" else "OPTForCausalLM"],
                  torch_dtype=str(dtype).rsplit(".", 1)[-1])
    with open(os.path.join(out_dir, "config.json"), "w") as fh:
        json.dump(config, fh, indent=1)
    return out_dir
