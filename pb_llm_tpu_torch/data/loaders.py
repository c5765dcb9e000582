"""Calibration / evaluation text loaders (port of `pb_llm_tpu/data/loaders.py`),
with the reference's two diverging text constructions kept apart:

  PTQ flavor (`gptq_pb/datautils.py`):
    wikitext2: train joined " ", test joined "\\n\\n"
    ptb:       train and *test* split joined " "
    c4:        train = random windows of random docs; eval = the first
               1100 validation docs joined " ", cut to 256·seqlen tokens
  QAT flavor (root `datautils.py`):
    wikitext2: train and test joined "\\n\\n"
    ptb:       train and *validation* joined "\\n\\n"
    c4:        eval = 256 random validation windows (seed 0)

Calibration windows are drawn with the stdlib ``random`` module after
``random.seed(seed)``, call for call as the reference does, so a parity run
samples the same token windows.

There are no datasets offline: a `TextSource` serves only the texts it is
given (for example `data.synthetic.synthetic_source()`), and asking it for
any other split raises.  Tokens come back as numpy int64 arrays.
"""

from __future__ import annotations

import os
import pickle
import random
from typing import List, Optional, Tuple

import numpy as np


def _window_samples(token_ids: np.ndarray, nsamples: int, seqlen: int, seed: int) -> np.ndarray:
    """nsamples random [seqlen] windows (`gptq_pb/datautils.py:36-44`)."""
    random.seed(seed)
    n = token_ids.shape[-1]
    out = np.empty((nsamples, seqlen), np.int64)
    for s in range(nsamples):
        i = random.randint(0, n - seqlen - 1)
        out[s] = token_ids[i : i + seqlen]
    return out


def _doc_window_samples(doc_token_fn, ndocs: int, nsamples: int, seqlen: int, seed: int,
                        min_len_exclusive: bool) -> np.ndarray:
    """C4-style: random docs until one is long enough, then one window
    (`gptq_pb/datautils.py:77-90`; root `datautils.py:199-214` uses >=)."""
    random.seed(seed)
    out = np.empty((nsamples, seqlen), np.int64)
    for s in range(nsamples):
        while True:
            i = random.randint(0, ndocs - 1)
            enc = doc_token_fn(i)
            if (enc.shape[-1] > seqlen) if min_len_exclusive else (enc.shape[-1] >= seqlen):
                break
        j = random.randint(0, enc.shape[-1] - seqlen - 1)
        out[s] = enc[j : j + seqlen]
    return out


class TextSource:
    """A corpus given as texts: {"<dataset>/<split>": [str, ...]}."""

    def __init__(self, texts: Optional[dict] = None):
        self.texts = texts or {}

    def get(self, dataset: str, split: str) -> List[str]:
        key = f"{dataset}/{split}"
        if key in self.texts:
            return self.texts[key]
        raise FileNotFoundError(
            f"no text for {key}: the port loads no datasets (there is no network); pass "
            "TextSource({...}) with the texts, or data.synthetic.synthetic_source()")


def get_loaders(name: str, tokenizer, nsamples: int = 128, seed: int = 0, seqlen: int = 2048,
                flavor: str = "ptq", source: Optional[TextSource] = None,
                cache_dir: Optional[str] = None, model: str = "") -> Tuple[np.ndarray, np.ndarray]:
    """→ (calib [nsamples, seqlen] int64, eval_tokens [N] int64).
    ``tokenizer``: anything with `.encode(text) -> list[int]`."""
    if cache_dir:
        cache_file = os.path.join(
            cache_dir, f"{name}_{nsamples}_{seed}_{seqlen}_{flavor}_{model.replace('/', '_')}.pkl")
        if os.path.exists(cache_file):
            with open(cache_file, "rb") as fh:
                return pickle.load(fh)

    src = source or TextSource()

    def enc(text):
        return np.asarray(tokenizer.encode(text), np.int64)

    if name == "wikitext2":
        join_train = " " if flavor == "ptq" else "\n\n"
        train = enc(join_train.join(src.get("wikitext2", "train")))
        evaltok = enc("\n\n".join(src.get("wikitext2", "test")))
        calib = _window_samples(train, nsamples, seqlen, seed)
    elif name == "ptb":
        if flavor == "ptq":
            train = enc(" ".join(src.get("ptb", "train")))
            evaltok = enc(" ".join(src.get("ptb", "test")))
        else:
            train = enc("\n\n".join(src.get("ptb", "train")))
            evaltok = enc("\n\n".join(src.get("ptb", "validation")))
        calib = _window_samples(train, nsamples, seqlen, seed)
    elif name == "c4":
        train_docs = src.get("c4", "train")
        calib = _doc_window_samples(lambda i: enc(train_docs[i]), len(train_docs), nsamples,
                                    seqlen, seed, min_len_exclusive=(flavor == "ptq"))
        val_docs = src.get("c4", "validation")
        if flavor == "ptq":
            evaltok = enc(" ".join(val_docs[:1100]))[: 256 * seqlen]
        else:
            evaltok = _doc_window_samples(lambda i: enc(val_docs[i]), len(val_docs), 256, seqlen,
                                          0, min_len_exclusive=False).reshape(-1)
    elif name == "mix":
        # 1/3 each with the remainder on wikitext2, no eval set (datautils.py:245-257)
        n3 = nsamples // 3
        c_w, _ = get_loaders("wikitext2", tokenizer, n3 + (nsamples - 3 * n3), seed, seqlen, flavor, src)
        c_p, _ = get_loaders("ptb", tokenizer, n3, seed, seqlen, flavor, src)
        c_c, _ = get_loaders("c4", tokenizer, n3, seed, seqlen, flavor, src)
        calib = np.concatenate([c_w, c_p, c_c], axis=0)
        evaltok = np.zeros((0,), np.int64)
    else:
        raise NotImplementedError(f"dataset {name}")

    result = (calib, evaltok)
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        with open(cache_file, "wb") as fh:
            pickle.dump(result, fh)
    return result


def get_eval_tokens(name: str, tokenizer, source: Optional[TextSource] = None) -> np.ndarray:
    """QAT-eval text (`datautils.py:260-286`): all splits joined "\\n\\n"."""
    src = source or TextSource()
    split = {"wikitext2": "test", "ptb": "validation", "c4": "validation"}
    if name not in split:
        raise NotImplementedError(name)
    return np.asarray(tokenizer.encode("\n\n".join(src.get(name, split[name]))), np.int64)


def get_qat_dataset(name: str, tokenizer, data_percent: float = 100, seqlen: int = 2048,
                    batch_size: int = 2, seed: int = 42, source: Optional[TextSource] = None):
    """Training batches for QAT (`datautils.py:18-49`): tokenized docs in the
    order of `np.random.default_rng(seed).permutation`, truncated to seqlen,
    right-padded with 0 to the batch's longest; yields {"input_ids",
    "attention_mask"} int64 numpy batches forever.  red_pajama with
    ``data_percent`` != 100 takes the first int(850000·percent/100) docs (a
    fixed 850k total, not the split's length); english_quotes takes no
    percent slice."""
    src = source or TextSource()
    if name in ("red_pajama", "redpajama"):
        docs = src.get("red_pajama", "train")
        if data_percent != 100:
            docs = docs[: int(850000 * data_percent / 100)]
    elif name in ("Abirate/english_quotes", "english_quotes"):
        docs = src.get("english_quotes", "train")
    else:
        docs = src.get(name, "train")
        if data_percent != 100:
            docs = docs[: int(len(docs) * data_percent / 100)]
    order = np.random.default_rng(seed).permutation(len(docs))

    def batches():
        i = 0
        while True:
            ids_list, mask_list = [], []
            for _ in range(batch_size):
                text = docs[order[i % len(order)]]
                i += 1
                ids = np.asarray(tokenizer.encode(text), np.int64)[:seqlen]
                ids_list.append(ids)
                mask_list.append(np.ones_like(ids))
            maxlen = max(len(x) for x in ids_list)

            def pad(xs):
                return np.stack([np.pad(x, (0, maxlen - len(x))) for x in xs])

            yield {"input_ids": pad(ids_list), "attention_mask": pad(mask_list)}

    return batches()
