"""Shared tokenizer loader with the reference's LLaMA id fixup (port of
`pb_llm_tpu/utils/tokenizer.py`).

The reference forces ``bos_token_id=1, eos_token_id=2`` on LLaMA tokenizers
(`gptq_pb/datautils.py:14-26`, a transformers-4.28 compat fix): a drifted
llama tokenizer config would shift every calibration window and eval text.
Needs `transformers`; the CLIs call it only for HF models.
"""

from __future__ import annotations


def get_tokenizer(model_id: str):
    """`AutoTokenizer.from_pretrained(model_id, use_fast=False)` plus the
    LLaMA BOS/EOS pin.  Slow tokenizers throughout: the reference's window
    replay is pinned to their tokenizations."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_id, use_fast=False)
    # Pin only llama-1/2 sentencepiece tokenizers (vocab 32000), which the
    # reference's fix targets: Llama-3-style ids (bos 128000, eos 128001)
    # are left alone.
    if "llama" in model_id.lower() and getattr(tok, "vocab_size", None) == 32000:
        if (getattr(tok, "bos_token_id", None) != 1
                or getattr(tok, "eos_token_id", None) != 2):
            try:
                tok.bos_token_id = 1
                tok.eos_token_id = 2
            except AttributeError:  # pragma: no cover - exotic tokenizers
                pass
    return tok
