"""Text tokenizers: HF wrapper + deterministic byte-fallback stand-in.

The reference depends on the gated `meta-llama/Llama-2-7b-hf` tokenizer
(reference: base_llm.py:141-180 — adds <PAD>, validates BOS-prefix behavior).
Production runs here use the same HF tokenizer via `load_llama_tokenizer`;
zero-egress/dev environments fall back to `ByteFallbackTokenizer`, which keeps
every contract the framework relies on (vocab_size, BOS prepend, ids below the
action-token range, stable round trip) without any model files.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class _Encoding:
    def __init__(self, ids: List[int]):
        self.input_ids = ids


class ByteFallbackTokenizer:
    """Deterministic byte-level tokenizer over the sub-action-range vocab:
    ids = 3 + byte for UTF-8 bytes (range [3, 259)); BOS=1, EOS=2, UNK=0;
    pad at vocab_size. Never emits ids in the action-token tail."""

    vocab_size = 32000
    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 32000

    def __call__(self, text: str, **kwargs) -> _Encoding:
        return _Encoding(self.encode(text))

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [3 + b for b in text.encode("utf-8")]
        return ([self.bos_token_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        data = bytes(i - 3 for i in ids if 3 <= i < 259)
        return data.decode("utf-8", errors="replace")

    def batch_decode(self, batches, **kwargs) -> List[str]:
        return [self.decode(b) for b in batches]


def load_llama_tokenizer(path_or_id: str, add_pad: bool = True):
    """HF Llama tokenizer with the reference's <PAD> convention
    (reference llama2.py:73-76: add <PAD>, model resizes embeddings to a
    multiple of 64 — the pad id lands at 32000)."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(path_or_id, model_max_length=2048, padding_side="right")
    if add_pad and tok.pad_token is None:
        tok.add_special_tokens({"pad_token": "<PAD>"})
    return tok


def get_tokenizer(path_or_id: Optional[str] = None):
    if path_or_id:
        return load_llama_tokenizer(path_or_id)
    return ByteFallbackTokenizer()
