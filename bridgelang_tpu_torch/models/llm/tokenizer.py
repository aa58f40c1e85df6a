"""Text tokenizers: a reader of the Llama `tokenizer.json` + a deterministic
byte-fallback stand-in.

The reference depends on the gated `meta-llama/Llama-2-7b-hf` tokenizer
(reference: base_llm.py:141-180 — adds <PAD>, validates BOS-prefix behavior).
Production runs read the same Llama tokenizer from its `tokenizer.json`
(`load_llama_tokenizer`, no `transformers`); runs without one use
`ByteFallbackTokenizer`, which keeps
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


class JsonBPETokenizer:
    """A Llama tokenizer read from its HF `tokenizer.json` (SentencePiece BPE
    with byte fallback), in Python: the card has no `transformers`.

    Encoding follows the `tokenizers` library for this family: the
    normalizer (Prepend / Replace) or a Metaspace pre-tokenizer turns spaces
    into '▁'; each piece starts as one symbol per character (a character
    outside the vocabulary becomes its UTF-8 bytes' `<0xXX>` tokens, or
    `<unk>`); the adjacent pair of lowest merge rank merges until none is
    left; the post-processor's template adds BOS. `<PAD>` is added after the
    vocabulary when the file has none (the reference's convention: pad id
    32000 for Llama-2). Added tokens written inside the text are not parsed
    out: prompts carry none."""

    def __init__(self, path: str):
        import json
        from pathlib import Path

        f = Path(path)
        if f.is_dir():
            f = f / "tokenizer.json"
        spec = json.loads(f.read_text(encoding="utf-8"))
        model = spec["model"]
        if model.get("type") != "BPE":
            raise NotImplementedError(f"{f}: model type {model.get('type')!r}; only BPE (Llama) is read")
        self.vocab = dict(model["vocab"])
        self.byte_fallback = bool(model.get("byte_fallback", False))
        self.unk_token = model.get("unk_token")
        self.ranks = {}
        for rank, m in enumerate(model["merges"]):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.ranks[(a, b)] = rank
        added = {t["content"]: t["id"] for t in spec.get("added_tokens", [])}
        self.special_ids = {t["id"] for t in spec.get("added_tokens", []) if t.get("special")}
        self.vocab_size = len(self.vocab)
        self.bos_token_id = added.get("<s>", self.vocab.get("<s>", 1))
        self.eos_token_id = added.get("</s>", self.vocab.get("</s>", 2))
        self.pad_token_id = added.get("<PAD>", max(self.vocab_size, max(added.values(), default=-1) + 1))
        self.id_to_token = {i: t for t, i in {**self.vocab, **added, "<PAD>": self.pad_token_id}.items()}
        self.special_ids |= {self.bos_token_id, self.eos_token_id, self.pad_token_id}
        self._normalizers = self._steps(spec.get("normalizer"))
        self._metaspace = self._find_metaspace(spec.get("pre_tokenizer"))
        self._template = self._bos_template(spec.get("post_processor"))

    @staticmethod
    def _steps(node):
        if node is None:
            return []
        if node["type"] == "Sequence":
            return [s for n in node["normalizers"] for s in JsonBPETokenizer._steps(n)]
        if node["type"] == "Prepend":
            return [lambda t, p=node["prepend"]: p + t if t else t]
        if node["type"] == "Replace" and "String" in node["pattern"]:
            return [lambda t, a=node["pattern"]["String"], b=node["content"]: t.replace(a, b)]
        raise NotImplementedError(f"tokenizer.json normalizer {node['type']!r} is not read")

    @staticmethod
    def _find_metaspace(node):
        if node is None:
            return None
        if node["type"] == "Sequence":
            found = [JsonBPETokenizer._find_metaspace(n) for n in node["pretokenizers"]]
            return next((m for m in found if m), None)
        if node["type"] == "Metaspace":
            return node
        raise NotImplementedError(f"tokenizer.json pre_tokenizer {node['type']!r} is not read")

    def _bos_template(self, node) -> bool:
        """True when the single-sequence template puts a special token first."""
        if node is None:
            return False
        if node["type"] == "TemplateProcessing":
            return "SpecialToken" in node["single"][0]
        if node["type"] == "Sequence":
            return any(self._bos_template(n) for n in node["processors"])
        return False

    def _pieces(self, text: str) -> List[str]:
        for step in self._normalizers:
            text = step(text)
        ms = self._metaspace
        if ms is None or not text:
            return [text] if text else []
        rep = ms.get("replacement", "▁")
        text = text.replace(" ", rep)
        if ms.get("prepend_scheme", "always" if ms.get("add_prefix_space", True) else "never") != "never":
            text = text if text.startswith(rep) else rep + text
        if not ms.get("split", True):
            return [text] if text else []
        pieces, cur = [], ""
        for ch in text:
            if ch == rep and cur:
                pieces.append(cur)
                cur = ""
            cur += ch
        return pieces + ([cur] if cur else [])

    def _symbols(self, piece: str) -> List[str]:
        out: List[str] = []
        for ch in piece:
            if ch in self.vocab:
                out.append(ch)
            elif self.byte_fallback and all(f"<0x{b:02X}>" in self.vocab for b in ch.encode("utf-8")):
                out.extend(f"<0x{b:02X}>" for b in ch.encode("utf-8"))
            elif out and out[-1] == self.unk_token:
                continue  # fuse_unk
            else:
                out.append(self.unk_token)
        return out

    def _bpe(self, symbols: List[str]) -> List[str]:
        while len(symbols) > 1:
            ranked = [(self.ranks.get(pair, None), i) for i, pair in enumerate(zip(symbols, symbols[1:]))]
            ranked = [(r, i) for r, i in ranked if r is not None]
            if not ranked:
                break
            _, i = min(ranked)
            symbols = symbols[:i] + [symbols[i] + symbols[i + 1]] + symbols[i + 2:]
        return symbols

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [self.vocab[t] for p in self._pieces(text) for t in self._bpe(self._symbols(p))]
        return ([self.bos_token_id] + ids) if add_bos and self._template else ids

    def __call__(self, text: str, **kwargs) -> _Encoding:
        return _Encoding(self.encode(text))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out, pending = [], bytearray()
        for i in ids:
            if skip_special_tokens and i in self.special_ids:
                continue
            tok = self.id_to_token.get(int(i), self.unk_token or "")
            if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
                pending.append(int(tok[3:5], 16))
                continue
            if pending:
                out.append(pending.decode("utf-8", errors="replace"))
                pending = bytearray()
            out.append(tok.replace("▁", " "))
        if pending:
            out.append(pending.decode("utf-8", errors="replace"))
        text = "".join(out)
        return text[1:] if text.startswith(" ") else text

    def batch_decode(self, batches, **kwargs) -> List[str]:
        return [self.decode(b, **kwargs) for b in batches]


def load_llama_tokenizer(path: str) -> JsonBPETokenizer:
    """The Llama tokenizer of a local checkpoint or tokenizer directory (its
    `tokenizer.json`), with the reference's <PAD> convention."""
    return JsonBPETokenizer(path)


def get_tokenizer(path: Optional[str] = None):
    if path:
        return load_llama_tokenizer(path)
    return ByteFallbackTokenizer()
