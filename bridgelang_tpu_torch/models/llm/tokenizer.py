"""Text tokenizers: a reader of HF `tokenizer.json` files (Llama's
SentencePiece BPE, and the ByteLevel BPE of Phi-2's CodeGen/GPT-2
tokenizer) and a deterministic byte-fallback stand-in.

The reference depends on the gated `meta-llama/Llama-2-7b-hf` tokenizer
(reference: base_llm.py:141-180 — adds <PAD>, validates BOS-prefix behavior).
Production runs read the checkpoint's own tokenizer from its
`tokenizer.json` (`load_llama_tokenizer`, no `transformers`); runs without
one use `ByteFallbackTokenizer`, which keeps every contract the framework
relies on (vocab_size, BOS prepend, ids below the action-token range,
stable round trip) without any model files.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple


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
    """A BPE tokenizer read from its HF `tokenizer.json`, in Python: the card
    has no `transformers`. Two families, as the `tokenizers` library encodes
    them:

    * Llama (SentencePiece BPE with byte fallback): the normalizer (Prepend /
      Replace) or a Metaspace pre-tokenizer turns spaces into '▁'; each piece
      starts as one symbol per character (a character outside the vocabulary
      becomes its UTF-8 bytes' `<0xXX>` tokens, or `<unk>`);
    * ByteLevel (GPT-2, CodeGen, Phi-2): the pre-tokenizer prepends a space
      to each piece with `add_prefix_space`, splits it with GPT-2's regex
      (`_gpt2_split`) and maps every UTF-8 byte to a printable character
      (`BYTE_TO_CHAR`); the ByteLevel decoder maps them back.

    Then the adjacent pair of lowest merge rank merges until none is left,
    and the post-processor's template adds BOS. Added tokens written in the
    text (Phi's "<|endoftext|>", its whitespace runs) are split out first,
    leftmost-longest, as the library's added vocabulary does. `<PAD>` is
    added after the vocabulary and the added tokens when the file has none
    (the reference's convention: pad id 32000 for Llama-2)."""

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
        self.added_tokens = spec.get("added_tokens", [])
        for t in self.added_tokens:  # unread flags: raise rather than encode apart from `tokenizers`
            flags = [k for k in ("lstrip", "rstrip", "single_word") if t.get(k)]
            if flags:
                raise NotImplementedError(f"{f}: added token {t['content']!r} sets {flags}, which are not read")
        added = {t["content"]: t["id"] for t in self.added_tokens}
        self.special_ids = {t["id"] for t in self.added_tokens if t.get("special")}
        self.vocab_size = len(self.vocab)
        bos = "<|endoftext|>" if "<s>" not in added and "<|endoftext|>" in added else "<s>"  # GPT-2 family
        eos = "<|endoftext|>" if bos == "<|endoftext|>" else "</s>"
        self.bos_token_id = added.get(bos, self.vocab.get(bos, 1))
        self.eos_token_id = added.get(eos, self.vocab.get(eos, 2))
        self.pad_token_id = added.get("<PAD>", max(self.vocab_size, max(added.values(), default=-1) + 1))
        self.id_to_token = {i: t for t, i in {**self.vocab, **added, "<PAD>": self.pad_token_id}.items()}
        self.special_ids |= {self.bos_token_id, self.eos_token_id, self.pad_token_id}
        self._normalizers = self._steps(spec.get("normalizer"))
        self._metaspace = self._find_pre_tokenizer(spec.get("pre_tokenizer"), "Metaspace")
        self._byte_level = self._find_pre_tokenizer(spec.get("pre_tokenizer"), "ByteLevel")
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
    def _find_pre_tokenizer(node, kind: str):
        """The `kind` ("Metaspace" or "ByteLevel") node of the pre-tokenizer
        (or of its Sequence), else None; any other kind raises."""
        if node is None:
            return None
        if node["type"] == "Sequence":
            found = [JsonBPETokenizer._find_pre_tokenizer(n, kind) for n in node["pretokenizers"]]
            return next((m for m in found if m), None)
        if node["type"] in ("Metaspace", "ByteLevel"):
            return node if node["type"] == kind else None
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

    def _split_added(self, text: str, normalized: bool) -> List[Tuple[str, Optional[int]]]:
        """`text` cut around the added tokens whose `normalized` flag is
        `normalized` -> [(piece, None) or (token content, id)], matching
        leftmost-longest."""
        tokens = [t for t in self.added_tokens if bool(t.get("normalized", not t.get("special"))) == normalized]
        out: List[Tuple[str, Optional[int]]] = []
        start = i = 0
        while i < len(text) and tokens:
            hits = [t for t in tokens if t["content"] and text.startswith(t["content"], i)]
            if not hits:
                i += 1
                continue
            tok = max(hits, key=lambda t: len(t["content"]))
            if i > start:
                out.append((text[start:i], None))
            out.append((tok["content"], tok["id"]))
            start = i = i + len(tok["content"])
        if start < len(text):
            out.append((text[start:], None))
        return out

    def _segments(self, text: str) -> List[Tuple[str, Optional[int], bool]]:
        """(piece, added id or None, whether the piece starts the text): the
        added tokens split out of the raw text, the normalizer run on each
        other piece, and the normalized added tokens split out of those."""
        out = []
        for piece, tid in self._split_added(text, normalized=False):
            if tid is not None:
                out.append((piece, tid, False))
                continue
            first = not out
            for step in self._normalizers:
                piece = step(piece)
            for sub, sid in self._split_added(piece, normalized=True):
                out.append((sub, sid, first and sid is None))
                first = False
        return out

    def _pieces(self, text: str, first: bool = True) -> List[str]:
        """One normalized piece -> its pre-tokenized pieces."""
        if self._byte_level is not None:
            return self._byte_level_pieces(text)
        ms = self._metaspace
        if ms is None or not text:
            return [text] if text else []
        rep = ms.get("replacement", "▁")
        text = text.replace(" ", rep)
        scheme = ms.get("prepend_scheme", "always" if ms.get("add_prefix_space", True) else "never")
        if scheme == "always" or (scheme == "first" and first):
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

    def _byte_level_pieces(self, text: str) -> List[str]:
        """The ByteLevel pre-tokenizer on one piece: a space prepended with
        `add_prefix_space`, GPT-2's split (`use_regex`), each UTF-8 byte
        mapped to its character."""
        bl = self._byte_level
        if not text:
            return []
        if bl.get("add_prefix_space", True) and not text.startswith(" "):
            text = " " + text
        parts = _gpt2_split(text) if bl.get("use_regex", True) else [text]
        return ["".join(BYTE_TO_CHAR[b] for b in p.encode("utf-8")) for p in parts]

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = []
        for piece, tid, first in self._segments(text):
            if tid is not None:
                ids.append(tid)
            else:
                ids.extend(self.vocab[t] for p in self._pieces(piece, first) for t in self._bpe(self._symbols(p)))
        return ([self.bos_token_id] + ids) if add_bos and self._template else ids

    def __call__(self, text: str, **kwargs) -> _Encoding:
        return _Encoding(self.encode(text))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        if self._byte_level is not None:
            return self._byte_level_decode(ids, skip_special_tokens)
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

    def _byte_level_decode(self, ids: Sequence[int], skip_special_tokens: bool) -> str:
        """The ByteLevel decoder: every token's characters back to bytes (a
        token holding a character outside the table gives its own UTF-8
        bytes), decoded as UTF-8 with replacement."""
        data = bytearray()
        for i in ids:
            if skip_special_tokens and i in self.special_ids:
                continue
            tok = self.id_to_token.get(int(i), self.unk_token or "")
            if all(c in CHAR_TO_BYTE for c in tok):
                data.extend(CHAR_TO_BYTE[c] for c in tok)
            else:
                data.extend(tok.encode("utf-8"))
        return data.decode("utf-8", errors="replace")

    def batch_decode(self, batches, **kwargs) -> List[str]:
        return [self.decode(b, **kwargs) for b in batches]


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> character table: printable Latin-1 bytes map to
    themselves, the other 68 to U+0100 onward, in byte order."""
    keep = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1), *range(ord("®"), ord("ÿ") + 1)]
    table, n = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + n)
            n += 1
    return table


BYTE_TO_CHAR = _bytes_to_unicode()
CHAR_TO_BYTE = {c: b for b, c in BYTE_TO_CHAR.items()}
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# Unicode's White_Space property, which the regex crate's \s matches.
WHITE_SPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
                        + "".join(chr(c) for c in range(0x2000, 0x200B)))


def _is_letter(c: str) -> bool:
    return unicodedata.category(c).startswith("L")


def _is_number(c: str) -> bool:
    return unicodedata.category(c).startswith("N")


def _is_other(c: str) -> bool:
    return c not in WHITE_SPACE and not _is_letter(c) and not _is_number(c)


def _gpt2_split(text: str) -> List[str]:
    """GPT-2's pre-tokenizer regex, as the `tokenizers` library runs it:
    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+
    -- its alternatives tried in order at each position (the card has no
    `regex` module, and Python's `re` has no \\p classes)."""
    out, i, n = [], 0, len(text)

    def run(j, pred):
        while j < n and pred(text[j]):
            j += 1
        return j

    while i < n:
        c = next((c for c in CONTRACTIONS if text.startswith(c, i)), None)
        if c:
            out.append(c)
            i += len(c)
            continue
        j = i + 1 if text[i] == " " and i + 1 < n else i
        end = None
        for pred in (_is_letter, _is_number, _is_other):
            if pred(text[j]):
                end = run(j, pred)
                break
        if end is None:  # whitespace: \s+(?!\S), else \s+
            end = run(i, WHITE_SPACE.__contains__)
            if end < n and end - i > 1:
                end -= 1  # leave the last space to the next word
        out.append(text[i:end])
        i = end
    return out


def load_llama_tokenizer(path: str) -> JsonBPETokenizer:
    """The tokenizer of a local checkpoint or tokenizer directory (its
    `tokenizer.json`: Llama's, or a ByteLevel one such as Phi-2's), with the
    reference's <PAD> convention."""
    return JsonBPETokenizer(path)


def get_tokenizer(path: Optional[str] = None):
    if path:
        return load_llama_tokenizer(path)
    return ByteFallbackTokenizer()
