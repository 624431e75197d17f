"""Byte-level BPE core, compatible with GPT-2/RoBERTa vocabularies.

The reference relies on HuggingFace's Rust-backed ``GPT2TokenizerFast`` /
``RobertaTokenizerFast`` (reference: vidsitu_code/dat_loader.py:21,84-102).
This is a from-scratch pure-Python implementation of the same byte-level
BPE algorithm: given the same ``vocab.json`` + ``merges.txt`` it produces
identical token ids, so vocabularies exported from HF tokenizers load
directly.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Tuple

import regex as re

# GPT-2's pre-tokenization pattern: contractions, letter runs, number runs,
# other-symbol runs, and whitespace handling with lookahead.
_PRETOK_PAT = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Invertible byte -> printable-unicode-char map (as in GPT-2)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class ByteLevelBPE:
    """Encoder/decoder over a byte-level BPE vocab + merge table."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self._cache: Dict[str, str] = {}
        # C++ encode core (vidsitu_tpu/native/bpe_core.cpp) when a
        # toolchain is available; id-parity with the Python path is
        # asserted in tests. Lazily constructed on first encode.
        self._merges_list = list(merges)
        self._native = None
        self._native_tried = False

    # -- construction --------------------------------------------------------
    @classmethod
    def from_dir(cls, vocab_dir) -> "ByteLevelBPE":
        """Load from a directory holding ``vocab.json`` and ``merges.txt``
        (the standard GPT-2/RoBERTa export format)."""
        vocab_dir = Path(vocab_dir)
        with open(vocab_dir / "vocab.json", encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(vocab_dir / "merges.txt", encoding="utf-8") as f:
            for line in f:
                line = line.strip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(vocab, merges)

    def save_dir(self, vocab_dir) -> None:
        vocab_dir = Path(vocab_dir)
        vocab_dir.mkdir(parents=True, exist_ok=True)
        with open(vocab_dir / "vocab.json", "w", encoding="utf-8") as f:
            json.dump(self.encoder, f, ensure_ascii=False)
        with open(vocab_dir / "merges.txt", "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for (a, b), _rank in sorted(self.bpe_ranks.items(), key=lambda kv: kv[1]):
                f.write(f"{a} {b}\n")

    # -- BPE -------------------------------------------------------------------
    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token)
        pairs = get_pairs(word) if len(word) > 1 else set()
        if not pairs:
            return token
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    # -- public encode/decode ----------------------------------------------------
    def _native_core(self):
        if not self._native_tried:
            self._native_tried = True
            try:
                from ..native import NativeBPE

                self._native = NativeBPE(self.encoder, self._merges_list)
            except Exception:
                self._native = None
        return self._native

    def encode_ordinary(self, text: str) -> List[int]:
        """Encode text with no special-token handling."""
        native = self._native_core()
        if native is not None:
            return native.encode(text)
        return self._encode_ordinary_py(text)

    def _encode_ordinary_py(self, text: str) -> List[int]:
        """Pure-Python reference path (also the no-toolchain fallback)."""
        ids: List[int] = []
        for tok in _PRETOK_PAT.findall(text):
            tok_b = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(tok_b).split(" "):
                ids.append(self.encoder[piece])
        return ids

    def decode_ordinary(self, ids: List[int]) -> str:
        try:
            text = "".join(self.decoder[i] for i in ids)
        except KeyError as e:
            # loud failure (HF tokenizers raise too): silently dropping
            # an out-of-vocab id would score truncated hypotheses with
            # no signal that the wrong vocab dir was loaded
            raise KeyError(
                f"token id {e.args[0]} is not in this vocab (size "
                f"{len(self.encoder)}) — ids from a model built on a "
                f"different vocab dir?"
            ) from None
        return bytearray(
            self.byte_decoder[c] for c in text if c in self.byte_decoder
        ).decode("utf-8", errors="replace")

    def __len__(self) -> int:
        return len(self.encoder)
