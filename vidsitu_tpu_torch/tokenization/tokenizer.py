"""HF-compatible tokenizer wrappers over the pure-Python byte-level BPE.

Replaces the Rust-backed ``GPT2TokenizerFast``/``RobertaTokenizerFast`` the
reference uses (vidsitu_code/dat_loader.py:21,84-122). API kept call-
compatible with the subset the reference exercises:

  * ``tok(text) -> {"input_ids": [...], "attention_mask": [...]}``
  * ``tok.encode(text)``, ``tok.decode(ids, skip_special_tokens=...)``
  * ``tok.get_added_vocab()``, ``len(tok)``
  * ``pad_token_id / unk_token_id / eos_token_id / bos_token_id /
    sep_token / sep_token_id``
  * fairseq ``Dictionary`` protocol: ``pad() / unk() / eos() / bos()``
    — the reference monkey-patches these onto the HF class
    (dat_loader.py:91-102); here they are first-class methods.

Added tokens are matched atomically before BPE, mirroring HF semantics for
``add_tokens`` / ``add_special_tokens``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import regex as re

from .bpe import ByteLevelBPE


class BPETokenizer:
    """Byte-level BPE tokenizer with added-token and special-token support."""

    def __init__(
        self,
        bpe: ByteLevelBPE,
        special_tokens: Optional[Dict[str, str]] = None,
        added_tokens: Optional[Dict[str, int]] = None,
        add_bos_eos: bool = False,
    ):
        self.bpe = bpe
        self.special_tokens = dict(special_tokens or {})
        self.added_tokens: Dict[str, int] = dict(added_tokens or {})
        # tokens that live in the BASE vocab but must still be matched
        # atomically before BPE (HF semantics: a special like '</s>'
        # already present in an official vocab.json is never split into
        # '</','s','>' subwords). token -> its base-vocab id.
        self.atomic_base: Dict[str, int] = {}
        self.additional_special_tokens: List[str] = list(
            (special_tokens or {}).get("additional_special_tokens", [])
        )
        self.add_bos_eos = add_bos_eos
        self._rebuild()

    def _rebuild(self):
        self._added_decoder = {v: k for k, v in self.added_tokens.items()}
        self._atomic = {**self.atomic_base, **self.added_tokens}
        if self._atomic:
            pat = "|".join(
                re.escape(t)
                for t in sorted(self._atomic, key=len, reverse=True)
            )
            self._added_pat = re.compile(f"({pat})")
        else:
            self._added_pat = None
        self._special_ids = set()
        for name in ("pad", "unk", "eos", "bos", "sep", "cls", "mask"):
            tid = self._token_id(self.special_tokens.get(f"{name}_token"))
            if tid is not None:
                self._special_ids.add(tid)
        for t in getattr(self, "additional_special_tokens", []):
            tid = self._token_id(t)
            if tid is not None:
                self._special_ids.add(tid)

    # -- vocab management ------------------------------------------------------
    def _token_id(self, token: Optional[str]) -> Optional[int]:
        if token is None:
            return None
        if token in self.added_tokens:
            return self.added_tokens[token]
        if token in self.bpe.encoder:
            return self.bpe.encoder[token]
        return None

    def add_tokens(self, tokens: List[str]) -> int:
        """Append new atomic tokens at the end of the vocab (HF semantics).
        A token already in the BASE vocab keeps its id but is still
        registered for atomic matching (HF never BPE-splits an added
        token, wherever its id lives)."""
        n_added = 0
        for t in tokens:
            if t in self.added_tokens or t in self.atomic_base:
                continue
            if t in self.bpe.encoder:
                self.atomic_base[t] = self.bpe.encoder[t]
            else:
                self.added_tokens[t] = len(self)
                n_added += 1
        self._rebuild()
        return n_added

    def add_special_tokens(self, mapping: Dict[str, str]) -> int:
        """mapping like {"pad_token": "<pad>"}; adds to vocab if missing."""
        n = 0
        for name, tok in mapping.items():
            if name == "additional_special_tokens":
                n += self.add_tokens(list(tok))
                self.additional_special_tokens.extend(
                    t for t in tok if t not in self.additional_special_tokens
                )
                continue
            n += self.add_tokens([tok])
            self.special_tokens[name] = tok
        self._rebuild()
        return n

    def get_added_vocab(self) -> Dict[str, int]:
        return dict(self.added_tokens)

    def get_vocab(self) -> Dict[str, int]:
        out = dict(self.bpe.encoder)
        out.update(self.added_tokens)
        return out

    def convert_tokens_to_ids(self, token: str) -> Optional[int]:
        return self._token_id(token)

    def __len__(self) -> int:
        return len(self.bpe) + len(self.added_tokens)

    # -- special token ids --------------------------------------------------------
    @property
    def pad_token_id(self):
        return self._token_id(self.special_tokens.get("pad_token"))

    @property
    def unk_token_id(self):
        return self._token_id(self.special_tokens.get("unk_token"))

    @property
    def eos_token_id(self):
        return self._token_id(self.special_tokens.get("eos_token"))

    @property
    def bos_token_id(self):
        return self._token_id(self.special_tokens.get("bos_token"))

    @property
    def sep_token(self):
        return self.special_tokens.get("sep_token")

    @property
    def sep_token_id(self):
        return self._token_id(self.special_tokens.get("sep_token"))

    @property
    def cls_token_id(self):
        return self._token_id(self.special_tokens.get("cls_token"))

    @property
    def mask_token_id(self):
        return self._token_id(self.special_tokens.get("mask_token"))

    # fairseq Dictionary protocol (reference: dat_loader.py:91-102,
    # seq_gen.py:78-80)
    def pad(self):
        return self.pad_token_id

    def unk(self):
        return self.unk_token_id

    def eos(self):
        return self.eos_token_id

    def bos(self):
        bid = self.bos_token_id
        return bid if bid is not None else self.eos_token_id

    # -- encode/decode ----------------------------------------------------------
    def _encode_no_special(self, text: str) -> List[int]:
        if self._added_pat is None:
            return self.bpe.encode_ordinary(text)
        ids: List[int] = []
        for chunk in self._added_pat.split(text):
            if not chunk:
                continue
            if chunk in self._atomic:
                ids.append(self._atomic[chunk])
            else:
                ids.extend(self.bpe.encode_ordinary(chunk))
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = self._encode_no_special(text)
        if add_special_tokens and self.add_bos_eos:
            return [self.bos_token_id] + ids + [self.eos_token_id]
        return ids

    def __call__(self, text: str, add_special_tokens: bool = True) -> Dict:
        ids = self.encode(text, add_special_tokens=add_special_tokens)
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}

    @staticmethod
    def clean_up_tokenization(out_string: str) -> str:
        """transformers' PreTrainedTokenizerBase.clean_up_tokenization,
        behavior-identical: the reference decodes generated SRL text
        with the HF default clean_up_tokenization_spaces=True
        (evl_vsitu.py:203), so ' .' -> '.', \" n't\" -> \"n't\", etc.
        must be applied before the SRL parser sees the string."""
        return (
            out_string.replace(" .", ".").replace(" ?", "?")
            .replace(" !", "!").replace(" ,", ",").replace(" ' ", "' ")
            .replace(" n't", "n't").replace(" 'm", "'m")
            .replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re")
        )

    def decode(self, ids, skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: bool = True) -> str:
        ids = [int(i) for i in ids]
        if skip_special_tokens:
            ids = [i for i in ids if i not in self._special_ids]
        pieces: List[str] = []
        run: List[int] = []

        def flush():
            if run:
                pieces.append(self.bpe.decode_ordinary(run))
                run.clear()

        for i in ids:
            if i in self._added_decoder:
                flush()
                pieces.append(self._added_decoder[i])
            else:
                run.append(i)
        flush()
        out = "".join(pieces)
        if clean_up_tokenization_spaces:
            out = self.clean_up_tokenization(out)
        return out

    # -- persistence --------------------------------------------------------------
    def save_dir(self, out_dir) -> None:
        out_dir = Path(out_dir)
        self.bpe.save_dir(out_dir)
        meta = {
            "special_tokens": self.special_tokens,
            "added_tokens": self.added_tokens,
            "atomic_base": self.atomic_base,
            "additional_special_tokens": self.additional_special_tokens,
            "add_bos_eos": self.add_bos_eos,
        }
        with open(out_dir / "tokenizer_meta.json", "w") as f:
            json.dump(meta, f, indent=1)

    @classmethod
    def from_dir(cls, vocab_dir) -> "BPETokenizer":
        vocab_dir = Path(vocab_dir)
        bpe = ByteLevelBPE.from_dir(vocab_dir)
        meta_p = vocab_dir / "tokenizer_meta.json"
        if meta_p.exists():
            with open(meta_p) as f:
                meta = json.load(f)
        else:
            meta = {"special_tokens": {}, "added_tokens": {}, "add_bos_eos": False}
        tok = cls(
            bpe,
            special_tokens=meta.get("special_tokens", {}),
            added_tokens={k: int(v) for k, v in meta.get("added_tokens", {}).items()},
            add_bos_eos=meta.get("add_bos_eos", False),
        )
        tok.additional_special_tokens = list(
            meta.get("additional_special_tokens", [])
        )
        tok.atomic_base = {
            k: int(v) for k, v in meta.get("atomic_base", {}).items()
        }
        tok._rebuild()
        return tok


def make_gpt2_tokenizer(bpe: ByteLevelBPE) -> BPETokenizer:
    """GPT-2 flavor: eos==bos=='<|endoftext|>', no auto bos/eos wrapping."""
    tok = BPETokenizer(bpe, add_bos_eos=False)
    tok.add_special_tokens(
        {
            "eos_token": "<|endoftext|>",
            "bos_token": "<|endoftext|>",
            "unk_token": "<|endoftext|>",
        }
    )
    return tok


def make_roberta_tokenizer(bpe: ByteLevelBPE) -> BPETokenizer:
    """RoBERTa flavor: <s>/</s>/<pad>/<unk>/<mask>, wraps with <s>..</s>."""
    tok = BPETokenizer(bpe, add_bos_eos=True)
    tok.add_special_tokens(
        {
            "bos_token": "<s>",
            "eos_token": "</s>",
            "sep_token": "</s>",
            "cls_token": "<s>",
            "pad_token": "<pad>",
            "unk_token": "<unk>",
            "mask_token": "<mask>",
        }
    )
    return tok


def build_vidsitu_gpt2_tokenizer(
    bpe: ByteLevelBPE, verb_ids: List[str], arg_names: List[str]
) -> BPETokenizer:
    """Reproduce the reference's augmented GPT-2 vocab.

    The reference pickles a GPT2TokenizerFast with added tokens: verb ids
    (e.g. ``speak.01``), arg separators ``<Arg0>``/``</Arg0>``/..., an
    ``<EV_SEP>`` event separator, and a pad token
    (dat_loader.py:87-122,249-252). Same construction here, from a base
    BPE vocab plus the task vocabulary.
    """
    tok = make_gpt2_tokenizer(bpe)
    seps: List[str] = ["<EV_SEP>"]
    for ag in arg_names:
        seps.append(f"<{ag}>")
        seps.append(f"</{ag}>")
    # arg separators are PLAIN added tokens: they must survive
    # decode(skip_special_tokens=True) so the SRL parser can split on
    # them (evl_vsitu.py:174-206 decodes then parses '<ArgX>').
    tok.add_tokens(seps)
    tok.add_tokens(list(verb_ids))
    tok.add_special_tokens({"pad_token": "<|pad|>"})
    return tok
