"""Convert a HuggingFace tokenizer object into our ``BPETokenizer``.

The reference's GPT-2 task vocabulary ships as a *pickled*
``GPT2TokenizerFast`` (dat_loader.py:87-89). This module extracts
vocab/merges/added-tokens/specials from a live HF tokenizer (slow or
fast) so reference vocab pickles convert once into our directory format.
"""

from __future__ import annotations

import json
from typing import List, Tuple

from .bpe import ByteLevelBPE
from .tokenizer import BPETokenizer


def _merges_from_hf(tok) -> List[Tuple[str, str]]:
    if hasattr(tok, "bpe_ranks"):  # slow tokenizer
        return [p for p, _ in sorted(tok.bpe_ranks.items(), key=lambda kv: kv[1])]
    # fast tokenizer: read the serialized rust model
    data = json.loads(tok._tokenizer.to_str())
    merges = data["model"]["merges"]
    out = []
    for m in merges:
        if isinstance(m, str):
            a, b = m.split(" ")
        else:
            a, b = m
        out.append((a, b))
    return out


def _base_vocab_from_hf(tok) -> dict:
    if hasattr(tok, "encoder"):  # slow tokenizer: the BPE model's vocab
        return dict(tok.encoder)
    data = json.loads(tok._tokenizer.to_str())
    return dict(data["model"]["vocab"])


def from_hf_tokenizer(tok) -> BPETokenizer:
    """Build an equivalent BPETokenizer from a HF GPT-2/RoBERTa tokenizer."""
    added = dict(tok.get_added_vocab())
    # the BASE vocab is the BPE model's own (complete — no id gaps for
    # specials that live in it, e.g. <|endoftext|>); added tokens that
    # are ALSO base entries stay in the base vocab and are registered
    # for atomic matching below
    base_vocab = _base_vocab_from_hf(tok)
    dual = [t for t, i in added.items()
            if t in base_vocab and base_vocab[t] == i]
    for t in dual:
        del added[t]
    bpe = ByteLevelBPE(base_vocab, _merges_from_hf(tok))

    specials = {}
    smap = dict(getattr(tok, "special_tokens_map", {}) or {})
    extra = smap.pop("additional_special_tokens", [])
    for name, t in smap.items():
        if isinstance(t, str):
            specials[name] = t
    out = BPETokenizer(
        bpe,
        special_tokens=specials,
        added_tokens=added,
        add_bos_eos=bool(specials.get("bos_token"))
        and specials.get("bos_token") != specials.get("eos_token"),
    )
    if dual:
        out.add_tokens(dual)  # registers atomic_base matching
    if extra:
        out.additional_special_tokens = list(extra)
        out._rebuild()
    return out
