"""Minimal byte-level BPE trainer.

Used to fabricate small but real vocab/merges files for tests and demos
(this environment has no network access to fetch the published GPT-2
vocab). The training algorithm is the standard greedy pair-merge over a
byte-level alphabet, so the output is loadable by ``ByteLevelBPE`` and by
HF tokenizers alike.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple


from .bpe import ByteLevelBPE, bytes_to_unicode, _PRETOK_PAT


def train_byte_level_bpe(
    corpus: List[str], vocab_size: int = 512
) -> ByteLevelBPE:
    byte_enc = bytes_to_unicode()
    # base alphabet: all 256 byte symbols, in GPT-2's canonical id order
    alphabet = [byte_enc[b] for b in sorted(byte_enc)]
    vocab: Dict[str, int] = {ch: i for i, ch in enumerate(sorted(alphabet))}

    word_freq: Counter = Counter()
    for line in corpus:
        for tok in _PRETOK_PAT.findall(line):
            sym = "".join(byte_enc[b] for b in tok.encode("utf-8"))
            word_freq[sym] += 1

    words: List[List[str]] = [list(w) for w in word_freq]
    freqs: List[int] = [word_freq[w] for w in word_freq]

    merges: List[Tuple[str, str]] = []
    while len(vocab) < vocab_size:
        pair_counts: Counter = Counter()
        for w, f in zip(words, freqs):
            for a, b in zip(w, w[1:]):
                pair_counts[(a, b)] += f
        if not pair_counts:
            break
        # deterministic: max count, then lexicographic
        best = max(pair_counts.items(), key=lambda kv: (kv[1], kv[0]))[0]
        merges.append(best)
        merged = best[0] + best[1]
        # two different merge paths can produce the same surface string
        # (e.g. (a,bcd) and (ab,cd) -> 'abcd'): the symbol keeps its
        # first id — re-assigning len(vocab) would hand the same id to
        # the NEXT new symbol and break the id<->token bijection
        if merged not in vocab:
            vocab[merged] = len(vocab)
        first, second = best
        for w in words:
            i = 0
            while i < len(w) - 1:
                if w[i] == first and w[i + 1] == second:
                    w[i : i + 2] = [merged]
                else:
                    i += 1

    return ByteLevelBPE(vocab, merges)
