"""METEOR scorer (pure Python: exact + Porter-stem matching stages,
plus an OPTIONAL synonym stage fed by external WordNet-layout data).

The reference registers pycocoevalcap's Java METEOR jar in its scorer
dict (vidsitu_code/evl_fns.py:410-432) without using it in any reported
metric. This dependency-free port implements the classic METEOR
formulation (Banerjee & Lavie 2005; the same formulation nltk ships):

    P = m / len(hyp),  R = m / len(ref)
    Fmean = P * R / (alpha * P + (1 - alpha) * R)
    penalty = gamma * (chunks / m) ** beta
    score = Fmean * (1 - penalty)           (alpha=0.9, beta=3, gamma=0.5)

with matching stages in nltk's order — exact tokens, Porter-stemmed
tokens, then (when synonym data is supplied) WordNet synonymy — each
matched greedily in reverse hypothesis order (latest unmatched reference
token wins), chunks counted as contiguous runs in both sequences, and
the max score over references.

Synonym data is NOT vendorable (WordNet license/size), so the stage is
a hook: pass ``Meteor(synonyms=...)`` a :class:`SynonymTable`, a
``{word: [synset_ids]}`` dict, a JSON file of that mapping, or a
directory in the nltk WordNet corpus layout (``index.noun`` etc.); or
set ``$VIDSITU_METEOR_SYNONYMS`` to such a path to enable it through
the evl_fns scorer registry. Without data the scorer stays exact+stem,
using the ORIGINAL 1980 Porter algorithm — exact-equal to nltk's
meteor_score(stemmer=PorterStemmer(MODE=ORIGINAL_ALGORITHM), wordnet
off), as asserted in tests. Note nltk's DEFAULT stemmer mode is
NLTK_EXTENSIONS (different stems, different scores), and the
reference's actual scorer is the METEOR 1.5 jar (unavailable here);
reported METEOR numbers are comparable only to runs of THIS scorer. The synonym stage matches when the tokens' synset-id sets
intersect; lookup is on the surface form with a Porter-stem fallback
(WordNet indexes lemmas — nltk's choice of looking up stems misses
entries like 'feline'->'felin'; the METEOR jar matches surfaces).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

_VOWELS = "aeiou"


class PorterStemmer:
    """Porter (1980) stemming algorithm, original formulation."""

    def _cons(self, word: str, i: int) -> bool:
        ch = word[i]
        if ch in _VOWELS:
            return False
        if ch == "y":
            return i == 0 or not self._cons(word, i - 1)
        return True

    def _m(self, word: str, j: int) -> int:
        """Measure: number of VC sequences in word[:j+1]."""
        n = 0
        i = 0
        while True:
            if i > j:
                return n
            if not self._cons(word, i):
                break
            i += 1
        i += 1
        while True:
            while True:
                if i > j:
                    return n
                if self._cons(word, i):
                    break
                i += 1
            i += 1
            n += 1
            while True:
                if i > j:
                    return n
                if not self._cons(word, i):
                    break
                i += 1
            i += 1

    def _vowel_in_stem(self, stem: str) -> bool:
        return any(not self._cons(stem, i) for i in range(len(stem)))

    def _double_cons(self, word: str) -> bool:
        return (
            len(word) >= 2
            and word[-1] == word[-2]
            and self._cons(word, len(word) - 1)
        )

    def _cvc(self, word: str) -> bool:
        if len(word) < 3:
            return False
        i = len(word) - 1
        return (
            self._cons(word, i)
            and not self._cons(word, i - 1)
            and self._cons(word, i - 2)
            and word[i] not in "wxy"
        )

    def _r(self, stem: str, suffix: str, word: str, m_min: int = 0) -> str:
        if self._m(stem, len(stem) - 1) > m_min:
            return stem + suffix
        return word

    def stem(self, word: str) -> str:
        w = word.lower()
        if len(w) <= 2:
            return w

        # step 1a
        if w.endswith("sses"):
            w = w[:-2]
        elif w.endswith("ies"):
            w = w[:-2]
        elif w.endswith("ss"):
            pass
        elif w.endswith("s"):
            w = w[:-1]

        # step 1b
        if w.endswith("eed"):
            if self._m(w[:-3], len(w) - 4) > 0:
                w = w[:-1]
        else:
            flag = False
            if w.endswith("ed") and self._vowel_in_stem(w[:-2]):
                w = w[:-2]
                flag = True
            elif w.endswith("ing") and self._vowel_in_stem(w[:-3]):
                w = w[:-3]
                flag = True
            if flag:
                if w.endswith(("at", "bl", "iz")):
                    w += "e"
                elif self._double_cons(w) and not w.endswith(("l", "s", "z")):
                    w = w[:-1]
                elif self._m(w, len(w) - 1) == 1 and self._cvc(w):
                    w += "e"

        # step 1c
        if w.endswith("y") and self._vowel_in_stem(w[:-1]):
            w = w[:-1] + "i"

        # step 2
        step2 = (
            ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
            ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
            ("alli", "al"), ("entli", "ent"), ("eli", "e"),
            ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
            ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
            ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
            ("iviti", "ive"), ("biliti", "ble"),
        )
        for suf, rep in step2:
            if w.endswith(suf):
                stem = w[: -len(suf)]
                if self._m(stem, len(stem) - 1) > 0:
                    w = stem + rep
                break

        # step 3
        step3 = (
            ("icate", "ic"), ("ative", ""), ("alize", "al"),
            ("iciti", "ic"), ("ical", "ic"), ("ful", ""), ("ness", ""),
        )
        for suf, rep in step3:
            if w.endswith(suf):
                stem = w[: -len(suf)]
                if self._m(stem, len(stem) - 1) > 0:
                    w = stem + rep
                break

        # step 4
        step4 = (
            "al", "ance", "ence", "er", "ic", "able", "ible", "ant",
            "ement", "ment", "ent", "ion", "ou", "ism", "ate", "iti",
            "ous", "ive", "ize",
        )
        for suf in step4:
            if w.endswith(suf):
                stem = w[: -len(suf)]
                if suf == "ion" and not stem.endswith(("s", "t")):
                    continue
                if self._m(stem, len(stem) - 1) > 1:
                    w = stem
                break

        # step 5a
        if w.endswith("e"):
            stem = w[:-1]
            m = self._m(stem, len(stem) - 1)
            if m > 1 or (m == 1 and not self._cvc(stem)):
                w = stem
        # step 5b
        if self._double_cons(w) and w.endswith("l") and self._m(
            w, len(w) - 1
        ) > 1:
            w = w[:-1]
        return w


class SynonymTable:
    """word -> frozenset(synset ids); two words are synonyms when their
    id sets intersect."""

    def __init__(self, word_to_ids: Dict[str, List[str]]):
        self._t = {
            w.lower(): frozenset(ids) for w, ids in word_to_ids.items()
        }

    def ids(self, word: str) -> frozenset:
        return self._t.get(word, frozenset())

    def synonyms(self, a: str, b: str) -> bool:
        ia = self.ids(a)
        return bool(ia) and bool(ia & self.ids(b))

    def __len__(self) -> int:
        return len(self._t)

    @classmethod
    def from_json(cls, path) -> "SynonymTable":
        with open(path) as f:
            return cls(json.load(f))

    @classmethod
    def from_wordnet_dir(cls, path) -> "SynonymTable":
        """Parse ``index.{noun,verb,adj,adv}`` (nltk WordNet corpus
        layout): each line is ``lemma pos synset_cnt p_cnt [ptrs...]
        sense_cnt tagsense_cnt offset...`` with the last ``synset_cnt``
        fields being the synset offsets."""
        table: Dict[str, set] = {}
        found = False
        for pos in ("noun", "verb", "adj", "adv"):
            p = Path(path) / f"index.{pos}"
            if not p.exists():
                continue
            found = True
            with open(p, encoding="utf-8", errors="replace") as f:
                for line in f:
                    if line.startswith(" "):
                        continue  # license header
                    fields = line.split()
                    if len(fields) < 5:
                        continue
                    lemma = fields[0].replace("_", " ").lower()
                    n_syn = int(fields[2])
                    if n_syn <= 0:
                        # fields[-0:] would return the WHOLE line and
                        # pollute the table with lemma/count fields
                        continue
                    offsets = fields[-n_syn:]
                    table.setdefault(lemma, set()).update(
                        f"{pos}.{off}" for off in offsets
                    )
        if not found:
            raise FileNotFoundError(
                f"no index.{{noun,verb,adj,adv}} under {path}"
            )
        return cls({w: sorted(ids) for w, ids in table.items()})

    @classmethod
    def load(cls, spec) -> Optional["SynonymTable"]:
        """Accept a SynonymTable / mapping / JSON path / WordNet dir /
        None."""
        if spec is None:
            return None
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            return cls(spec)
        p = Path(spec)
        if p.is_dir():
            return cls.from_wordnet_dir(p)
        return cls.from_json(p)


def _match_stage(hyp_items, ref_items):
    """One matching stage with the alignment order of the classic
    implementation (as in nltk's _match_enums): hypothesis words scanned
    in REVERSE, each matched to the latest still-unused reference word of
    the same surface form. Items are (original_index, word) pairs."""
    ref_avail = list(ref_items)
    matches: List[Tuple[int, int]] = []
    un_h = []
    for i in reversed(range(len(hyp_items))):
        idx_h, word = hyp_items[i]
        found = None
        for j in reversed(range(len(ref_avail))):
            if ref_avail[j][1] == word:
                found = j
                break
        if found is None:
            un_h.append(hyp_items[i])
        else:
            matches.append((idx_h, ref_avail[found][0]))
            ref_avail.pop(found)
    un_h.reverse()
    return matches, un_h, ref_avail


def _synonym_stage(hyp_items, ref_items, table: SynonymTable,
                   stemmer: "PorterStemmer"):
    """Match leftover tokens whose synset-id sets intersect, with the
    same reverse-scan greedy order as the surface stages. Lookup is on
    the surface form (WordNet indexes lemmas, e.g. 'feline' not 'felin')
    with a Porter-stem fallback so inflections still resolve."""

    def ids(word: str) -> frozenset:
        got = table.ids(word)
        return got if got else table.ids(stemmer.stem(word))

    ref_avail = list(ref_items)
    ref_ids = [ids(w) for _, w in ref_avail]  # stem each ref word once
    matches: List[Tuple[int, int]] = []
    for i in reversed(range(len(hyp_items))):
        idx_h, word = hyp_items[i]
        ih = ids(word)
        if not ih:
            continue
        for j in reversed(range(len(ref_avail))):
            if ih & ref_ids[j]:
                matches.append((idx_h, ref_avail[j][0]))
                ref_avail.pop(j)
                ref_ids.pop(j)
                break
    return matches


def _align(
    hyp: List[str],
    ref: List[str],
    stemmer: PorterStemmer,
    syn_table: Optional[SynonymTable] = None,
):
    """Stage-wise alignment: exact, Porter stems, then (optional)
    synonyms over the stemmed leftovers — nltk's stage order. Returns a
    list of (hyp_ix, ref_ix) matches."""
    hyp_items = list(enumerate(hyp))
    ref_items = list(enumerate(ref))
    exact, hyp_items, ref_items = _match_stage(hyp_items, ref_items)
    orig_h, orig_r = dict(hyp_items), dict(ref_items)
    stem_h = [(i, stemmer.stem(w)) for i, w in hyp_items]
    stem_r = [(j, stemmer.stem(w)) for j, w in ref_items]
    stems, stem_h, stem_r = _match_stage(stem_h, stem_r)
    if syn_table is None:
        return exact + stems
    # leftover ORIGINAL surface forms (indices survive the stem stage)
    left_h = [(i, orig_h[i]) for i, _ in stem_h]
    left_r = [(j, orig_r[j]) for j, _ in stem_r]
    syns = _synonym_stage(left_h, left_r, syn_table, stemmer)
    return exact + stems + syns


def _count_chunks(matches: List[Tuple[int, int]]) -> int:
    ms = sorted(matches)
    chunks = 0
    prev = None
    for i, j in ms:
        if prev is None or i != prev[0] + 1 or j != prev[1] + 1:
            chunks += 1
        prev = (i, j)
    return chunks


def meteor_sentence(
    hyp: str,
    refs: List[str],
    alpha: float = 0.9,
    beta: float = 3.0,
    gamma: float = 0.5,
    stemmer: PorterStemmer = None,
    syn_table: Optional[SynonymTable] = None,
) -> float:
    """Max METEOR over references for one hypothesis string."""
    stemmer = stemmer or PorterStemmer()
    htoks = hyp.lower().split()
    best = 0.0
    for ref in refs:
        rtoks = ref.lower().split()
        if not htoks or not rtoks:
            continue
        matches = _align(htoks, rtoks, stemmer, syn_table)
        m = len(matches)
        if m == 0:
            continue
        p = m / len(htoks)
        r = m / len(rtoks)
        fmean = p * r / (alpha * p + (1 - alpha) * r)
        frag = _count_chunks(matches) / m
        score = fmean * (1.0 - gamma * frag**beta)
        best = max(best, score)
    return best


class Meteor:
    """compute_score(gts, res) -> (mean score, per-sentence scores),
    coco-caption scorer API."""

    def __init__(
        self,
        alpha: float = 0.9,
        beta: float = 3.0,
        gamma: float = 0.5,
        synonyms: Union[None, str, Dict, SynonymTable] = "env",
    ):
        self.alpha, self.beta, self.gamma = alpha, beta, gamma
        self._stemmer = PorterStemmer()
        if synonyms == "env":
            # default hook: $VIDSITU_METEOR_SYNONYMS enables the stage
            # through the evl_fns scorer registry without config plumbing
            synonyms = os.environ.get("VIDSITU_METEOR_SYNONYMS") or None
        self.syn_table = SynonymTable.load(synonyms)

    def compute_score(self, gts: Dict, res: Dict):
        scores = []
        for _id in sorted(gts.keys()):
            hypo = res[_id]
            assert isinstance(hypo, list) and len(hypo) == 1
            scores.append(
                meteor_sentence(
                    hypo[0], list(gts[_id]), self.alpha, self.beta,
                    self.gamma, self._stemmer, self.syn_table,
                )
            )
        mean = sum(scores) / max(len(scores), 1)
        return mean, scores
