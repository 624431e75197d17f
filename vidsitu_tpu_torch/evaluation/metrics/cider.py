"""CIDEr with corpus document frequencies, compatible with coco-caption's
``Cider("corpus")`` (reference use: vidsitu_code/evl_fns.py:428).

Implements the canonical coco-caption CiderScorer algorithm: tf-idf n-gram
vectors (n=1..4), idf from the evaluation corpus's reference sets, clipped
cosine similarity with a Gaussian length penalty (sigma=6), scaled by 10.
All known quirks of the original are preserved (e.g. sentence "length"
accumulates *bigram* counts — ``if n == 1`` on the 0-based n-gram index).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np


def _precook(s: str, n: int = 4) -> Dict:
    words = s.split()
    counts: Dict = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i : i + k])] += 1
    return counts


class CiderScorer:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma
        self.crefs: List[List[Dict]] = []
        self.ctest: List[Dict] = []
        self.document_frequency: Dict = defaultdict(float)
        self.ref_len = None

    def cook_append(self, test: str, refs: List[str]):
        self.crefs.append([_precook(r, self.n) for r in refs])
        self.ctest.append(_precook(test, self.n))

    def _compute_doc_freq(self):
        for refs in self.crefs:
            for ngram in set(ng for ref in refs for ng in ref.keys()):
                self.document_frequency[ngram] += 1

    def _counts2vec(self, cnts: Dict):
        vec = [defaultdict(float) for _ in range(self.n)]
        length = 0
        norm = [0.0] * self.n
        for ngram, term_freq in cnts.items():
            df = np.log(max(1.0, self.document_frequency[ngram]))
            k = len(ngram) - 1
            vec[k][ngram] = float(term_freq) * (self.ref_len - df)
            norm[k] += pow(vec[k][ngram], 2)
            if k == 1:
                length += term_freq
        norm = [np.sqrt(x) for x in norm]
        return vec, norm, length

    def _sim(self, vec_hyp, vec_ref, norm_hyp, norm_ref, length_hyp, length_ref):
        delta = float(length_hyp - length_ref)
        val = np.array([0.0 for _ in range(self.n)])
        for k in range(self.n):
            for ngram, _cnt in vec_hyp[k].items():
                val[k] += (
                    min(vec_hyp[k][ngram], vec_ref[k][ngram]) * vec_ref[k][ngram]
                )
            if (norm_hyp[k] != 0) and (norm_ref[k] != 0):
                val[k] /= norm_hyp[k] * norm_ref[k]
            val[k] *= np.e ** (-(delta**2) / (2 * self.sigma**2))
        return val

    def compute_score(self):
        self._compute_doc_freq()
        assert len(self.ctest) >= max(self.document_frequency.values())
        self.ref_len = np.log(float(len(self.crefs)))
        scores = []
        for test, refs in zip(self.ctest, self.crefs):
            vec, norm, length = self._counts2vec(test)
            score = np.array([0.0 for _ in range(self.n)])
            for ref in refs:
                vec_ref, norm_ref, length_ref = self._counts2vec(ref)
                score += self._sim(vec, vec_ref, norm, norm_ref, length, length_ref)
            score_avg = np.mean(score)
            score_avg /= len(refs)
            score_avg *= 10.0
            scores.append(score_avg)
        return np.mean(np.array(scores)), np.array(scores)


class Cider:
    """compute_score(gts, res) -> (corpus score, per-sentence scores)."""

    def __init__(self, df: str = "corpus", n: int = 4, sigma: float = 6.0):
        assert df == "corpus", "only corpus document frequencies are supported"
        self.n = n
        self.sigma = sigma

    def compute_score(self, gts: Dict, res: Dict):
        scorer = CiderScorer(n=self.n, sigma=self.sigma)
        for _id in sorted(gts.keys()):
            hypo = res[_id]
            ref = gts[_id]
            assert isinstance(hypo, list) and len(hypo) == 1
            assert isinstance(ref, list) and len(ref) > 0
            scorer.cook_append(hypo[0], ref)
        return scorer.compute_score()
