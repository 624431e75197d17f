"""Corpus BLEU, algorithm-compatible with pycocoevalcap's ``Bleu(4)``.

The reference scores SRL role strings through the coco-caption BLEU scorer
(reference: vidsitu_code/evl_fns.py:410-432). This is a dependency-free
reimplementation of the same algorithm (clipped n-gram counts, "closest"
reference length, brevity penalty, tiny/small smoothing constants) so it
produces the same numbers on the same inputs.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple


def _precook(s: str, n: int = 4) -> Tuple[int, Dict]:
    words = s.split()
    counts: Dict = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i : i + k])] += 1
    return len(words), counts


def _cook_refs(refs: List[str], n: int = 4):
    reflen = []
    maxcounts: Dict = {}
    for ref in refs:
        rl, counts = _precook(ref, n)
        reflen.append(rl)
        for ngram, count in counts.items():
            maxcounts[ngram] = max(maxcounts.get(ngram, 0), count)
    return reflen, maxcounts


def _cook_test(test: str, reflen_refmax, n: int = 4):
    reflen, refmaxcounts = reflen_refmax
    testlen, counts = _precook(test, n)
    result = {
        "testlen": testlen,
        "reflen": reflen,
        "guess": [max(0, testlen - k + 1) for k in range(1, n + 1)],
        "correct": [0] * n,
    }
    for ngram, count in counts.items():
        result["correct"][len(ngram) - 1] += min(refmaxcounts.get(ngram, 0), count)
    return result


def _single_reflen(reflens: List[int], option: str, testlen: int) -> float:
    if option == "shortest":
        return min(reflens)
    if option == "average":
        return float(sum(reflens)) / len(reflens)
    if option == "closest":
        return min((abs(l - testlen), l) for l in reflens)[1]
    raise NotImplementedError(option)


class Bleu:
    """compute_score(gts, res) -> ([bleu1..4], [[sent scores]*4])."""

    def __init__(self, n: int = 4, verbose: int = 0):
        self.n = n

    def compute_score(self, gts: Dict, res: Dict):
        n = self.n
        small = 1e-9
        tiny = 1e-15
        ctest = []
        option = "closest"
        ids = sorted(gts.keys())
        for _id in ids:
            hypo = res[_id]
            ref = gts[_id]
            assert isinstance(hypo, list) and len(hypo) == 1
            assert isinstance(ref, list) and len(ref) >= 1
            ctest.append(_cook_test(hypo[0], _cook_refs(ref, n), n))

        bleu_list: List[List[float]] = [[] for _ in range(n)]
        total_testlen = 0
        total_reflen = 0.0
        totalcomps = {"guess": [0] * n, "correct": [0] * n}
        for comps in ctest:
            testlen = comps["testlen"]
            total_testlen += testlen
            reflen = _single_reflen(comps["reflen"], option, testlen)
            total_reflen += reflen
            for key in ("guess", "correct"):
                for k in range(n):
                    totalcomps[key][k] += comps[key][k]
            bleu = 1.0
            for k in range(n):
                bleu *= (float(comps["correct"][k]) + tiny) / (
                    float(comps["guess"][k]) + small
                )
                bleu_list[k].append(bleu ** (1.0 / (k + 1)))
            ratio = (testlen + tiny) / (reflen + small)
            if ratio < 1:
                for k in range(n):
                    bleu_list[k][-1] *= math.exp(1 - 1 / ratio)

        bleus = []
        bleu = 1.0
        for k in range(n):
            bleu *= (float(totalcomps["correct"][k]) + tiny) / (
                float(totalcomps["guess"][k]) + small
            )
            bleus.append(bleu ** (1.0 / (k + 1)))
        ratio = (total_testlen + tiny) / (total_reflen + small)
        if ratio < 1:
            for k in range(n):
                bleus[k] *= math.exp(1 - 1 / ratio)
        return bleus, bleu_list
