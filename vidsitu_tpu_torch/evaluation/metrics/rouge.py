"""ROUGE-L, compatible with pycocoevalcap's ``Rouge``
(reference use: vidsitu_code/evl_fns.py:429): max precision/recall over
references via LCS, F-beta with beta=1.2, corpus score = mean of sentence
scores.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _lcs_len(a: List[str], b: List[str]) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for x in a:
        curr = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            if x == y:
                curr[j] = prev[j - 1] + 1
            else:
                curr[j] = max(curr[j - 1], prev[j])
        prev = curr
    return prev[len(b)]


class Rouge:
    def __init__(self):
        self.beta = 1.2

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        assert len(candidate) == 1
        assert len(refs) > 0
        prec = []
        rec = []
        token_c = candidate[0].split(" ")
        for reference in refs:
            token_r = reference.split(" ")
            lcs = _lcs_len(token_r, token_c)
            prec.append(lcs / float(len(token_c)))
            rec.append(lcs / float(len(token_r)))
        prec_max = max(prec)
        rec_max = max(rec)
        if prec_max != 0 and rec_max != 0:
            return ((1 + self.beta**2) * prec_max * rec_max) / float(
                rec_max + self.beta**2 * prec_max
            )
        return 0.0

    def compute_score(self, gts: Dict, res: Dict):
        scores = [self.calc_score(res[_id], gts[_id]) for _id in sorted(gts.keys())]
        return np.mean(np.array(scores)), np.array(scores)
