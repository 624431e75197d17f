"""Coreference metrics: mentions / MUC / B-cubed / CEAF-e / LEA / LEA-soft.

Re-implements the coval evaluator family the reference scores coreference
with (reference: vidsitu_code/evl_fns.py:13-15,434-448,561-653; the coval
fork submodule). Clusters are lists of hashable mentions; the reference
uses ``"{Ev_i}_{ArgName}"`` strings grouped by surface string.

``lea_soft`` is an unpublished extension in the reference's coval fork;
its call site passes ``cider_for_sys`` — per-system-cluster lists of the
per-mention sentence-CIDEr scores (evl_fns.py:629-649). We implement it as
LEA with the *precision* side's link and mention contributions weighted by
those CIDEr scores (clipped to [0, 1]): a resolved link only counts as
much as the quality of the generated mention strings supporting it. The
recall side is standard LEA. Semantics inferred from the call site; see
docstring of ``lea_soft``.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment


def get_mention_assignments(inp_clusters, out_clusters) -> Dict:
    mention_cluster_ids = {}
    out_dic = {}
    for i, cluster in enumerate(out_clusters):
        for mention in cluster:
            out_dic[mention] = i
    for cluster in inp_clusters:
        for mention in cluster:
            if mention in out_dic:
                mention_cluster_ids[mention] = out_dic[mention]
    return mention_cluster_ids


def f1(p_num, p_den, r_num, r_den, beta=1.0) -> float:
    p = 0 if p_den == 0 else p_num / float(p_den)
    r = 0 if r_den == 0 else r_num / float(r_den)
    return 0 if p + r == 0 else (1 + beta * beta) * p * r / (beta * beta * p + r)


# ---------------------------------------------------------------------------
# metric functions (coval signatures)
# ---------------------------------------------------------------------------


def mentions(clusters, mention_to_gold):
    setofmentions = set(m for cl in clusters for m in cl)
    correct = setofmentions & set(mention_to_gold.keys())
    return len(correct), len(setofmentions)


def b_cubed(clusters, mention_to_gold):
    num, den = 0, 0
    for c in clusters:
        gold_counts = Counter()
        correct = 0
        for m in c:
            if m in mention_to_gold:
                gold_counts[mention_to_gold[m]] += 1
        for _c2, count in gold_counts.items():
            correct += count * count
        num += correct / float(len(c))
        den += len(c)
    return num, den


def muc(clusters, mention_to_gold):
    tp, p = 0, 0
    for c in clusters:
        p += len(c) - 1
        tp += len(c)
        linked = set()
        for m in c:
            if m in mention_to_gold:
                linked.add(mention_to_gold[m])
            else:
                tp -= 1
        tp -= len(linked)
    return tp, p


def phi4(c1, c2):
    return 2 * len([m for m in c1 if m in c2]) / float(len(c1) + len(c2))


def ceafe(clusters, gold_clusters):
    clusters = [c for c in clusters]
    scores = np.zeros((len(gold_clusters), len(clusters)))
    for i in range(len(gold_clusters)):
        for j in range(len(clusters)):
            scores[i, j] = phi4(gold_clusters[i], clusters[j])
    row_ind, col_ind = linear_sum_assignment(-scores)
    similarity = scores[row_ind, col_ind].sum()
    return similarity, len(clusters), similarity, len(gold_clusters)


def lea(input_clusters, output_clusters, mention_to_gold):
    num, den = 0, 0
    for c in input_clusters:
        if len(c) == 1:
            all_links = 1
            common_links = 0
            if (
                c[0] in mention_to_gold
                and len(output_clusters[mention_to_gold[c[0]]]) == 1
            ):
                common_links = 1
        else:
            common_links = 0
            all_links = len(c) * (len(c) - 1) / 2.0
            for i, m in enumerate(c):
                if m in mention_to_gold:
                    for m2 in c[i + 1 :]:
                        if (
                            m2 in mention_to_gold
                            and mention_to_gold[m] == mention_to_gold[m2]
                        ):
                            common_links += 1
        num += len(c) * common_links / float(all_links)
        den += len(c)
    return num, den


def lea_soft(
    input_clusters,
    output_clusters,
    mention_to_gold,
    mention_weights: Optional[List[List[float]]] = None,
):
    """LEA with per-mention quality weights on the evaluated side.

    ``mention_weights[cix][mix]`` is the quality (sentence CIDEr, clipped
    to [0, 1]) of mention ``mix`` of cluster ``cix``. A correct link
    (m, m2) contributes ``(w_m + w_m2) / 2`` instead of 1; a correct
    singleton contributes its weight. When weights are absent this reduces
    exactly to LEA.

    Derivation note (the reference's coval fork is unpublished, so the
    semantics are INFERRED from its call site — audit trail below):

    * LEA (Moosavi & Strube, ACL 2016, eq. 1-4) scores each entity e by
      ``importance(e) * resolution(e)``, with ``importance(e) = |e|`` and
      ``resolution(e) = link(e ∩ assigned) / link(e)`` where
      ``link(e) = |e|(|e|-1)/2``; singletons count a self-link.
    * The fork's call site (reference ``evl_fns.py:630-648``) builds
      ``cider_for_sys`` shaped exactly like the SYSTEM clusters — one
      sentence-CIDEr per predicted mention — and passes it only to
      ``lea_soft``'s update, whose recall side coval computes from the
      KEY clusters (no weights can apply there). Hence the weights scale
      the PRECISION side (``Evaluator.update`` below mirrors this:
      weighted precision, plain-LEA recall).
    * The link weight ``(w_m + w_m2)/2`` is the unique linear form under
      which a PERFECTLY resolved system entity scores
      ``resolution = mean(w)``: each mention's text quality discounts
      exactly its own share of the entity's credit (sum over the
      ``k(k-1)/2`` pairs of ``(w_i+w_j)/2`` is ``(k-1)/2 * sum(w)``).
      ``importance`` and the ``link(e)`` denominator stay unweighted, so
      ``lea_soft <= lea`` pointwise, unit weights reduce it to LEA
      (property-tested), and zero-quality mentions earn zero link credit.
    """
    if mention_weights is None:
        return lea(input_clusters, output_clusters, mention_to_gold)
    num, den = 0, 0
    for cix, c in enumerate(input_clusters):
        ws = [min(max(float(w), 0.0), 1.0) for w in mention_weights[cix]]
        if len(c) == 1:
            all_links = 1.0
            common_links = 0.0
            if (
                c[0] in mention_to_gold
                and len(output_clusters[mention_to_gold[c[0]]]) == 1
            ):
                common_links = ws[0]
        else:
            common_links = 0.0
            all_links = len(c) * (len(c) - 1) / 2.0
            for i, m in enumerate(c):
                if m in mention_to_gold:
                    for j in range(i + 1, len(c)):
                        m2 = c[j]
                        if (
                            m2 in mention_to_gold
                            and mention_to_gold[m] == mention_to_gold[m2]
                        ):
                            common_links += 0.5 * (ws[i] + ws[j])
        num += len(c) * common_links / float(all_links)
        den += len(c)
    return num, den


# ---------------------------------------------------------------------------
# accumulating evaluator (coval's Evaluator)
# ---------------------------------------------------------------------------


class Evaluator:
    def __init__(self, metric, beta: float = 1.0):
        self.p_num = 0
        self.p_den = 0
        self.r_num = 0
        self.r_den = 0
        self.metric = metric
        self.beta = beta

    def update(self, coref_info, cider_for_sys: Optional[Sequence] = None):
        (
            key_clusters,
            sys_clusters,
            key_mention_sys_cluster,
            sys_mention_key_cluster,
        ) = coref_info

        if self.metric is ceafe:
            pn, pd, rn, rd = self.metric(sys_clusters, key_clusters)
        elif self.metric is lea:
            pn, pd = self.metric(sys_clusters, key_clusters, sys_mention_key_cluster)
            rn, rd = self.metric(key_clusters, sys_clusters, key_mention_sys_cluster)
        elif self.metric is lea_soft:
            pn, pd = lea_soft(
                sys_clusters,
                key_clusters,
                sys_mention_key_cluster,
                mention_weights=cider_for_sys,
            )
            rn, rd = lea(key_clusters, sys_clusters, key_mention_sys_cluster)
        else:
            pn, pd = self.metric(sys_clusters, sys_mention_key_cluster)
            rn, rd = self.metric(key_clusters, key_mention_sys_cluster)
        self.p_num += pn
        self.p_den += pd
        self.r_num += rn
        self.r_den += rd

    def get_f1(self) -> float:
        return f1(self.p_num, self.p_den, self.r_num, self.r_den, beta=self.beta)

    def get_recall(self) -> float:
        return 0 if self.r_num == 0 else self.r_num / float(self.r_den)

    def get_precision(self) -> float:
        return 0 if self.p_num == 0 else self.p_num / float(self.p_den)


ALL_COREF_METRICS = [
    ("mentions", mentions),
    ("muc", muc),
    ("bcub", b_cubed),
    ("ceafe", ceafe),
    ("lea", lea),
    ("lea_soft", lea_soft),
]
