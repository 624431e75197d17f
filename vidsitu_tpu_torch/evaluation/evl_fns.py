"""Offline / leaderboard evaluation functions for the three VidSitu tasks.

Direct port of the reference's ``vidsitu_code/evl_fns.py`` scoring
logic onto our dependency-free metric stack. The scoring math and the
prediction/GT file formats must match exactly (docs/README.md: the same
pickles score through either implementation; golden-fixture tested), so
the algorithms, loop structure, and output keys deliberately mirror the
reference line for line — only local naming, condensation, and
crash-path guards differ. Attribution: TheShadow29/VidSitu (MIT).

  * verb prediction:  ``EvlFn_Vb.simple_acc`` — Top-1/5 per event and per
    video vs the 10-annotator verb sets, plus verb-macro recall at
    thresholds 0..9 (evl_fns.py:249-372).
  * SRL generation:   ``EvalFnCap.eval_cap_mets`` — CIDEr/BLEU/ROUGE over
    role strings vs <=3 refs with the fixed seed-5 GT permutation and
    ``ix_gt=3`` exclusion, macro-by-verb and macro-by-arg, and the six
    coval coreference F1s incl. CIDEr-weighted ``lea_soft``
    (evl_fns.py:375-701).
  * event relations:  ``EvlFn_EvRel.simple_acc_evrel`` — Top-1 with the
    >=2-of-3-annotator agreement mask and macro over relation classes
    (evl_fns.py:132-246).
"""

from __future__ import annotations

import re
from collections import Counter, namedtuple
from typing import Dict, List

import numpy as np

from ..utils.io import read_file_with_assertion, write_json
from .metrics.bleu import Bleu
from .metrics.cider import Cider
from .metrics.coref import Evaluator, get_mention_assignments
from .metrics.coref import ALL_COREF_METRICS
from .metrics.meteor import Meteor
from .metrics.rouge import Rouge

_ARGM_RE = re.compile(r"ArgM (.*)")


def arg_mapper(arg_inp: str, argm_re=None) -> str:
    """Map raw annotation arg names to canonical slots
    (reference: evl_fns.py:43-65, utils/dat_utils.py:127-149)."""
    if argm_re is None:
        argm_re = _ARGM_RE
    arg_name = arg_inp.split(" ")[0]
    if arg_name in {"Arg0", "Arg1", "Arg2", "Arg3", "Arg4", "Arg5"}:
        return arg_name
    if arg_inp == "Scene of the Event":
        return "AScn"
    assert arg_name == "ArgM", f"unrecognized arg {arg_inp}"
    y2 = argm_re.findall(arg_inp)[0].strip()
    if "direction" in y2:
        return "ADir"
    if "purpose" in y2:
        return "APrp"
    if "manner" in y2:
        return "AMnr"
    if "location" in y2:
        return "ALoc"
    if "goal" in y2:
        return "AGol"
    raise NotImplementedError(arg_inp)


def collate_dct_lst_naive(batch: List[Dict]) -> Dict:
    all_keys = list(batch[0].keys())
    return {k: [b[k] for b in batch] for k in all_keys}


def get_avg(lst) -> float:
    if len(lst) == 0:
        return 0
    return sum(lst) / len(lst)


def read_gt_file(full_cfg, task_type: str, split_type: str) -> Dict:
    """Load split list + grouped annotations (+ vinfo for vb)
    (reference: evl_fns.py:86-129)."""
    ds_cfg = full_cfg.ds.vsitu
    vseg_lst = read_file_with_assertion(ds_cfg.split_files_lb[split_type])
    vseg_ann_lst = read_file_with_assertion(ds_cfg.vsitu_ann_files_lb[split_type])

    vsitu_ann_dct: Dict = {}
    for vseg_ann in vseg_ann_lst:
        vseg = vseg_ann["Ev1"]["vid_seg_int"]
        vsitu_ann_dct.setdefault(vseg, []).append(vseg_ann)

    out_dct = {"vseg_lst": vseg_lst, "vsitu_ann_dct": vsitu_ann_dct}
    if task_type == "vb":
        assert "valid" in split_type or "test" in split_type
        vseg_info_lst = read_file_with_assertion(ds_cfg.vinfo_files_lb[split_type])
        vsitu_vinfo_dct = {}
        for vseg_info in vseg_info_lst:
            vseg = vseg_info["vid_seg_int"]
            assert vseg not in vsitu_vinfo_dct
            assert len(vseg_info["vbid_lst"]["Ev1"]) >= 9
            vseg_info["vb_id_lst_eval"] = [
                vseg_info["vbid_lst"][f"Ev{eix}"] for eix in range(1, 6)
            ]
            vsitu_vinfo_dct[vseg] = vseg_info
        out_dct["vsitu_vinfo_dct"] = vsitu_vinfo_dct
    elif task_type in ("vb_arg", "evrel"):
        pass
    else:
        raise NotImplementedError(task_type)
    return out_dct


# ---------------------------------------------------------------------------
# EvRel
# ---------------------------------------------------------------------------


class EvlFn_EvRel:
    def __init__(self, cfg, comm, met_keys: List[str]):
        self.cfg = cfg
        self.comm = comm
        self.met_keys = met_keys

    def read_gt_file(self, split_type: str):
        files_out = read_gt_file(self.cfg, "evrel", split_type=split_type)
        self.vseg_lst = files_out["vseg_lst"]
        vsitu_ann_dct = files_out["vsitu_ann_dct"]
        self.gts_dct = {
            ix: vsitu_ann_dct[self.vseg_lst[ix]] for ix in range(len(self.vseg_lst))
        }

    def prepare_hyp_gts(self, pred_file: str, split_type: str = "valid") -> Dict:
        pred_data = read_file_with_assertion(pred_file, reader="pickle")
        self.read_gt_file(split_type=split_type)

        hypo_dct: Dict = {}
        for pred in pred_data:
            ann_idx = pred["ann_idx"]
            if ann_idx not in hypo_dct:
                hypo_dct[ann_idx] = pred

        hypos: Dict = {}
        gts: Dict = {}
        mask: Dict = {}
        ev_lst = [f"Ev{ix}" for ix in [1, 2, 4, 5]]

        if not self.cfg.debug_mode:
            assert len(hypo_dct) == len(self.vseg_lst), (
                "Missing Elements in Prediction"
            )

        for ann_idx in hypo_dct:
            pred_one = hypo_dct[ann_idx]
            preds = pred_one["pred_evrels_ev"]
            gt_vbs_lst = self.gts_dct[pred_one["ann_idx"]]
            gt_vbs = [
                [gt_i[f"Ev{ev_i}"]["EvRel"] for gt_i in gt_vbs_lst]
                for ev_i in [1, 2, 4, 5]
            ]
            hypos[ann_idx] = {ev_i: preds[ev_ix] for ev_ix, ev_i in enumerate(ev_lst)}
            gts[ann_idx] = {
                ev_i: gt_vbs[ev_ix][:3] for ev_ix, ev_i in enumerate(ev_lst)
            }
            mask[ann_idx] = {
                ev_i: 1
                if Counter(gt_vbs[ev_ix][:3]).most_common()[0][1] >= 2
                else 0
                for ev_ix, ev_i in enumerate(ev_lst)
            }
        return {"hypos": hypos, "gts": gts, "mask": mask}

    def simple_acc_evrel(self, pred_file: str, split_type: str = "valid") -> Dict:
        hgm = self.prepare_hyp_gts(pred_file=pred_file, split_type=split_type)
        hypos, gts, mask = hgm["hypos"], hgm["gts"], hgm["mask"]
        hypos_ids = sorted(hypos.keys())
        corr_lst = []
        gt_corr_lst = []
        msk_lst = []
        for hid in hypos_ids:
            hyp, ev_gts, msk1 = hypos[hid], gts[hid], mask[hid]
            for ev_ix in [1, 2, 4, 5]:
                hyp_evi = hyp[f"Ev{ev_ix}"]
                gt_evi = ev_gts[f"Ev{ev_ix}"]
                msk_evi = msk1[f"Ev{ev_ix}"]
                assert len(hyp_evi) == len(gt_evi)
                gt_max = Counter(gt_evi).most_common()[0][0]
                gt_evi_ix = [i for i in range(len(gt_evi)) if gt_evi[i] == gt_max]
                for i in gt_evi_ix:
                    corr_lst.append(hyp_evi[i] == gt_evi[i])
                    gt_corr_lst.append(gt_evi[i])
                    msk_lst.append(msk_evi)
        assert len(msk_lst) == len(corr_lst)
        out_corr_lst = [c for c, m in zip(corr_lst, msk_lst) if m]
        mac_dct: Dict = {}
        for gix, g in enumerate(gt_corr_lst):
            mac_dct.setdefault(g, [])
            if msk_lst[gix]:
                mac_dct[g].append(corr_lst[gix])
        mac_dct2 = {k: sum(v) / len(v) for k, v in mac_dct.items() if len(v) > 0}
        # crash-path guard (not in the reference, which divides by zero):
        # a small/debug prediction set can have NO event with >=2-of-3
        # annotator agreement — report 0 instead of raising
        n_out = len(out_corr_lst)
        return {
            "Top_1": sum(out_corr_lst) / n_out if n_out else 0.0,
            "Len": n_out,
            "Macro_Top_1": (
                sum(mac_dct2.values()) / len(mac_dct2) if mac_dct2 else 0.0
            ),
            "Macro_Top_Dct": mac_dct2,
        }


# ---------------------------------------------------------------------------
# Verb prediction
# ---------------------------------------------------------------------------


class EvlFn_Vb:
    def __init__(self, cfg, comm, met_keys: List[str]):
        self.cfg = cfg
        self.comm = comm
        self.met_keys = met_keys
        self.evix_lst = list(range(1, 6))
        self.evlst = [f"Ev{eix}" for eix in self.evix_lst]

    def read_gt_file(self, split_type: str):
        files_out = read_gt_file(self.cfg, task_type="vb", split_type=split_type)
        self.vseg_lst = files_out["vseg_lst"]
        self.vsitu_ann_dct = files_out["vsitu_ann_dct"]
        self.vsitu_vinfo_dct = files_out["vsitu_vinfo_dct"]

    def vb_classf_metrics_all(self, hyps: Dict, gts: Dict) -> Dict:
        assert set(hyps.keys()) == set(gts.keys())
        vid_key_lst = sorted(hyps.keys())
        ev_lst = [f"Ev{ix}" for ix in self.evix_lst]
        hits_per_event = {f"Top_{k}": [] for k in range(1, 6)}
        hits_per_video = {f"Top_{k}": [] for k in range(1, 6)}
        hits_per_verb: Dict = {}

        for vid_key in vid_key_lst:
            vid_hyps = hyps[vid_key]
            vid_gts = gts[vid_key]
            assert len(vid_hyps) == len(ev_lst)
            assert len(vid_gts) == len(ev_lst)
            video_event_hits = {f"Top_{k}": [] for k in range(1, 6)}
            for ev_i in ev_lst:
                ev_hyps = vid_hyps[ev_i]
                ev_gts = vid_gts[ev_i]
                for topk in range(1, 6):
                    hit = int(len(set(ev_hyps[:topk]).intersection(ev_gts)) > 0)
                    hits_per_event[f"Top_{topk}"].append(hit)
                    video_event_hits[f"Top_{topk}"].append(hit)
                majority_verbs = [y for y in Counter(ev_gts).most_common() if y[1] >= 2]
                for verb, _n_annotators in majority_verbs:
                    hits_per_verb.setdefault(verb, [])
                    hits_per_verb[verb].append(int(verb in set(ev_hyps)))
            for topk in range(1, 6):
                hits_per_video[f"Top_{topk}"].append(
                    int(all(y == 1 for y in video_event_hits[f"Top_{topk}"]))
                )

        out_dct: Dict = {}
        for k in hits_per_event:
            out_dct[f"Per_Ev_{k}"] = get_avg(hits_per_event[k])
        for k in hits_per_video:
            out_dct[f"Per_Vid_{k}"] = get_avg(hits_per_video[k])
        out_dct["acc"] = out_dct["Per_Ev_Top_5"]
        verb_recall_table = sorted(
            [(k, get_avg(v), len(v)) for k, v in hits_per_verb.items()],
            key=lambda x: x[1],
            reverse=True,
        )
        for thresh in range(0, 10):
            recalls_above = [y[1] for y in verb_recall_table if y[2] > thresh]
            out_dct[f"recall_macro_1_th_{thresh}"] = get_avg(recalls_above)
            out_dct[f"num_vbs_thresh_{thresh}"] = len(recalls_above)
        return out_dct

    def prepare_hyp_gts(self, pred_file: str, split_type: str = "valid"):
        pred_data = read_file_with_assertion(pred_file, reader="pickle")
        self.read_gt_file(split_type=split_type)

        hypo_dct: Dict = {}
        for pred in pred_data:
            ann_idx = pred["ann_idx"]
            if ann_idx not in hypo_dct:
                hypo_dct[ann_idx] = pred

        hypos: Dict = {}
        gts: Dict = {}
        ev_lst = [f"Ev{ix}" for ix in self.evix_lst]
        if not self.cfg.debug_mode:
            assert len(hypo_dct) == len(self.vseg_lst), (
                "Missing Elements in Prediction"
            )
        for ann_idx in hypo_dct:
            pred_one = hypo_dct[ann_idx]
            preds = pred_one["pred_vbs_ev"]
            vseg_name = self.vseg_lst[pred_one["ann_idx"]]
            gt_vbs = self.vsitu_vinfo_dct[vseg_name]["vb_id_lst_eval"]
            hypos[ann_idx] = {
                ev_i: preds[ev_ix][:5] for ev_ix, ev_i in enumerate(ev_lst)
            }
            gts[ann_idx] = {
                ev_i: gt_vbs[ev_ix][:10] for ev_ix, ev_i in enumerate(ev_lst)
            }
        return hypos, gts

    def simple_acc(self, pred_file: str, split_type: str = "valid") -> Dict:
        hypos, gts = self.prepare_hyp_gts(pred_file=pred_file, split_type=split_type)
        return self.vb_classf_metrics_all(hyps=hypos, gts=gts)


# ---------------------------------------------------------------------------
# SRL generation (captions + coref)
# ---------------------------------------------------------------------------

ScorerE = namedtuple("ScorerE", ["fn", "out_str"])


class EvalFnCap:
    def __init__(self, cfg, comm, met_keys: List[str], read_val_file: bool = True):
        self.cfg = cfg
        self.comm = comm
        self.met_keys = met_keys
        self.args_used = ["Arg0", "Arg1", "Arg2", "ALoc", "AScn"]
        self.ngt = 3
        scorer_dict = {
            "bleu": lambda: ScorerE(
                Bleu(4), ["bleu_1", "bleu_2", "bleu_3", "bleu_4"]
            ),
            "cider": lambda: ScorerE(Cider("corpus"), ["cider"]),
            "rouge": lambda: ScorerE(Rouge(), ["rouge"]),
            # available like the reference's scorer registry
            # (evl_fns.py:410-432); not in any default met_keys.
            # Factories, not instances: Meteor probes env vars and may
            # parse a WordNet synonym table at construction — only the
            # scorers actually named in met_keys get built
            "meteor": lambda: ScorerE(Meteor(), ["meteor"]),
        }
        self.scorers = {k: scorer_dict[k]() for k in met_keys}
        self.coval_all_metrics = ALL_COREF_METRICS
        self.reset_coval_scorer_dict()

    def reset_coval_scorer_dict(self):
        self.coval_scorer_dict = {
            name: Evaluator(fn) for name, fn in self.coval_all_metrics
        }

    def read_gt_file(self, split_type: str):
        files_out = read_gt_file(self.cfg, "vb_arg", split_type=split_type)
        self.vseg_lst = files_out["vseg_lst"]
        vsitu_ann_dct = files_out["vsitu_ann_dct"]
        self.gts_dct = {
            ix: vsitu_ann_dct[self.vseg_lst[ix]] for ix in range(len(self.vseg_lst))
        }
        # Fixed permutation of GT annotator order (reference: evl_fns.py:402-407
        # — global seed 5, consumed in insertion order; replicated exactly so
        # scores are comparable across implementations).
        np.random.seed(5)
        self.gts_dct = {
            ix: [v[rix] for rix in np.random.permutation(len(v))]
            for ix, v in self.gts_dct.items()
        }

    def prepare_hyp_gts(
        self, pred_file: str, split_type: str = "valid", ix_gt: int = 3
    ) -> Dict:
        ngt = self.ngt
        pred_outs = read_file_with_assertion(pred_file, reader="pickle")
        hypo_dct: Dict = {}
        for pred in pred_outs:
            ann_idx = pred["ann_idx"]
            if ann_idx not in hypo_dct:
                hypo_dct[ann_idx] = pred["vb_output"]

        if not self.cfg.debug_mode:
            assert sorted(hypo_dct.keys()) == sorted(self.gts_dct.keys()), (
                "Missing Elements from Prediction"
            )

        ann_idx_keys = sorted(hypo_dct.keys())
        gt_refs_dct = {
            an_ix: [y for yix, y in enumerate(self.gts_dct[an_ix]) if yix != ix_gt][
                :ngt
            ]
            for an_ix in ann_idx_keys
        }
        aix = 0
        hypo_str_dct: Dict = {}
        gts_str_dct: Dict = {}
        ix_to_verb: Dict = {}
        ix_to_arg: Dict = {}
        ix_to_meta: Dict = {}
        ev_lst = [f"Ev{eix}" for eix in range(1, 6)]
        for ann_idx in ann_idx_keys:
            pred_events = hypo_dct[ann_idx]
            # same exclusion rule as gt_refs_dct above — reuse it so the
            # caption refs and coref refs can never desynchronize
            gt_annotations = gt_refs_dct[ann_idx]
            for ev_i in ev_lst:
                gt_args = gt_annotations[0][ev_i]["Args"]
                vb_id = gt_annotations[0][ev_i]["VerbID"]
                for gt_ag in gt_args:
                    gt_ag_name = arg_mapper(gt_ag)
                    if gt_ag_name not in self.args_used:
                        continue
                    gts_str_dct[aix] = [
                        gtva[ev_i]["Args"][gt_ag] for gtva in gt_annotations
                    ]
                    if ev_i in pred_events and gt_ag_name in pred_events[ev_i]:
                        hypo_str_dct[aix] = [pred_events[ev_i][gt_ag_name]]
                    else:
                        hypo_str_dct[aix] = [""]
                    ix_to_verb[aix] = vb_id
                    ix_to_arg[aix] = gt_ag_name
                    ix_to_meta[aix] = {
                        "aix": aix,
                        "ann_idx": ann_idx,
                        "ev_ix": ev_i,
                        "agname": gt_ag_name,
                        "ev_agname": f"{ev_i}_{gt_ag_name}",
                        "agname_real": gt_ag,
                    }
                    aix += 1

        return {
            "hypos": hypo_str_dct,
            "gts": gts_str_dct,
            "hypos_orig": hypo_dct,
            "gts_orig": gt_refs_dct,
            "ix_to_vb_map": ix_to_verb,
            "ix_to_arg_map": ix_to_arg,
            "ix_to_all_map": ix_to_meta,
        }

    def vb_arg_metrics_all(self, hypos: Dict, gts: Dict, return_sent=False) -> Dict:
        out_met_dct: Dict = {}
        for met in self.met_keys:
            corp, sent = self.scorers[met].fn.compute_score(gts=gts, res=hypos)
            if isinstance(corp, float):
                corp = [corp]
                sent = [sent]
            for mix, met_out_str in enumerate(self.scorers[met].out_str):
                out_met_dct[met_out_str] = corp[mix]
                if return_sent:
                    out_met_dct[f"{met_out_str}_sent"] = sent[mix]
        return out_met_dct

    def vb_arg_compute_macro(self, hypo_str_dct, gts_str_dct, ix_to_vb_map):
        vb_to_ix_dct: Dict = {}
        for ix, vb in ix_to_vb_map.items():
            vb_to_ix_dct.setdefault(vb, []).append(ix)
        out_met_dct_vb_lst: Dict = {}
        for vb, ix_lst in vb_to_ix_dct.items():
            hypos_vb = {k: hypo_str_dct[k] for k in ix_lst}
            gts_vb = {k: gts_str_dct[k] for k in ix_lst}
            out_met_dct_vb_lst[vb] = self.vb_arg_metrics_all(
                hypos=hypos_vb, gts=gts_vb
            )
        collated = collate_dct_lst_naive(list(out_met_dct_vb_lst.values()))
        out_met_macro = {k: get_avg(v) for k, v in collated.items()}
        return out_met_macro, out_met_dct_vb_lst

    def get_coref_from_orig_hyp_gts_dcts(
        self, hyp_orig_dct, gts_orig_dct, met_inp=None, conv_dct=None
    ) -> Dict:
        """Cross-event coreference of role strings (evl_fns.py:561-653)."""
        self.reset_coval_scorer_dict()
        ev_lst = [f"Ev{ix}" for ix in range(1, 6)]

        def get_coref_dct_for_gt1(ev_gts):
            coref_dct: Dict = {}
            for ev_i in ev_lst:
                gt_args = ev_gts[ev_i]["Args"]
                for gt_ag in gt_args:
                    gt_ag_name = arg_mapper(gt_ag)
                    if gt_ag_name in self.args_used:
                        gtv1 = gt_args[gt_ag]
                        coref_dct.setdefault(gtv1, []).append(
                            f"{ev_i}_{gt_ag_name}"
                        )
            return coref_dct

        def get_coref_dct_for_pred(pred, ev_gts):
            coref_dct: Dict = {}
            for ev_i in ev_lst:
                gt_args = list(ev_gts[ev_i]["Args"].keys())
                for gt_ag in gt_args:
                    gt_ag_name = arg_mapper(gt_ag)
                    if gt_ag_name in self.args_used and gt_ag_name in pred.get(
                        ev_i, {}
                    ):
                        pred_v1 = pred[ev_i][gt_ag_name]
                        coref_dct.setdefault(pred_v1, []).append(
                            f"{ev_i}_{gt_ag_name}"
                        )
            return coref_dct

        def preproc_dct(dct1):
            return list(dct1.values())

        ann_idx_keys = sorted(hyp_orig_dct.keys())
        coval_mets = [name for name, _ in self.coval_all_metrics]
        out_f1_scores: Dict = {cmet: [] for cmet in coval_mets}

        is_lea_soft = conv_dct is not None
        if is_lea_soft:
            conv_dct2: Dict = {}
            for _ck, c in conv_dct.items():
                conv_dct2.setdefault(c["ann_idx"], []).append(c)
            # ann_idx -> {ev_agname: meta}, hoisted out of the gtix loop
            # (it depends only on ann_idx) and .get-guarded: a video
            # whose annotator-0 events hold only unused roles has NO
            # ix_to_meta entries at all — per-slot misses are weighted 0
            # below, and a whole-video miss must not KeyError here
            conv11_by_ann = {
                an: {v["ev_agname"]: v for v in conv_dct2.get(an, [])}
                for an in ann_idx_keys
            }

        gt_max = len(gts_orig_dct[list(gts_orig_dct.keys())[0]])
        for gtix in range(gt_max):
            self.reset_coval_scorer_dict()
            for ann_idx in ann_idx_keys:
                vid_gts = gts_orig_dct[ann_idx][gtix]
                hypo_1 = hyp_orig_dct[ann_idx]
                cid_sc_lst = None
                if is_lea_soft:
                    conv11 = conv11_by_ann[ann_idx]
                if "Ev1" not in hypo_1:
                    continue
                if "Args" in hypo_1["Ev1"]:
                    sys_dct = preproc_dct(get_coref_dct_for_gt1(hypo_1))
                else:
                    sys_dct = preproc_dct(get_coref_dct_for_pred(hypo_1, vid_gts))
                if is_lea_soft:
                    # conv11 maps only slots annotator 0 annotated
                    # (prepare_hyp_gts builds ix_to_meta from
                    # gt_annotations[0]); a prediction slot that only
                    # OTHER annotators use has no generated-sentence
                    # CIDEr — weight it 0 rather than KeyError (the
                    # reference indexes the same annotator-0 map and
                    # would crash on such data)
                    cid_sc_lst = []
                    for cls1 in sys_dct:
                        cid_sc_lst.append(
                            [
                                met_inp["cider_sent"][conv11[cls11]["aix"]]
                                if cls11 in conv11 else 0.0
                                for cls11 in cls1
                            ]
                        )
                key_dct = preproc_dct(get_coref_dct_for_gt1(vid_gts))
                key_to_sys = get_mention_assignments(key_dct, sys_dct)
                sys_to_key = get_mention_assignments(sys_dct, key_dct)
                tup = (key_dct, sys_dct, key_to_sys, sys_to_key)
                for cmet in coval_mets:
                    if cmet != "lea_soft":
                        self.coval_scorer_dict[cmet].update(tup)
                    else:
                        self.coval_scorer_dict[cmet].update(
                            tup, cider_for_sys=cid_sc_lst
                        )
            for cmt in coval_mets:
                out_f1_scores[cmt].append(self.coval_scorer_dict[cmt].get_f1())
        return {cmt: sum(v) / len(v) for cmt, v in out_f1_scores.items()}

    def get_evals_from_hyp_gts_dcts(self, hyp_gts_dicts: Dict) -> Dict:
        hypo_str_dct = hyp_gts_dicts["hypos"]
        gts_str_dct = hyp_gts_dicts["gts"]
        out_met_dct = self.vb_arg_metrics_all(
            hypos=hypo_str_dct, gts=gts_str_dct, return_sent=True
        )
        out_met_macro_vb, _ = self.vb_arg_compute_macro(
            hypo_str_dct, gts_str_dct, hyp_gts_dicts["ix_to_vb_map"]
        )
        out_met_macro_arg, out_met_dct_arg_lst = self.vb_arg_compute_macro(
            hypo_str_dct, gts_str_dct, hyp_gts_dicts["ix_to_arg_map"]
        )
        for k in out_met_macro_vb:
            out_met_dct[f"MacroVb_{k}"] = out_met_macro_vb[k]
        for k in out_met_macro_arg:
            out_met_dct[f"MacroArg_{k}"] = out_met_macro_arg[k]
        for k in out_met_dct_arg_lst:
            for k1 in out_met_dct_arg_lst[k]:
                out_met_dct[f"{k}_{k1}"] = out_met_dct_arg_lst[k][k1]

        coval_mets = self.get_coref_from_orig_hyp_gts_dcts(
            hyp_orig_dct=hyp_gts_dicts["hypos_orig"],
            gts_orig_dct=hyp_gts_dicts["gts_orig"],
            met_inp=out_met_dct,
            conv_dct=hyp_gts_dicts["ix_to_all_map"],
        )
        out_met_dct.update(coval_mets)
        return out_met_dct

    def eval_cap_mets(self, pred_file: str, split_type: str = "valid") -> Dict:
        self.read_gt_file(split_type=split_type)
        hyp_gts_dicts = self.prepare_hyp_gts(
            pred_file=pred_file, split_type=split_type
        )
        return self.get_evals_from_hyp_gts_dcts(hyp_gts_dicts=hyp_gts_dicts)


# ---------------------------------------------------------------------------
# standalone CLI entry (reference: evl_fns.py:704-761)
# ---------------------------------------------------------------------------


def get_fname_key(task_type: str) -> str:
    return {"vb": "test_verb", "vb_arg": "test_srl", "evrel": "test_evrel"}[
        task_type
    ]


def evaluate_predictions(
    pred_file: str,
    task_type: str,
    split_file_path: str,
    vinfo_file_path: str,
    vsitu_ann_file_path: str,
    split_type: str,
    out_file: str = "./results/results.json",
    **kwargs,
) -> Dict:
    from ..utils.config import CfgProcessor

    cfg = CfgProcessor().get_default_cfg()
    assert "valid" in split_type or "test" in split_type
    # normalize to the canonical cfg key and use the SAME key for both
    # the path overrides and the scorer lookups: writing under
    # get_fname_key() while the scorer reads split_files_lb[split_type]
    # verbatim would load wrong/missing files for any split_type other
    # than the exact canonical name (e.g. 'test', 'valid_lb')
    fname_key = "valid" if "valid" in split_type else get_fname_key(task_type)
    split_type = fname_key

    cfg.ds.vsitu.split_files_lb[fname_key] = split_file_path
    cfg.ds.vsitu.vinfo_files_lb[fname_key] = vinfo_file_path
    cfg.ds.vsitu.vsitu_ann_files_lb[fname_key] = vsitu_ann_file_path
    cfg.freeze()

    if task_type == "vb_arg":
        evl = EvalFnCap(cfg, None, met_keys=["cider", "bleu", "rouge"])
        out_met = evl.eval_cap_mets(pred_file=pred_file, split_type=split_type)
        out_results = {k: float(v) for k, v in out_met.items() if "sent" not in k}
    elif task_type == "vb":
        evl = EvlFn_Vb(cfg, {}, ["acc"])
        out_met = evl.simple_acc(pred_file=pred_file, split_type=split_type)
        out_results = {k: float(v) for k, v in out_met.items()}
    elif task_type == "evrel":
        evl = EvlFn_EvRel(cfg, {}, ["Top_1"])
        out_results = evl.simple_acc_evrel(
            pred_file=pred_file, split_type=split_type
        )
    else:
        raise NotImplementedError(task_type)

    write_json(out_results, out_file)
    return out_results


def main(argv=None):
    """CLI: python -m vidsitu_tpu.evaluation.evl_fns --pred_file=... ...
    (reference: python vidsitu_code/evl_fns.py, :709-761)."""
    import argparse

    ap = argparse.ArgumentParser(description="offline leaderboard scoring")
    ap.add_argument("--pred_file", required=True)
    ap.add_argument("--task_type", required=True,
                    choices=["vb", "vb_arg", "evrel"])
    ap.add_argument("--split_file_path", required=True)
    ap.add_argument("--vinfo_file_path", required=True)
    ap.add_argument("--vsitu_ann_file_path", required=True)
    ap.add_argument("--split_type", required=True)
    ap.add_argument("--out_file", default="./results/results.json")
    args = ap.parse_args(argv)
    out = evaluate_predictions(
        pred_file=args.pred_file,
        task_type=args.task_type,
        split_file_path=args.split_file_path,
        vinfo_file_path=args.vinfo_file_path,
        vsitu_ann_file_path=args.vsitu_ann_file_path,
        split_type=args.split_type,
        out_file=args.out_file,
    )
    import json as _json

    print(_json.dumps({k: v for k, v in out.items()
                       if not isinstance(v, dict)}, indent=1))


if __name__ == "__main__":
    main()
