"""VidSitu dataset: annotation reading and per-item tensor assembly.

Numpy re-implementation of the reference ``VsituDS``
(vidsitu_code/dat_loader.py:40-573): same JSON inputs, same token/label
geometry (SURVEY.md §2.5), emitting numpy arrays for the JAX input
pipeline. Frames are channels-last (see frames.py).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List

import numpy as np

from ..utils.config import CfgNode
from ..utils.io import read_file_with_assertion
from .comm import build_comm, enclose_ag_st
from .frames import load_event_clips
from .pad import pad_tokens, pad_words_new
from ..evaluation.evl_fns import arg_mapper

TOKEN_ONLY_MDLS = {
    "txed_only",
    "tx_only",
    "gpt2_only",
    "new_gpt2_only",
    "tx_ev_only",
    "new_gpt2_ev_only",
    "rob_evrel",
}


class VsituDS:
    def __init__(
        self, cfg: CfgNode, comm, split_type: str, task_type: str = ""
    ):
        """``task_type`` overrides ``cfg.task_type`` — used by the feature
        extractor to build a frames-only ("vb") view over any split
        regardless of the configured task (ref VsituDS_All,
        feat_extractor.py:20-74)."""
        self.full_cfg = cfg
        self.cfg = cfg.ds.vsitu
        self.vid_cfg = cfg.vid_mdl
        self.task_type = task_type or cfg.task_type
        self.split_type = split_type

        self.comm = comm if comm else build_comm(cfg)
        self.read_files(split_type)
        # per-item hot-path caches: the tokenizer is immutable after comm
        # construction, so the added-vocab dict copy and the space
        # separator encoding need not be recomputed for every __getitem__
        self._addn_word_voc = self.comm.gpt2_hf_tok.get_added_vocab()
        self._space_sep = self.comm.gpt2_hf_tok(" ")["input_ids"]

        if self.task_type == "vb":
            self.itemgetter = self.vb_only_item_getter
        elif self.task_type == "vb_arg":
            self.itemgetter = self.vb_args_item_getter
            self.is_evrel = False
        elif self.task_type == "evrel":
            self.itemgetter = self.vb_args_item_getter
            self.is_evrel = True
        else:
            raise NotImplementedError(self.task_type)

    # -- file reading (dat_loader.py:140-173) --------------------------------
    def read_files(self, split_type: str):
        self.vsitu_frm_dir = self.cfg.video_frms_tdir
        self.vseg_lst = read_file_with_assertion(
            self.cfg.split_files_lb[split_type]
        )
        vseg_ann_lst = read_file_with_assertion(
            self.cfg.vsitu_ann_files_lb[split_type]
        )
        vsitu_ann_dct: Dict[str, List] = {}
        for vseg_ann in vseg_ann_lst:
            vseg = vseg_ann["Ev1"]["vid_seg_int"]
            vsitu_ann_dct.setdefault(vseg, []).append(vseg_ann)
        self.vsitu_ann_dct = vsitu_ann_dct

        if "valid" in split_type or "test" in split_type:
            vseg_info_lst = read_file_with_assertion(
                self.cfg.vinfo_files_lb[split_type]
            )
            vsitu_vinfo_dct = {}
            for vseg_info in vseg_info_lst:
                vseg = vseg_info["vid_seg_int"]
                assert vseg not in vsitu_vinfo_dct
                assert len(vseg_info["vbid_lst"]["Ev1"]) >= 9
                vid_seg_ann_lst = [
                    {
                        f"Ev{eix}": {
                            "VerbID": vseg_info["vbid_lst"][f"Ev{eix}"][ix]
                        }
                        for eix in range(1, 6)
                    }
                    for ix in range(len(vseg_info["vbid_lst"]["Ev1"]))
                ]
                vseg_info["vb_id_lst_new"] = vid_seg_ann_lst
                vsitu_vinfo_dct[vseg] = vseg_info
            self.vsitu_vinfo_dct = vsitu_vinfo_dct

    def __len__(self) -> int:
        if self.full_cfg.debug_mode:
            return min(30, len(self.vseg_lst))
        return len(self.vseg_lst)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.itemgetter(idx)

    # -- verb labels (dat_loader.py:193-218) -----------------------------------
    def get_vb_data(self, vid_seg_ann_lst: List) -> Dict[str, np.ndarray]:
        voc = self.comm.vb_id_vocab
        label_lst_all_ev = []
        label_lst_mc = []
        for ev in range(1, 6):
            label_lst_one_ev = []
            for vseg_aix, vid_seg_ann in enumerate(vid_seg_ann_lst):
                if vseg_aix == 10:
                    break
                vb_id = vid_seg_ann[f"Ev{ev}"]["VerbID"]
                label_lst_one_ev.append(voc.indices.get(vb_id, voc.unk_index))
            label_lst_all_ev.append(label_lst_one_ev)
            label_lst_mc.append(Counter(label_lst_one_ev).most_common(1)[0][0])

        label10 = np.full((5, 10), voc.pad_index, dtype=np.int64)
        n_ann = min(len(vid_seg_ann_lst), 10)
        label10[:, :n_ann] = np.asarray(label_lst_all_ev, dtype=np.int64)
        return {
            "label_tensor10": label10,
            "label_tensor": np.asarray(label_lst_mc, dtype=np.int64),
        }

    # -- SRL / evrel token assembly (dat_loader.py:220-452) ---------------------
    def get_vb_arg_data(
        self, vid_seg_ann_lst: List, is_evrel: bool = False
    ) -> Dict[str, np.ndarray]:
        agset = ["Arg0", "Arg1", "Arg2"]
        word_voc = self.comm.gpt2_hf_tok
        addn_word_voc = self._addn_word_voc

        only_vb_lst_all_ev = []
        seq_lst_all_ev = []
        seq_lst_all_ev_lens = []
        evrel_lst_all_ev = []
        evrel_seq_lst_all_ev = []
        vb_id_lst: List[int] = []
        seq_id_lst: List[str] = []

        for ev in range(1, 6):
            only_vb_lst = []
            seq_lst = []
            seq_lst_lens = []
            evrel_lst = []
            evrel_seq_lst = []
            for vsix, vid_seg_ann in enumerate(vid_seg_ann_lst):
                ann1 = vid_seg_ann[f"Ev{ev}"]
                vb_id = ann1["VerbID"]
                arg_lst = list(ann1["Arg_List"].keys())
                arg_lst_sorted = sorted(
                    arg_lst, key=lambda x: int(ann1["Arg_List"][x])
                )
                arg_str_dct = ann1["Args"]

                seq = ""
                if vb_id in addn_word_voc:
                    prefix_lst = [addn_word_voc[vb_id]]
                else:
                    prefix_lst = word_voc.encode(vb_id)
                for ag in arg_lst_sorted:
                    arg_str = arg_str_dct[ag]
                    ag_n = arg_mapper(ag)
                    # evrel+trimmed keeps only the core args (agset);
                    # every other mode keeps all of them
                    if (not (is_evrel and self.cfg.evrel_trimmed)
                            or ag_n in agset):
                        seq += " " + enclose_ag_st(ag_n, arg_str)

                evr = ann1.get("EvRel", "Null")
                evrel_lst.append(self.comm.evrel_dct[evr])
                evrel_seq_lst.append((vb_id, seq))

                if vsix == 0:
                    vb_id_lst.append(prefix_lst[0])
                    seq_id_lst.append(seq)

                seq_padded, seq_len = pad_words_new(
                    seq,
                    max_len=60,
                    wvoc=word_voc,
                    append_eos=True,
                    pad_side="right",
                    prefix_lst=prefix_lst,
                )
                only_vb_padded, _ = pad_words_new(
                    vb_id, max_len=5, wvoc=word_voc, append_eos=False,
                    pad_side="right",
                )
                seq_lst.append(seq_padded.tolist())
                seq_lst_lens.append(seq_len)
                only_vb_lst.append(only_vb_padded.tolist())

            seq_lst_all_ev.append(seq_lst)
            only_vb_lst_all_ev.append(only_vb_lst)
            seq_lst_all_ev_lens.append(seq_lst_lens)
            evrel_lst_all_ev.append(evrel_lst)
            evrel_seq_lst_all_ev.append(evrel_seq_lst)

        assert len(vb_id_lst) == len(seq_id_lst) == 5
        # combined 5-event sequence (dat_loader.py:308-327)
        space_sep = self._space_sep
        vb_lst_all_ev_comb: List[int] = []
        for vbi in vb_id_lst:
            vb_lst_all_ev_comb += [vbi, space_sep[0]]
        seq_lst_all_ev_comb = vb_lst_all_ev_comb[:]
        for ev_ix in range(5):
            seq_lst_all_ev_comb += word_voc(seq_id_lst[ev_ix])["input_ids"]

        max_full_seq_len = 60 * 5
        seq_comb_tok, seq_comb_len = pad_tokens(
            seq_lst_all_ev_comb,
            pad_index=word_voc.pad_token_id,
            pad_side="right",
            append_eos=True,
            eos_index=word_voc.eos_token_id,
            max_len=max_full_seq_len,
        )

        out_dct = {
            "seq_out_by_ev": np.asarray(seq_lst_all_ev, dtype=np.int64),
            "evrel_out_by_ev": np.asarray(evrel_lst_all_ev, dtype=np.int64),
            "seq_out_lens_by_ev": np.asarray(seq_lst_all_ev_lens, dtype=np.int64),
            "seq_out_ev_comb_tok": np.asarray([seq_comb_tok.tolist()], dtype=np.int64),
            "seq_out_ev_comb_tok_len": np.asarray([seq_comb_len], dtype=np.int64),
            "vb_out_by_ev": np.asarray(only_vb_lst_all_ev, dtype=np.int64),
            "vb_out_ev_comb_tok": np.asarray([vb_lst_all_ev_comb], dtype=np.int64),
        }

        if is_evrel:
            out_dct.update(
                self._evrel_pair_data(vid_seg_ann_lst, evrel_seq_lst_all_ev,
                                      evrel_lst_all_ev)
            )
        return out_dct

    def _evrel_pair_data(
        self, vid_seg_ann_lst, evrel_seq_lst_all_ev, evrel_lst_all_ev
    ) -> Dict[str, np.ndarray]:
        """RoBERTa pair sequences vs Ev3 + per-event singles
        (dat_loader.py:342-451)."""
        evrel_wvoc = self.comm.rob_hf_tok

        def get_new_s(s):
            return s[0] + s[1]

        out_seq_by_ev, out_seq_lens_by_ev, out_labs_by_ev = [], [], []
        for evix in [0, 1, 3, 4]:
            seq_lst, len_lst, lab_lst = [], [], []
            for vix in range(len(vid_seg_ann_lst)):
                ev3_seq = evrel_seq_lst_all_ev[2][vix]
                evcurr_seq = evrel_seq_lst_all_ev[evix][vix]
                s1, s2 = (
                    (evcurr_seq, ev3_seq) if evix < 2 else (ev3_seq, evcurr_seq)
                )
                new_seq = evrel_wvoc(
                    get_new_s(s1) + evrel_wvoc.sep_token + get_new_s(s2)
                )["input_ids"]
                pad_seq, msk = pad_tokens(
                    new_seq,
                    pad_index=evrel_wvoc.pad_token_id,
                    pad_side="right",
                    append_eos=False,
                    eos_index=evrel_wvoc.eos_token_id,
                    max_len=120,
                )
                lab_lst.append(evrel_lst_all_ev[evix][vix])
                seq_lst.append(pad_seq.tolist())
                len_lst.append(msk)
            out_seq_by_ev.append(seq_lst)
            out_seq_lens_by_ev.append(len_lst)
            out_labs_by_ev.append(lab_lst)

        out: Dict[str, np.ndarray] = {
            "evrel_seq_out": np.asarray(out_seq_by_ev, dtype=np.int64),
            "evrel_seq_out_lens": np.asarray(out_seq_lens_by_ev, dtype=np.int64),
            "evrel_labs": np.asarray(out_labs_by_ev, dtype=np.int64),
        }

        ones_by_ev, ones_lens_by_ev, vb_by_ev, vb_lens_by_ev = [], [], [], []
        for evix in range(5):
            s_lst, sl_lst, v_lst, vl_lst = [], [], [], []
            for vix in range(len(vid_seg_ann_lst)):
                s1 = evrel_seq_lst_all_ev[evix][vix]
                new_seq = evrel_wvoc(get_new_s(s1))["input_ids"]
                pad_seq, msk = pad_tokens(
                    new_seq,
                    pad_index=evrel_wvoc.pad_token_id,
                    pad_side="right",
                    append_eos=False,
                    eos_index=evrel_wvoc.eos_token_id,
                    max_len=60,
                )
                s_lst.append(pad_seq.tolist())
                sl_lst.append(msk)
                vb_rob = evrel_wvoc(s1[0])["input_ids"]
                vb_pad, vb_msk = pad_tokens(
                    vb_rob,
                    pad_index=evrel_wvoc.pad_token_id,
                    pad_side="right",
                    append_eos=False,
                    eos_index=evrel_wvoc.eos_token_id,
                    max_len=5,
                )
                v_lst.append(vb_pad.tolist())
                vl_lst.append(vb_msk)
            ones_by_ev.append(s_lst)
            ones_lens_by_ev.append(sl_lst)
            vb_by_ev.append(v_lst)
            vb_lens_by_ev.append(vl_lst)

        out["evrel_seq_out_ones"] = np.asarray(ones_by_ev, dtype=np.int64)
        out["evrel_seq_out_ones_lens"] = np.asarray(ones_lens_by_ev, dtype=np.int64)
        out["evrel_vbonly_out_ones"] = np.asarray(vb_by_ev, dtype=np.int64)
        out["evrel_vbonly_out_ones_lens"] = np.asarray(vb_lens_by_ev, dtype=np.int64)
        return out

    # -- frames / features ---------------------------------------------------------
    def get_frms_all(self, idx: int) -> Dict[str, np.ndarray]:
        return load_event_clips(
            self.vsitu_frm_dir,
            self.vseg_lst[idx],
            self.comm.cent_frm_per_ev,
            self.comm.frm_seq_len,
            self.comm.sampling_rate,
            self.vid_cfg,
            max_frms=self.comm.max_frms,
            out_hw=self.vid_cfg.crop_size,
            keep_uint8=bool(self.full_cfg.tpu.on_device_preproc),
            cache_dir=self.full_cfg.tpu.frame_cache_dir or None,
            cache_write=bool(self.full_cfg.tpu.frame_cache_write),
        )

    def get_frm_feats_all(self, idx: int) -> Dict[str, np.ndarray]:
        vid_seg_name = self.vseg_lst[idx]
        feats = read_file_with_assertion(
            f"{self.cfg.vsit_frm_feats_dir}/{vid_seg_name}_feats.npy",
            reader="numpy",
        ).astype(np.float32)
        assert feats.shape[0] == 5
        return {"frm_feats": feats}

    def get_label_out_dct(self, idx: int) -> Dict[str, np.ndarray]:
        vid_seg_name = self.vseg_lst[idx]
        if self.split_type == "train":
            vid_seg_ann = self.vsitu_ann_dct[vid_seg_name][0]
            return self.get_vb_data([vid_seg_ann])
        if "valid" in self.split_type or "test" in self.split_type:
            vid_seg_ann_ = self.vsitu_vinfo_dct[vid_seg_name]["vb_id_lst_new"]
            assert len(vid_seg_ann_) >= 9
            return self.get_vb_data(vid_seg_ann_)
        raise NotImplementedError(self.split_type)

    # -- item getters --------------------------------------------------------------
    def vb_only_item_getter(self, idx: int) -> Dict[str, np.ndarray]:
        out = self.get_frms_all(idx)
        out["vseg_idx"] = np.asarray(idx, dtype=np.int64)
        out.update(self.get_label_out_dct(idx))
        return out

    def vb_args_item_getter(self, idx: int) -> Dict[str, np.ndarray]:
        vid_seg_name = self.vseg_lst[idx]
        if self.split_type == "train":
            anns = [self.vsitu_ann_dct[vid_seg_name][0]]
        elif "valid" in self.split_type or "test" in self.split_type:
            anns = self.vsitu_ann_dct[vid_seg_name]
            assert len(anns) >= 3
            anns = anns[:3]
        else:
            raise NotImplementedError(self.split_type)
        out = self.get_vb_arg_data(anns, is_evrel=self.is_evrel)
        out["vseg_idx"] = np.asarray(idx, dtype=np.int64)
        if self.full_cfg.mdl.mdl_name not in TOKEN_ONLY_MDLS:
            out.update(self.get_frm_feats_all(idx))
        return out
