"""In-loop evaluators (port of vidsitu_tpu/evaluation/evaluators.py;
reference: evl_vsitu.py): ``EvalB`` for verb prediction (:276) and
``EvalB_Gen`` for SRL generation (:401).

One process: pad each batch to the eval batch size, run the model, decode
its output into leaderboard entries, dedupe by ``ann_idx``, write
``{dl_name}_0.pkl`` and score it (``EvlFn_Vb`` / ``EvalFnCap``). Each
evaluator is ``evaluator(dl, dl_name, pred_path) -> (loss_dict,
metric_dict)`` with ``met_keys``, as the Learner calls it.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ..utils.io import write_pickle
from .evl_fns import EvalFnCap, EvlFn_Vb


def pad_batch_to(batch: Dict[str, np.ndarray], size: int) -> Dict[str, np.ndarray]:
    """Repeat the last row so every batch has a static shape (the
    duplicated ann_idx rows are deduped by the scorers)."""
    b = next(iter(batch.values())).shape[0]
    if b == size:
        return batch
    reps = size - b
    return {
        k: np.concatenate([v, np.repeat(v[-1:], reps, axis=0)], axis=0)
        for k, v in batch.items()
    }


def conv_seq_to_srl(inp_seq: str, ag_start_values) -> Dict[str, str]:
    """Parse 'vb <ArgX> text <ArgY> text...' (evl_vsitu.py:174-194)."""
    inp_tok_lst = inp_seq.split(" ")
    if "." not in inp_tok_lst[0]:
        return {}
    vb_dct = {"vb_id": inp_tok_lst[0]}
    ix = 1
    curr_str_lst: List[str] = []
    curr_arg_name = ""
    while ix < len(inp_tok_lst):
        if inp_tok_lst[ix] not in ag_start_values:
            curr_str_lst.append(inp_tok_lst[ix])
        else:
            if ix > 1:
                vb_dct[curr_arg_name] = " ".join(curr_str_lst)
            curr_arg_name = inp_tok_lst[ix].split("<", 1)[1].rsplit(">", 1)[0]
            curr_str_lst = []
        ix += 1
    vb_dct[curr_arg_name] = " ".join(curr_str_lst)
    return vb_dct


class EvalB_Gen:
    """``evaluator(dl, dl_name, pred_path) -> (loss_dict, metric_dict)``.

    ``batch_seconds`` holds each batch's wall time, from the host batch to
    the tokens back on the host."""

    met_keys = ["cider", "rouge", "lea", "MacroVb_cider", "MacroArg_cider"]

    def __init__(self, cfg, comm, generate_fn, device,
                 split_type: str = "valid", world_size: int = 1):
        if world_size != 1:
            raise NotImplementedError(
                "EvalB_Gen over several processes is not ported yet "
                "(ROADMAP.md, Queue 1 item 4)")
        self.cfg = cfg
        self.comm = comm
        self.generate_fn = generate_fn
        self.device = torch.device(device)
        self.split_type = split_type
        self.evl_met = EvalFnCap(cfg, comm, met_keys=["cider", "bleu", "rouge"])
        self.batch_seconds: List[float] = []

    def run_model(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        t0 = time.perf_counter()
        inp = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for k, v in batch.items()}
        out = self.generate_fn(inp).cpu().numpy()
        self.batch_seconds.append(time.perf_counter() - t0)
        return out

    def decode_batch(self, out_sents: np.ndarray,
                     ann_lst: np.ndarray) -> List[Dict]:
        wvoc = self.comm.gpt2_hf_tok
        ag_starts = set(self.comm.ag_name_dct.ag_dct_start.values())
        out = []
        for bix in range(out_sents.shape[0]):
            vb_dct = {}
            for ev_ix in range(5):
                text = wvoc.decode(out_sents[bix, ev_ix, 0],
                                   skip_special_tokens=True)
                vb_dct[f"Ev{ev_ix + 1}"] = conv_seq_to_srl(text, ag_starts)
            out.append({"ann_idx": int(ann_lst[bix]), "vb_output": vb_dct})
        return out

    def score(self, fname: str) -> Dict:
        return self.evl_met.eval_cap_mets(fname, split_type=self.split_type)

    def __call__(self, dl, dl_name: str, pred_path):
        results: List[Dict] = []
        for batch in dl:
            padded = pad_batch_to(batch, dl.batch_size)
            results += self.decode_batch(self.run_model(padded),
                                         padded["vseg_idx"])
        fname = _write_unique(results, pred_path, dl_name)
        out_acc = self.score(str(fname))
        return ({"loss": 0.0},
                {k: float(out_acc[k]) for k in self.met_keys if k in out_acc})


def _write_unique(results: List[Dict], pred_path, dl_name: str) -> Path:
    seen = set()
    uniq = [r for r in results
            if r["ann_idx"] not in seen and not seen.add(r["ann_idx"])]
    Path(pred_path).mkdir(parents=True, exist_ok=True)
    fname = Path(pred_path) / f"{dl_name}_0.pkl"
    write_pickle(uniq, fname)
    return fname


class EvalB:
    """Verb prediction (evl_vsitu.py:21-145): the model's eval-mode forward,
    softmax in float64, the top-5 verbs and their probabilities per event,
    the pickle, ``EvlFn_Vb.simple_acc``. ``batch_seconds`` holds each
    batch's wall time, host batch to logits on the host."""

    met_keys = ["Per_Ev_Top_1", "Per_Ev_Top_5", "recall_macro_1_th_9"]

    def __init__(self, cfg, comm, model, device, split_type: str = "valid",
                 world_size: int = 1):
        if world_size != 1:
            raise NotImplementedError(
                "EvalB over several processes is not ported yet "
                "(ROADMAP.md, Queue 1 item 5)")
        self.cfg = cfg
        self.comm = comm
        self.model = model
        self.device = torch.device(device)
        self.split_type = split_type
        self.evl_met = EvlFn_Vb(cfg, comm, self.met_keys)
        self.batch_seconds: List[float] = []

    def run_model(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        from ..data.loader import fold_frame_events
        from ..train.learner import batch_to_device

        t0 = time.perf_counter()
        self.model.eval()
        with torch.inference_mode():
            out = self.model(batch_to_device(fold_frame_events(batch),
                                             self.device))["mdl_out"]
            logits = out.float().cpu().numpy()
        self.batch_seconds.append(time.perf_counter() - t0)
        return logits

    def decode_batch(self, mdl_out: np.ndarray, ann_lst: np.ndarray,
                     topk: int = 5) -> List[Dict]:
        symbols = self.comm.vb_id_vocab.symbols
        x = mdl_out.astype(np.float64)
        probs = np.exp(x - x.max(-1, keepdims=True))
        probs = probs / probs.sum(-1, keepdims=True)
        order = np.argsort(-probs, axis=-1)[..., :topk]
        out = []
        for bix in range(mdl_out.shape[0]):
            pred_vbs, pred_scores = [], []
            for ev in range(5):
                ixs = order[bix, ev]
                pred_vbs.append([symbols[i] for i in ixs])
                pred_scores.append([float(probs[bix, ev, i]) for i in ixs])
            out.append({"pred_vbs_ev": pred_vbs,
                        "pred_scores_ev": pred_scores,
                        "ann_idx": int(ann_lst[bix])})
        return out

    def __call__(self, dl, dl_name: str, pred_path):
        results: List[Dict] = []
        for batch in dl:
            padded = pad_batch_to(batch, dl.batch_size)
            results += self.decode_batch(self.run_model(padded),
                                         padded["vseg_idx"])
        fname = _write_unique(results, pred_path, dl_name)
        out_acc = self.evl_met.simple_acc(str(fname),
                                          split_type=self.split_type)
        return ({"loss": 0.0},
                {k: float(out_acc[k]) for k in self.met_keys if k in out_acc})
