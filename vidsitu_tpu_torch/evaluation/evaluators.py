"""SRL generation evaluator (port of ``EvalB_Gen``,
vidsitu_tpu/evaluation/evaluators.py:401; reference: evl_vsitu.py:148-214).

One process: pad each batch to the eval batch size, generate, decode the
tokens into role dicts, dedupe by ``ann_idx``, write ``{dl_name}_0.pkl``
(the leaderboard format) and score it with ``EvalFnCap``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ..utils.io import write_pickle
from .evl_fns import EvalFnCap


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
        seen = set()
        uniq = [r for r in results
                if r["ann_idx"] not in seen and not seen.add(r["ann_idx"])]
        Path(pred_path).mkdir(parents=True, exist_ok=True)
        fname = Path(pred_path) / f"{dl_name}_0.pkl"
        write_pickle(uniq, fname)
        out_acc = self.score(str(fname))
        return ({"loss": 0.0},
                {k: float(out_acc[k]) for k in self.met_keys if k in out_acc})
