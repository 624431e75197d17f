"""In-loop evaluators (port of vidsitu_tpu/evaluation/evaluators.py;
reference: evl_vsitu.py): ``EvalB`` for verb prediction (:276),
``EvalB_Acc`` for event relations (:327) and ``EvalB_Gen`` for SRL
generation (:401).

Each rank pads each batch of its loader shard to the eval batch size, runs
the model and decodes its own rows into leaderboard entries, each under the
``ann_idx`` of its own batch's ``vseg_idx`` (the JAX package decodes the
global batch on rank 0 against rows it assumes rank-major,
evaluators.py:357). Rank 0 merges every rank's entries (``_merge_ranks``),
drops the sampler's padding duplicates by ``ann_idx``, orders the entries by
``ann_idx``, writes ``{dl_name}_0.pkl`` and scores it (``EvlFn_Vb`` /
``EvalFnCap`` / ``EvlFn_EvRel``); the other ranks return zeros, as the JAX
package's do. One process writes and scores its own entries alike. Under
a ``model`` mesh axis ``rank`` / ``world_size`` are the data coordinate and
extent: the ranks of a model group decode the same rows, and only model
coordinate 0 writes (``model_rank``); the others join the collectives and
return zeros. Each evaluator is ``evaluator(dl, dl_name, pred_path) -> (loss_dict,
metric_dict)`` with ``met_keys``, as the Learner calls it.
"""

from __future__ import annotations

import pickle
import time
import uuid
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..parallel.collectives import (
    broadcast_object,
    data_group,
    reduce_dict_corr,
    synchronize,
)
from ..utils.io import write_pickle
from .evl_fns import EvalFnCap, EvlFn_EvRel, EvlFn_Vb


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


def sampler_rows(dl) -> int:
    """How many of this rank's loader rows come before the sampler's
    padding: ``ShardedSampler`` repeats the order from its start until every
    shard has as many rows, and shard s takes the padded order's positions
    s, s + W, ...; those at or past the dataset's length are repeats. A
    loader without a sharded sampler has no such rows."""
    sampler = getattr(dl, "sampler", None)
    if sampler is None or getattr(sampler, "num_shards", 1) == 1:
        return len(dl.dataset)
    w, s = sampler.num_shards, sampler.shard_id
    return max(0, (sampler.n - s + w - 1) // w)


class _RankedEvaluator:
    """The per-rank pickle, the ``.done`` marker and rank 0's merge
    (port of the JAX package's ``_run_token`` / ``_merge_ranks``,
    evaluators.py:106-187)."""

    def __init__(self, rank: int = 0, world_size: int = 1,
                 model_rank: int = 0):
        self.rank = rank
        self.world_size = world_size
        self.model_rank = model_rank
        self._merge_seq = 0
        self._merge_token: Optional[str] = None

    def rebind(self, model, rank: int, world_size: int,
               model_rank: int = 0):
        """A mid-run resize (``Learner.request_resize``; the JAX package's
        ``rebind_mesh``, evaluators.py:88): evaluate the survivors' ``model``
        as data coordinate ``rank`` of ``world_size``, model coordinate
        ``model_rank``. The run token and the merge's sequence number are
        the same on every survivor and stay."""
        self.rank, self.world_size = rank, world_size
        self.model_rank = model_rank
        self._bind_model(model)

    def _bind_model(self, model):
        self.model = model

    def _run_token(self) -> str:
        """This run's token, rank 0's, on every rank: it tells this run's
        markers from those a crashed run with the same uid left. A failed
        broadcast raises (the JAX package falls back to a per-rank token,
        and the merge then times out on markers that never come)."""
        if self._merge_token is None:
            self._merge_token = broadcast_object(uuid.uuid4().hex[:8])
        return self._merge_token

    def _merge_ranks(self, pred_path, dl_name: str,
                     own: List[Dict]) -> Optional[Path]:
        """Write this rank's entries; on rank 0, merge every rank's and
        write ``{dl_name}_0.pkl`` (returned; None on the other ranks). Each
        call has a sequence number, equal on every rank, and each rank's
        ``.done`` marker carries it with the run token: rank 0 reads a
        rank's pickle only behind this call's marker, else raises rather
        than score another call's predictions. A rank of model coordinate
        > 0 holds its model group's entries again: it writes nothing, joins
        the run token's broadcast and the barriers, and returns None."""
        pred_path = Path(pred_path)
        pred_path.mkdir(parents=True, exist_ok=True)
        if self.world_size == 1:
            if self.model_rank:
                return None
            return _write_unique(own, pred_path, dl_name)
        self._merge_seq += 1
        seq, tok = self._merge_seq, self._run_token()
        if self.model_rank:
            synchronize()
            synchronize()
            return None
        if seq == 1:
            for stale in pred_path.glob(f".{dl_name}_{self.rank}.*.done"):
                stale.unlink()
        write_pickle(own, pred_path / f"{dl_name}_{self.rank}.pkl")
        (pred_path / f".{dl_name}_{self.rank}.{tok}.{seq}.done").touch()
        synchronize()  # every rank's pickle and marker are in place
        merged = list(own)
        if self.rank == 0:
            for w in range(1, self.world_size):
                marker = pred_path / f".{dl_name}_{w}.{tok}.{seq}.done"
                if not marker.exists():
                    raise RuntimeError(
                        f"eval merge: rank {w} published no {marker.name} "
                        f"in {pred_path}; refusing to score a partial merge")
                with open(pred_path / f"{dl_name}_{w}.pkl", "rb") as f:
                    merged += pickle.load(f)
                marker.unlink()
            (pred_path / f".{dl_name}_0.{tok}.{seq}.done").unlink()
        synchronize()  # rank 0 has read them: the next call may overwrite
        if self.rank != 0:
            return None
        return _write_unique(merged, pred_path, dl_name)

    def _zeros(self):
        return {"loss": 0.0}, {k: 0.0 for k in self.met_keys}


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


class EvalB_Gen(_RankedEvaluator):
    """``evaluator(dl, dl_name, pred_path) -> (loss_dict, metric_dict)``.

    ``batch_seconds`` holds each batch's wall time, from the host batch to
    the tokens back on the host."""

    met_keys = ["cider", "rouge", "lea", "MacroVb_cider", "MacroArg_cider"]

    def __init__(self, cfg, comm, generate_fn, device,
                 split_type: str = "valid", rank: int = 0,
                 world_size: int = 1, model_rank: int = 0):
        super().__init__(rank, world_size, model_rank)
        self.cfg = cfg
        self.comm = comm
        self.generate_fn = generate_fn
        self.device = torch.device(device)
        self.split_type = split_type
        self.evl_met = EvalFnCap(cfg, comm, met_keys=["cider", "bleu", "rouge"])
        self.batch_seconds: List[float] = []

    def _bind_model(self, model):
        from ..models.selector import build_srl_generate_fn

        self.generate_fn = build_srl_generate_fn(self.cfg, self.comm, model)

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
        fname = self._merge_ranks(pred_path, dl_name, results)
        if fname is None:
            return self._zeros()
        out_acc = self.score(str(fname))
        return ({"loss": 0.0},
                {k: float(out_acc[k]) for k in self.met_keys if k in out_acc})


def _write_unique(results: List[Dict], pred_path, dl_name: str) -> Path:
    """``{dl_name}_0.pkl``: the first entry of each ``ann_idx``, in the
    order of ``ann_idx``."""
    seen = set()
    uniq = [r for r in results
            if r["ann_idx"] not in seen and not seen.add(r["ann_idx"])]
    uniq.sort(key=lambda r: r["ann_idx"])
    Path(pred_path).mkdir(parents=True, exist_ok=True)
    fname = Path(pred_path) / f"{dl_name}_0.pkl"
    write_pickle(uniq, fname)
    return fname


class EvalB(_RankedEvaluator):
    """Verb prediction (evl_vsitu.py:21-145): the model's eval-mode forward,
    softmax in float64, the top-5 verbs and their probabilities per event,
    the pickle, ``EvlFn_Vb.simple_acc``. ``batch_seconds`` holds each
    batch's wall time, host batch to logits on the host."""

    met_keys = ["Per_Ev_Top_1", "Per_Ev_Top_5", "recall_macro_1_th_9"]

    def __init__(self, cfg, comm, model, device, split_type: str = "valid",
                 rank: int = 0, world_size: int = 1, model_rank: int = 0):
        super().__init__(rank, world_size, model_rank)
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
        fname = self._merge_ranks(pred_path, dl_name, results)
        if fname is None:
            return self._zeros()
        out_acc = self.evl_met.simple_acc(str(fname),
                                          split_type=self.split_type)
        return ({"loss": 0.0},
                {k: float(out_acc[k]) for k in self.met_keys if k in out_acc})


class EvalB_Acc(_RankedEvaluator):
    """Event relations (evl_vsitu.py:217-261): the model's eval-mode logits
    (B, 4, N, 5), softmax in float64, the top-1 relation and its
    probability per pair and annotator, the pickle, and
    ``EvlFn_EvRel.simple_acc_evrel``. The validation loss is the masked
    cross-entropy recomputed on the host in float64 from the same logits,
    over the real rows of a padded final batch only, weighted by each
    batch's real rows (evaluators.py:349-360); over several ranks, the data
    group's losses weighted by their real rows (``reduce_dict_corr``, in
    float64), the sampler's padding repeats not counted. ``batch_seconds``
    holds each batch's wall time, host batch to logits on the host."""

    met_keys = ["Macro_Top_1", "Top_1"]

    def __init__(self, cfg, comm, model, device, split_type: str = "valid",
                 rank: int = 0, world_size: int = 1, model_rank: int = 0):
        super().__init__(rank, world_size, model_rank)
        self.cfg = cfg
        self.comm = comm
        self.model = model
        self.device = torch.device(device)
        self.split_type = split_type
        self.evl_met = EvlFn_EvRel(cfg, comm, self.met_keys)
        self.batch_seconds: List[float] = []

    def run_model(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        from ..train.learner import batch_to_device

        t0 = time.perf_counter()
        self.model.eval()
        with torch.inference_mode():
            out = self.model.logits(batch_to_device(batch, self.device))
            logits = out.float().cpu().numpy()
        self.batch_seconds.append(time.perf_counter() - t0)
        return logits

    @staticmethod
    def loss_from_outputs(logits: np.ndarray, labels: np.ndarray,
                          n_real: int) -> float:
        """Masked cross-entropy (labels != -1) of the first ``n_real`` rows,
        in float64."""
        lo = np.asarray(logits)[:n_real].astype(np.float64)
        lo = lo.reshape(-1, lo.shape[-1])
        lab = np.asarray(labels)[:n_real].reshape(-1)
        mask = lab != -1
        lo = lo - lo.max(-1, keepdims=True)
        lse = np.log(np.exp(lo).sum(-1))
        ce = lse - lo[np.arange(lo.shape[0]), np.where(mask, lab, 0)]
        return float((ce * mask).sum() / max(mask.sum(), 1.0))

    def decode_batch(self, mdl_out: np.ndarray,
                     ann_lst: np.ndarray) -> List[Dict]:
        opp = self.comm.evrel_dct_opp
        x = mdl_out.astype(np.float64)
        probs = np.exp(x - x.max(-1, keepdims=True))
        probs = probs / probs.sum(-1, keepdims=True)
        top1 = probs.argmax(-1)  # (B, 4, N)
        out = []
        for bix in range(mdl_out.shape[0]):
            out.append({
                "pred_evrels_ev": [[opp[int(i)] for i in top1[bix, ev]]
                                   for ev in range(4)],
                "pred_scores_ev": [
                    [float(probs[bix, ev, n, top1[bix, ev, n]])
                     for n in range(top1.shape[2])] for ev in range(4)],
                "ann_idx": int(ann_lst[bix])})
        return out

    def __call__(self, dl, dl_name: str, pred_path):
        results: List[Dict] = []
        losses: List[float] = []
        nums: List[int] = []
        left = sampler_rows(dl)  # rows before the sampler's repeats
        for batch in dl:
            n_real = min(next(iter(batch.values())).shape[0], left)
            left -= n_real
            padded = pad_batch_to(batch, dl.batch_size)
            out = self.run_model(padded)
            results += self.decode_batch(out, padded["vseg_idx"])
            if n_real:
                losses.append(self.loss_from_outputs(
                    out, padded["evrel_labs"], n_real))
                nums.append(n_real)
        local = float(np.average(losses, weights=nums)) if losses else 0.0
        val_loss = reduce_dict_corr({"loss": local}, float(sum(nums)),
                                    group=data_group())["loss"]
        fname = self._merge_ranks(pred_path, dl_name, results)
        if fname is None:
            return {"loss": val_loss}, {k: 0.0 for k in self.met_keys}
        out_acc = self.evl_met.simple_acc_evrel(str(fname),
                                                split_type=self.split_type)
        return ({"loss": val_loss},
                {k: float(out_acc[k]) for k in self.met_keys if k in out_acc})
