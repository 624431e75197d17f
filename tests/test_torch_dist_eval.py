"""The port's evaluators and feature extraction over 2 gloo ranks on the
CPU (tests/torch_dist_child.py), against the JAX package's one process.

Evaluation: ``python -m vidsitu_tpu_torch.main --only_val=True`` with the
same seeded weights (``--weights``) for ``vb`` (``EvalB``), ``vb_arg``
(``EvalB_Gen``, beam 2 on the reorder route) and ``evrel`` (``EvalB_Acc``),
in float32. The valid split has 3 segments, which the sampler pads to 4: rank
0 decodes segments 0 and 2, rank 1 segments 1 and 0 again. Rank 0's merged
``valid_0.pkl`` equals the JAX package's 1-process pickle entry for entry
(tokens and verbs exactly, probabilities within 1e-5), the metrics are equal
and reach both ranks. ``EvalB_Acc``'s loss is its definition computed here
in float64 from the JAX logits: the mean of the rows' masked cross-entropies
weighted by rows, over every rank's rows, the sampler's repeat not counted.

Extraction: ``python -m vidsitu_tpu_torch.extract`` on 2 ranks writes the
file set of one process, every array within 1e-5.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_evrel import TINY_ROB
from tests.test_torch_extract import TINY as EXTRACT_TINY
from tests.test_torch_learner import TINY as VB_TINY
from tests.test_torch_transformer import TINY as SRL_TINY
from tests.torch_dist_child import launch
from vidsitu_tpu.data import build_comm, get_data
from vidsitu_tpu.evaluation.evaluators import EvalB as JEvalB
from vidsitu_tpu.evaluation.evaluators import EvalB_Acc as JEvalB_Acc
from vidsitu_tpu.evaluation.evaluators import EvalB_Gen as JEvalB_Gen
from vidsitu_tpu.models import selector as jsel
from vidsitu_tpu.utils.config import get_cfg_with_overrides
from vidsitu_tpu_torch import extract as port_extract
from vidsitu_tpu_torch.convert.from_flax import (
    flax_to_state_dict,
    seeded_variables,
)
from vidsitu_tpu_torch.data.synth import make_synth_dataset
from vidsitu_tpu_torch.models import selector as psel

torch.set_num_threads(1)

COMMON = {"train.bs": 2, "train.bsv": 2, "train.nw": 0, "train.nwv": 0,
          "train.dtype": "float32"}
TASKS = {
    "vb": {**VB_TINY, **COMMON},
    "vb_arg": {**SRL_TINY, **COMMON, "task_type": "vb_arg",
               "mdl.mdl_name": "sfpret_txe_txd_vbarg", "gen.max_len_b": 12,
               "gen.beam_size": 2, "tpu.ancestry_beam": False},
    "evrel": {**TINY_ROB, **COMMON, "task_type": "evrel",
              "mdl.mdl_name": "sfpret_evrel"},
}


def _masked_ce(logits, labels):
    """One row's cross-entropy over its labels != -1, in float64."""
    lo = np.asarray(logits, np.float64).reshape(-1, logits.shape[-1])
    lab = np.asarray(labels).reshape(-1)
    mask = lab != -1
    lo = lo - lo.max(-1, keepdims=True)
    ce = np.log(np.exp(lo).sum(-1)) - lo[np.arange(len(lab)),
                                         np.where(mask, lab, 0)]
    return float((ce * mask).sum() / max(mask.sum(), 1))


def _jax_evaluator(task, cfg, comm, jm):
    if task == "vb":
        return JEvalB(cfg, comm, jm)
    if task == "evrel":
        return JEvalB_Acc(cfg, comm, jm)
    return JEvalB_Gen(cfg, comm, jsel.build_srl_generate_fn(cfg, comm, jm))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_eval")
    paths = make_synth_dataset(root / "data", n_train=2, n_valid=3, n_test=1,
                               with_frames=True, seed=23)
    return root, paths


@pytest.fixture(scope="module")
def evals(env):
    """Each task: the JAX package's 1-process pickle, loss and metrics, and
    one 2-rank launch of main.py --only_val over the three tasks."""
    root, paths = env
    refs, runs = {}, []
    for seed, (task, kw) in enumerate(TASKS.items()):
        kv = {**paths, **kw, "misc.tmp_path": str(root / "port")}
        cfg = get_cfg_with_overrides(f"ev_{task}", **kv)
        comm = build_comm(cfg)
        pm = psel.build_model(cfg, comm)
        tree = seeded_variables(pm, 5 + seed)
        jm = jsel.build_model(cfg, comm)
        jdir = root / "jax" / task
        dl = get_data(cfg).valid_dl
        jloss, jacc = _jax_evaluator(task, cfg, comm, jm)(
            tree, dl, "valid", jdir)
        with open(jdir / "valid_0.pkl", "rb") as f:
            jpred = pickle.load(f)
        ref = {"pred": jpred, "loss": jloss, "acc": jacc}
        if task == "evrel":  # the loss's definition, from the JAX logits
            rows = []
            for b in dl:
                lo = np.asarray(jm.apply(tree, {
                    k: jnp.asarray(v) for k, v in b.items()})["mdl_out"])
                rows += [_masked_ce(lo[i], b["evrel_labs"][i])
                         for i in range(lo.shape[0])]
            ref["loss_def"] = float(np.mean(rows))
        wfile = root / f"{task}_weights.pt"
        torch.save(flax_to_state_dict(tree), wfile)
        refs[task] = ref
        runs.append([f"ev_{task}", *[f"--{k}={v}" for k, v in kv.items()],
                     "--only_val=True", "--device=cpu", f"--weights={wfile}"])
    outs, _ = launch("main", {"runs": runs}, root)
    return root, refs, outs


@pytest.mark.parametrize("task", list(TASKS))
def test_merged_pickle_and_metrics_equal_one_jax_process(evals, task):
    root, refs, outs = evals
    ref = refs[task]
    pdir = root / "port" / "predictions" / f"ev_{task}"
    with open(pdir / "valid_0.pkl", "rb") as f:
        merged = pickle.load(f)
    with open(pdir / "valid_1.pkl", "rb") as f:
        rank1 = pickle.load(f)
    # the sampler's repeat: rank 1 decoded segment 0 again
    assert [p["ann_idx"] for p in rank1] == [1, 0]
    assert [p["ann_idx"] for p in merged] == [0, 1, 2]
    assert [p["ann_idx"] for p in ref["pred"]] == [0, 1, 2]
    if task == "vb_arg":
        assert merged == ref["pred"]
    else:
        key = "pred_vbs_ev" if task == "vb" else "pred_evrels_ev"
        for p, j in zip(merged, ref["pred"]):
            assert set(p) == set(j) and p[key] == j[key]
            np.testing.assert_allclose(p["pred_scores_ev"],
                                       j["pred_scores_ev"], rtol=1e-5)
    i = list(TASKS).index(task)
    for out in outs:  # rank 0's metrics, on both ranks
        loss, acc = out["runs"][i]["results"]["valid"]
        assert acc == ref["acc"], (acc, ref["acc"])
        if task == "evrel":
            np.testing.assert_allclose(loss["loss"], ref["loss_def"],
                                       rtol=1e-5)
    assert not list(pdir.glob(".valid_*.done"))


def test_extraction_over_two_ranks_writes_the_one_process_files(env):
    root, paths = env
    args = ["--device=cpu", "--allow_random_weights", "--split=valid",
            "--batch_size=3", "--clip_batch=7", "--num_threads=0",
            *[f"--{k}={v}" for k, v in {**paths, **EXTRACT_TINY}.items()]]
    one, two = root / "feats1", root / "feats2"
    port_extract.main([*args, f"--out_dir={one}"])
    launch("extract", {"argv": [*args, f"--out_dir={two}"]}, root)
    files = sorted(p.name for p in one.iterdir())
    assert len(files) == 3 and files == sorted(p.name for p in two.iterdir())
    for name in files:
        a, b = np.load(one / name), np.load(two / name)
        assert a.shape == b.shape == (5, 2048)
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
