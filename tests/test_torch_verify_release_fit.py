"""``--fit`` of the port's release harness on the CPU, each task at the
JAX module's tiny dims (``verify_release._FIT_DIMS``): the training
lifecycle through ``build_learner`` passes, the receipt has the JAX
module's keys plus ``device``, the loss drops, the resume by uid lands on
the first run's best epoch (a resume that restores another epoch fails the
task), and a stale tracker stream from an earlier rehearsal in the same
work dir is dropped first.
"""

import ast
import json

import numpy as np
import pytest
import torch

import vidsitu_tpu.verify_release as jvr
import vidsitu_tpu_torch.verify_release as pvr

torch.set_num_threads(1)


def _jax_receipt_keys():
    """The JAX module's receipt keys, read from its source: the top-level
    dict and each task's entry."""
    tree = ast.parse(open(jvr.__file__).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "fit_rehearsal")
    top = entry = None
    for node in ast.walk(fn):
        if isinstance(node, ast.AnnAssign) and node.target.id == "receipt":
            top = {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "entry":
            entry = {k.value for k in node.value.keys}
    assert top and entry
    return top, entry


@pytest.mark.parametrize("task,mdl", list(pvr.FIT_TASKS),
                         ids=[t for t, _ in pvr.FIT_TASKS])
def test_fit_rehearsal(tmp_path, capsys, task, mdl):
    work = tmp_path / "w"
    if task == "vb_arg":
        # a stale stream from a previous rehearsal in the same work dir:
        # the tracker appends, so --fit drops it first
        stale = (work / "tmp" / "tracking" / "vsitu_fin_vb_arg"
                 / f"fit_vb_arg_{mdl}" / "metrics.jsonl")
        stale.parent.mkdir(parents=True)
        stale.write_text('{"trn_loss": 99.9}\n')
    rep = pvr.Report()
    receipt = pvr.fit_rehearsal(work, rep, epochs=2, tasks=[(task, mdl)],
                                device="cpu")
    out = capsys.readouterr().out
    assert not rep.failed and rep.passed == [f"fit[{task}/{mdl}]"], out
    top, entry = _jax_receipt_keys()
    assert set(receipt) == top | {"device"}
    assert (receipt["platform"], receipt["device"]) == ("cpu", "cpu")
    (t,) = receipt["tasks"]
    assert set(t) == entry
    assert t["loss_drop"] > 0 and len(t["trn_loss"]) == 2
    assert t["resume_epoch"] >= 1
    assert all(np.isfinite(v) for v in t["val_metrics"].values())
    assert (work / "fit_receipt.json").exists()
    assert (tmp_path / "w" / "tmp").exists() and t["pred_pkl"].endswith(
        "valid_0.pkl")
    assert json.loads(out.split("FIT_RECEIPT ", 1)[1].splitlines()[0]) == (
        receipt)


def test_resume_lands_on_the_best_epoch(tmp_path, monkeypatch):
    """The check holds the resumed epoch to the first run's best epoch:
    a resume that restored another epoch fails the task."""
    from vidsitu_tpu_torch.train import learner as L

    load = L.Learner.load_model_dict

    def off_by_one(self, *a, **k):
        load(self, *a, **k)
        self.num_epoch += 1

    monkeypatch.setattr(L.Learner, "load_model_dict", off_by_one)
    rep = pvr.Report()
    pvr.fit_rehearsal(tmp_path, rep, epochs=2, tasks=[("evrel", "rob_evrel")],
                      device="cpu")
    assert rep.failed == ["fit[evrel/rob_evrel]"]




def _evrel_fit(tmp_path, seed):
    base = dict(pvr._FIT_DIMS["evrel"])
    pvr._FIT_DIMS["evrel"] = {**base, "train.seed": seed}
    try:
        rep = pvr.Report()
        receipt = pvr.fit_rehearsal(tmp_path, rep, epochs=2,
                                    tasks=[("evrel", "rob_evrel")],
                                    device="cpu")
    finally:
        pvr._FIT_DIMS["evrel"] = base
    return rep, receipt


def test_loss_check_fails_without_an_update(tmp_path, monkeypatch):
    """The loss check is held on the first batch under the first step's
    masks: with the optimizer's step a no-op the loss does not move, and
    the task fails."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    rep, _ = _evrel_fit(tmp_path, 42)
    assert rep.failed == ["fit[evrel/rob_evrel]"]


def test_first_batch_loss_is_the_first_steps_loss(tmp_path):
    """``first_batch_loss`` computes the first training step's loss (the
    tracker's first epoch loss at one step an epoch), repeats, and leaves
    the model's buffers as they were."""
    from vidsitu_tpu_torch.data.loader import fold_frame_events
    from vidsitu_tpu_torch.data.synth import make_synth_dataset
    from vidsitu_tpu_torch.train.build import build_learner
    from vidsitu_tpu_torch.train.learner import batch_to_device
    from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

    paths = make_synth_dataset(tmp_path / "synth", n_train=8, n_valid=4,
                               seed=5, with_frames=True)
    cfg = get_cfg_with_overrides("fbl", **{
        **paths, **pvr._FIT_DIMS["vb"], "task_type": "vb",
        "mdl.mdl_name": "sf_base", "train.bs": 8, "train.bsv": 8,
        "train.nw": 0, "train.nwv": 0, "train.dtype": "float32",
        "misc.tmp_path": str(tmp_path / "tmp")})
    learner = build_learner(cfg, "fbl", "cpu")
    bufs = {k: v.clone() for k, v in learner.model.named_buffers()}
    loss = pvr.first_batch_loss(learner)
    first = loss()
    assert loss() == first
    assert all(torch.equal(v, bufs[k])
               for k, v in learner.model.named_buffers())
    learner.prepare_optimizer(1e-3)
    dl = learner.data.train_dl
    dl.set_epoch(0)
    step = learner.train_step(batch_to_device(
        fold_frame_events(next(iter(dl))), learner.device))
    torch.testing.assert_close(float(step), first, rtol=1e-6, atol=0)
    assert loss() < first


def test_epoch_losses_can_rise_on_a_sound_run(tmp_path):
    """Why the check holds the masks: at one step an epoch the tracker's
    epoch losses, each under its own masks, rose for the tiny rob_evrel at
    train.seed 3 on the CPU (the JAX module's check would fail it), while
    the first batch's loss under one set of masks fell by a third."""
    rep, receipt = _evrel_fit(tmp_path, 3)
    (t,) = receipt["tasks"]
    assert not rep.failed
    assert t["trn_loss"][1] >= t["trn_loss"][0], t["trn_loss"]
    assert t["loss_drop"] > 0.2, t


def test_release_probe_fit_runs_on_the_cpu(monkeypatch):
    """``release_probe fit``, the card-against-CPU diagnosis of the
    rehearsal's rob_evrel, with the CPU standing in for the card: the same
    batch and weights, every module and trajectory equal; without a GPU
    its command line raises."""
    from vidsitu_tpu_torch import release_probe

    res = release_probe.probe_fit(42, n_masks=2, gpu="cpu")
    assert res["same_initial_weights"] and res["modules_parted"] == []
    assert res["loss_no_dropout"]["cpu"] == res["loss_no_dropout"]["cuda"]
    traj = res["trajectory"]
    assert traj["cpu_masks"] == traj["cuda_masks"] == traj[
        "cuda_host_masks"]
    assert traj["cpu_off"] == traj["cuda_off"]
    assert traj["cpu_off"][1] < traj["cpu_off"][0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        release_probe.main(["fit"])
