"""The port's training engine (vidsitu_tpu_torch/train/) on the CPU, after
the JAX package's tests/test_train_extras.py, tests/test_cli_main.py and
tests/test_checkpoint_durability.py: a two-epoch fit through
``python -m vidsitu_tpu_torch.main --task_type=vb`` and its resume by uid,
strict best metric, reduce-on-plateau, the checkpoint file and its torn
form, the optimizer state across a resume, preemption by SIGTERM sent from
inside a train step, the preempt file's life, ``EvalB`` and its pickle.

A tiny I3D-NL (depth 26, 32 px, 4 frames, non-local blocks at s3 / s4
block 0) on a synthetic split of 4 train and 3 valid segments, float32.
"""

import json
import os
import pickle
import signal

import numpy as np
import pytest
import torch

from vidsitu_tpu.evaluation.evaluators import EvalB as JaxEvalB
from vidsitu_tpu_torch import main as port_main
from vidsitu_tpu_torch.convert.from_flax import flax_to_state_dict
from vidsitu_tpu_torch.data.synth import make_synth_dataset
from vidsitu_tpu_torch.evaluation.evaluators import EvalB
from vidsitu_tpu_torch.train.build import build_learner
from vidsitu_tpu_torch.train.checkpoint import PickleBackend, get_backend
from vidsitu_tpu_torch.train.learner import SmoothenDict, good_format_stats
from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

torch.set_num_threads(1)

TINY = {
    "task_type": "vb", "mdl.mdl_name": "sf_base",
    "mdl.sf_mdl_name": "i3d_r50_nl_8x8", "vid_mdl.resnet.depth": 26,
    "vid_mdl.crop_size": 32, "vid_mdl.num_frames": 4,
    "vid_mdl.nl.location": "[[[]], [[0]], [[0]], [[]]]",
    "train.bs": 2, "train.bsv": 2, "train.nw": 0, "train.nwv": 0,
    "train.dtype": "float32", "train.epochs": 2, "train.lr": 1e-3,
}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_learner")
    paths = make_synth_dataset(root / "data", n_train=4, n_valid=3, n_test=1,
                               with_frames=True, seed=23)
    return paths, root


def mk(env_, uid, **kw):
    paths, root = env_
    return get_cfg_with_overrides(uid, **{
        **paths, **TINY, "misc.tmp_path": str(root / "tmp"), **kw})


def cli_args(env_, uid, *extra):
    paths, root = env_
    kv = {**paths, **TINY, "misc.tmp_path": str(root / "tmp")}
    return [uid, *[f"--{k}={v}" for k, v in kv.items()], *extra]


def test_cli_fits_two_epochs_and_resumes_by_uid(env):
    """main.py: two epochs, each validated; the best model and the pickle
    written; the same uid with train.resume continues from the checkpoint
    with its optimizer state."""
    res = port_main.main(cli_args(env, "fit2", "--device=cpu",
                                  "--train.save_mdl_epochs=True"))
    learner = res["learner"]
    assert learner.model_file.is_file()
    assert (learner.model_epoch_dir / "mdl_ep_2.ckpt").is_file()
    with open(res["pred_dir"] / "valid_0.pkl", "rb") as f:
        preds = pickle.load(f)
    assert sorted(p["ann_idx"] for p in preds) == [0, 1, 2]
    assert all(len(p["pred_vbs_ev"]) == 5 and all(len(v) == 5 for v in
               p["pred_vbs_ev"]) for p in preds)
    _, acc = res["results"]["valid"]
    assert set(acc) == set(EvalB.met_keys)
    log = learner.txt_log_file.read_text()
    assert "epochs  trn_loss  val_loss" in log and "epochs done" in log
    rows = [json.loads(x) for x in (
        learner.txt_log_file.parent.parent / "tracking" / "vsitu_fin_vb"
        / "fit2" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["trn_loss"]) for r in rows)
    # resume epoch 2's checkpoint for one more epoch
    res2 = port_main.main(cli_args(
        env, "fit2", "--device=cpu", "--train.resume=True",
        f"--train.resume_path={learner.model_epoch_dir / 'mdl_ep_2.ckpt'}",
        "--train.epochs=1", "--run_final_val=False"))
    l2 = res2["learner"]
    assert (l2.num_epoch, l2.num_it) == (3, 6)
    assert int(l2.optimizer.state_dict()["state"][0]["step"]) == 6


def test_cli_without_device_raises_where_no_gpu(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_main.main(cli_args(env, "nogpu"))


def test_cli_refuses_what_is_not_ported(env):
    """Nothing is refused now: a ``['data', 'model']`` fit on ``[1, 1]``
    runs on one process (tensor parallelism over a model axis of extent 1
    splits nothing; tests/test_torch_tp_train.py holds larger ones), and
    the orbax backend is ported (its counterpart on
    torch.distributed.checkpoint)."""
    res = port_main.main(cli_args(env, "tp", "--device=cpu",
                                  "--tpu.mesh_axis_names=['data', 'model']",
                                  "--tpu.mesh_shape=[1, 1]"))
    learner = res["learner"]
    assert learner.num_epoch == 1 and learner.split is None
    assert learner.model_file.is_file()
    assert get_backend("orbax").name == "orbax"


def test_checkpoint_keeps_the_dropout_generator(env):
    """The dropout generator lives on the training device, is seeded from
    train.seed, goes into every checkpoint, and a resume restores it."""
    learner = build_learner(mk(env, "drop"), "drop", "cpu")
    gen = learner.dropout_gen
    assert gen.device == learner.device
    assert torch.equal(gen.get_state(), torch.Generator().manual_seed(
        int(learner.cfg.train.seed)).get_state())
    torch.rand(7, generator=gen)  # as a training step would
    state = gen.get_state()
    learner.save_model_dict()
    saved = torch.load(learner.model_file, weights_only=True)
    assert torch.equal(saved["dropout_rng"], state)
    resumed = build_learner(mk(env, "drop", **{"train.resume": True}),
                            "drop", "cpu")
    assert torch.equal(resumed.dropout_gen.get_state(), state)


def test_validation_runs_in_eval_mode_and_returns_to_train(env, monkeypatch):
    learner = build_learner(mk(env, "modes"), "modes", "cpu")
    seen = []
    monkeypatch.setattr(learner, "eval_fn", lambda dl, name, path: (
        seen.append(learner.model.training) or ({"loss": 0.0}, {})))
    learner.model.train()
    learner.validate()
    assert seen == [False] and learner.model.training


def test_overfit_batch_lowers_the_loss(env):
    learner = build_learner(mk(env, "overfit"), "overfit", "cpu")
    losses = learner.overfit_batch(epochs=4, lr=1e-3)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_strict_best_metric_counts_ties_as_no_improvement(env, monkeypatch):
    """A tie with the best metric is no improvement (trn_utils.py:825): no
    save, and it counts toward plateau patience."""
    cfg = mk(env, "tie", **{"train.use_reduce_lr_plateau": True,
                            "train.plateau_patience": 2,
                            "train.plateau_factor": 0.5})
    learner = build_learner(cfg, "tie", "cpu")
    met0 = EvalB.met_keys[0]
    mets = iter([0.5, 0.5, 0.5])
    monkeypatch.setattr(learner, "validate", lambda db=None,
                        write_to_file=False: ({"loss": 0.0},
                                              {met0: next(mets)}, {}))
    saves = []
    orig = learner.save_model_dict
    monkeypatch.setattr(learner, "save_model_dict",
                        lambda path=None: saves.append(path) or orig(path))
    learner.fit(epochs=3, lr=1e-3)
    assert learner.best_met == 0.5 and learner.best_epoch == 1
    assert saves == [None]
    assert learner._lr == pytest.approx(5e-4)
    assert learner.optimizer.param_groups[0]["lr"] == pytest.approx(5e-4)


def test_plateau_reduces_the_lr_in_the_optimizer(env):
    learner = build_learner(mk(env, "plateau"), "plateau", "cpu")
    learner.prepare_optimizer(1e-3)
    learner._set_lr(2.5e-4)
    assert all(g["lr"] == 2.5e-4 for g in learner.optimizer.param_groups)


def test_torn_checkpoint_loads_as_none(tmp_path):
    backend = PickleBackend()
    path = tmp_path / "m.ckpt"
    backend.save(path, {"w": torch.ones(3)}, None, {"num_it": 4})
    assert not (tmp_path / "m.ckpt.tmp").exists()
    loaded = backend.load(path)
    assert loaded["meta"] == {"num_it": 4} and not backend.has_opt(loaded)
    assert torch.equal(loaded["model"]["w"], torch.ones(3))
    path.write_bytes(path.read_bytes()[:40])  # torn mid-write
    assert backend.load(path) is None
    assert backend.load(tmp_path / "missing.ckpt") is None


def test_load_opt_restores_adam_moments_and_lr(env):
    cfg = mk(env, "opt")
    learner = build_learner(cfg, "opt", "cpu")
    learner.fit(epochs=1, lr=1e-3)
    learner._set_lr(3e-4)
    learner.save_model_dict()
    saved = learner.optimizer.state_dict()
    resumed = build_learner(mk(env, "opt", **{"train.resume": True}), "opt",
                            "cpu")
    assert resumed.optimizer is None and resumed._pending_opt is not None
    resumed.prepare_optimizer(1e-3)
    assert resumed._lr == pytest.approx(3e-4)
    got = resumed.optimizer.state_dict()
    for i, st in saved["state"].items():
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got["state"][i][key], st[key]), (i, key)
    assert any(st["exp_avg"].abs().sum() > 0 for st in got["state"].values())
    fresh = build_learner(mk(env, "opt", **{"train.resume": True,
                                            "train.load_opt": False}), "opt",
                          "cpu")
    fresh.prepare_optimizer(1e-3)
    assert fresh._lr == 1e-3 and not fresh.optimizer.state_dict()["state"]
    assert fresh.num_it == learner.num_it


class KillingLoader:
    """The train loader, with SIGTERM sent to this process from inside the
    train step after the first batch (the signal lands during training)."""

    def __init__(self, dl, learner):
        self.dl, self.batch_size = dl, dl.batch_size
        step = learner.train_step

        def train_step(batch):
            out = step(batch)
            if learner.num_it == 0:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        learner.train_step = train_step

    def set_epoch(self, epoch):
        self.dl.set_epoch(epoch)

    def __iter__(self):
        return iter(self.dl)

    def __len__(self):
        return len(self.dl)


def test_sigterm_during_training_checkpoints_and_resumes(env):
    """SIGTERM inside step 1 of a long fit: the step finishes, the state goes
    to the preempt file (not the best-model file), the handler is restored,
    the same uid resumes from it, and the first save that resume reads
    deletes it."""
    learner = build_learner(mk(env, "preempt", **{"train.epochs": 50}),
                            "preempt", "cpu")
    learner.data.train_dl = KillingLoader(learner.data.train_dl, learner)
    prev = signal.getsignal(signal.SIGTERM)
    learner.fit(epochs=50, lr=1e-3)
    assert signal.getsignal(signal.SIGTERM) == prev
    assert learner._preempt_requested and learner.num_it == 1
    assert learner.preempt_file.exists() and not learner.model_file.exists()
    assert "preempted at epoch 0 it 1" in learner.txt_log_file.read_text()
    resumed = build_learner(mk(env, "preempt", **{"train.resume": True}),
                            "preempt", "cpu")
    assert resumed.num_it == 1 and resumed._pending_opt is not None
    assert resumed.preempt_file.exists()  # kept until the next save
    resumed.fit(epochs=1, lr=1e-3)
    assert resumed.num_it == 3 and resumed.model_file.exists()
    assert not resumed.preempt_file.exists()


def test_epoch_dir_save_keeps_the_preempt_file(env):
    learner = build_learner(mk(env, "pkeep"), "pkeep", "cpu")
    learner.num_it = 5
    learner.save_model_dict(learner.preempt_file)
    resumed = build_learner(mk(env, "pkeep", **{"train.resume": True}),
                            "pkeep", "cpu")
    assert resumed.num_it == 5 and resumed._stale_preempt is not None
    resumed.model_epoch_dir.mkdir(parents=True, exist_ok=True)
    resumed.save_model_dict(resumed.model_epoch_dir / "mdl_ep_1.ckpt")
    assert resumed.preempt_file.exists()
    resumed.save_model_dict()
    assert not resumed.preempt_file.exists()


def test_evalb_decodes_like_the_jax_evaluator(env):
    """The same logits give the same pickle entries (float64 softmax,
    top-5 verbs and probabilities, ann_idx) as the JAX package's EvalB."""
    cfg = mk(env, "evalb")
    learner = build_learner(cfg, "evalb", "cpu")
    comm = learner.data.valid_dl.dataset.comm
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, len(comm.vb_id_vocab))).astype(
        np.float32)
    ann = np.array([2, 0])
    want = JaxEvalB.decode_batch(
        type("E", (), {"comm": comm})(), logits, ann)
    assert learner.eval_fn.decode_batch(logits, ann) == want
    loss, acc, _ = learner.validate(write_to_file=True)
    assert loss == {"loss": 0.0} and set(acc) == set(EvalB.met_keys)
    assert all(0.0 <= v <= 1.0 for v in acc.values())
    with open(learner.predictions_dir / "valid_0.pkl", "rb") as f:
        preds = pickle.load(f)
    assert sorted(p["ann_idx"] for p in preds) == [0, 1, 2]
    assert set(preds[0]) == {"pred_vbs_ev", "pred_scores_ev", "ann_idx"}
    assert len(learner.eval_fn.batch_seconds) == 2


def test_smoothing_and_stats_format():
    sm = SmoothenDict(["loss"])
    sm.add_value({"loss": 2.0})
    assert sm.smooth["loss"] == pytest.approx(2.0)
    sm.add_value({"loss": 1.0})
    assert sm.smooth["loss"] == pytest.approx((0.09 * 2 + 0.1) / 0.19)
    assert good_format_stats(["a", "b"], {"a": 0.5}) == "a: 0.5000 b: 0.0000"


def test_sf_pretrained_checkpoint_loads_into_the_backbone(env, tmp_path):
    """mdl.load_sf_pretrained: a PySlowFast-named SFBase checkpoint goes
    through the port's converter into the backbone; the head keeps its
    initial values."""
    from vidsitu_tpu_torch.convert.from_flax import seeded_variables
    from vidsitu_tpu_torch.convert.to_pyslowfast import pysf_state_dict

    fresh = build_learner(mk(env, "pret0"), "pret0", "cpu").model
    seeded = {k: v for k, v in flax_to_state_dict(
        seeded_variables(fresh, 9)).items() if k.startswith("backbone.")}
    ckpt = tmp_path / "sfbase.pth"
    torch.save(pysf_state_dict(seeded, prefix=""), ckpt)
    model = build_learner(mk(env, "pret1", **{
        "mdl.load_sf_pretrained": True,
        "mdl.sf_pretrained_path": str(ckpt)}), "pret1", "cpu").model
    sd = model.state_dict()
    for k, v in seeded.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(sd[k], v), k
    for k in ("proj_head.layers_0.weight", "proj_head.layers_1.bias"):
        assert torch.equal(sd[k], fresh.state_dict()[k])
    with pytest.raises(FileNotFoundError):
        build_learner(mk(env, "pret2", **{
            "mdl.load_sf_pretrained": True,
            "mdl.sf_pretrained_path": str(tmp_path / "none.pth")}),
            "pret2", "cpu")
