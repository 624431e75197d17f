"""The training loop's spans (vidsitu_tpu_torch/train/learner.py): each
step of ``Learner.train_epoch`` runs in ``vidsitu.input`` (the next batch
fetched, folded and sent), ``vidsitu.forward`` and ``vidsitu.backward``, and
each update in torch's ``Optimizer.step#Adam.step``, in that order; the
spans change nothing a step computes; the trace that ``tpu.profile`` writes
holds the spans of the steps it covers.

A tiny I3D-NL (depth 26, 32 px, 4 frames, non-local blocks at s3 / s4
block 0) on a synthetic split, float32, two videos a step, on the CPU.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vidsitu_tpu_torch.data.synth import make_synth_dataset
from vidsitu_tpu_torch.train.build import build_learner
from vidsitu_tpu_torch.train.learner import SmoothenDict
from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

torch.set_num_threads(1)

INPUT, FORWARD, BACKWARD = "vidsitu.input", "vidsitu.forward", "vidsitu.backward"
ADAM = "Optimizer.step#Adam.step"
NAMES = (INPUT, FORWARD, BACKWARD, ADAM)
TINY = {
    "task_type": "vb", "mdl.mdl_name": "sf_base",
    "mdl.sf_mdl_name": "i3d_r50_nl_8x8", "vid_mdl.resnet.depth": 26,
    "vid_mdl.crop_size": 32, "vid_mdl.num_frames": 4,
    "vid_mdl.nl.location": "[[[]], [[0]], [[0]], [[]]]",
    "train.bs": 2, "train.bsv": 2, "train.nw": 0, "train.nwv": 0,
    "train.dtype": "float32", "train.lr": 1e-3,
}


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """``split(steps)``: the config paths of a split of ``steps`` train
    batches, made once each."""
    made = {}

    def get(steps):
        if steps not in made:
            root = tmp_path_factory.mktemp(f"spans{steps}")
            made[steps] = (make_synth_dataset(
                root / "data", n_train=2 * steps, n_valid=2, n_test=1,
                with_frames=True, seed=31), root)
        return made[steps]
    return get


def _learner(split, steps, uid, **kw):
    paths, root = split(steps)
    cfg = get_cfg_with_overrides(uid, **{
        **paths, **TINY, "misc.tmp_path": str(root / "tmp"), **kw})
    learner = build_learner(cfg, uid, "cpu")
    learner.prepare_optimizer(1e-3)
    return learner


def _epoch(learner):
    """One epoch: (each step's loss, the epoch's mean loss, the model's
    state after it)."""
    losses, step = [], learner.train_step

    def recorded(batch):
        loss = step(batch)
        losses.append(loss.clone())
        return loss

    learner.train_step = recorded
    mean = learner.train_epoch(SmoothenDict(learner.loss_keys))["loss"]
    state = {n: t.detach().clone() for n, t in learner.model.state_dict().items()}
    return losses, mean, state


@pytest.mark.parametrize("grad_accum,steps", [(1, 3), (2, 4)],
                         ids=["every_step", "grad_accum_2"])
def test_each_step_runs_in_its_spans_and_they_change_nothing(
        split, grad_accum, steps):
    kw = {"train.grad_accum": grad_accum}
    traced = _learner(split, steps, f"spans_on{grad_accum}", **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _epoch(traced)
    spans = {n: sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events() if e.name == n) for n in NAMES}
    # one forward and one backward a step, one update every grad_accum
    # steps; the input span of each step, and a last one that found the
    # loader empty
    assert len(spans[FORWARD]) == len(spans[BACKWARD]) == steps
    assert len(spans[ADAM]) == steps // grad_accum
    assert len(spans[INPUT]) == steps + 1
    for i in range(steps):
        (ia, ie), (fa, fe), (ba, be) = (spans[n][i] for n in (INPUT, FORWARD, BACKWARD))
        assert ia < ie <= fa < fe <= ba < be <= spans[INPUT][i + 1][0]
        if (i + 1) % grad_accum == 0:
            aa, ae = spans[ADAM][i // grad_accum]
            assert be <= aa < ae <= spans[INPUT][i + 1][0]
    # bitwise the run of a Learner that no profiler watches
    off = _epoch(_learner(split, steps, f"spans_off{grad_accum}", **kw))
    assert len(on[0]) == len(off[0]) == steps
    assert all(torch.equal(a, b) for a, b in zip(on[0], off[0]))
    assert on[1] == off[1]
    assert on[2].keys() == off[2].keys()
    assert all(torch.equal(on[2][n], off[2][n]) for n in on[2])


def test_the_operators_profile_holds_the_spans_of_its_steps(split):
    """``tpu.profile``: epoch 0's steps 1 to ``tpu.profile_steps``, each
    with its four spans."""
    learner = _learner(split, 3, "spans_prof", **{"tpu.profile": True,
                                                  "tpu.profile_steps": 2})
    learner.train_epoch(SmoothenDict(learner.loss_keys))
    path = learner.cfg.misc.tmp_path + "/profile/spans_prof/trace.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = {n: sum(1 for e in events if e.get("ph") == "X" and e["name"] == n
                     and e.get("cat") == "user_annotation") for n in NAMES}
    assert counts == {n: 2 for n in NAMES}
