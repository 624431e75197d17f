"""The training loop's spans (vidsitu_tpu_torch/train/learner.py): each
step of ``Learner.train_epoch`` runs in ``vidsitu.input`` (the next batch
fetched, folded and sent), ``vidsitu.forward`` and ``vidsitu.backward``, and
each update in torch's ``Optimizer.step#Adam.step``, in that order; the
stem runs in ``vidsitu.stem`` inside the forward; the spans change nothing
a step computes; the trace that ``tpu.profile`` writes holds the spans of
the steps it covers; the benchmark's ``stem_device_ms.train`` reader counts
the kernels launched inside the stem spans of a made-up trace.

A tiny I3D-NL (depth 26, 32 px, 4 frames, non-local blocks at s3 / s4
block 0) on a synthetic split, float32, two videos a step, on the CPU.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from port_bench import trace as T
from port_bench.harness import read_metrics
from vidsitu_tpu_torch.data.synth import make_synth_dataset
from vidsitu_tpu_torch.train.build import build_learner
from vidsitu_tpu_torch.train.learner import SmoothenDict
from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

torch.set_num_threads(1)

INPUT, FORWARD, BACKWARD = "vidsitu.input", "vidsitu.forward", "vidsitu.backward"
STEM = "vidsitu.stem"
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


def test_each_forward_runs_the_stem_in_one_stem_span(split):
    """One ``vidsitu.stem`` span a step (the I3D-NL's one stem), inside
    that step's ``vidsitu.forward``; the other spans keep their counts."""
    steps = 3
    learner = _learner(split, steps, "spans_stem")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        learner.train_epoch(SmoothenDict(learner.loss_keys))
    spans = {n: sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events() if e.name == n)
             for n in NAMES + (STEM,)}
    assert len(spans[STEM]) == len(spans[FORWARD]) == len(spans[BACKWARD]) == steps
    assert len(spans[ADAM]) == steps
    assert len(spans[INPUT]) == steps + 1
    for (sa, se), (fa, fe) in zip(spans[STEM], spans[FORWARD]):
        assert fa <= sa < se <= fe


def _x(name, cat, ts_us, dur_us, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts_us, "dur": dur_us,
            "tid": 1, "args": args}


def _kernel(name, a, b, corr, launched):
    return [_x(name, "kernel", a, b - a, correlation=corr),
            _x("cudaLaunchKernel", "cuda_runtime", launched, 1, correlation=corr)]


def _stem_trace(with_stem=True):
    """Two steps between step-end copies at 100, 200 and 300 us; each
    forward (110-150, 210-250) holds a stem span (112-130, 212-230).
    Counted: the kernel launched in each stem (131-141, 231-236). Not
    counted: the kernels launched in the forward after the stem (141-149,
    236-246) or in the backward (150-160), and one with no launch record
    (160-165)."""
    ev = [_x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", a, 5)
          for a in (95, 195, 295)]
    ev += [_x(FORWARD, "user_annotation", 110, 40), _x(BACKWARD, "user_annotation", 150, 20),
           _x(FORWARD, "user_annotation", 210, 40), _x(BACKWARD, "user_annotation", 250, 20)]
    if with_stem:
        ev += [_x(STEM, "user_annotation", 112, 18), _x(STEM, "user_annotation", 212, 18)]
    ev += _kernel("cutlass_tensorop_bf16_fprop", 131, 141, 1, launched=115)
    ev += _kernel("batch_norm_collect_statistics", 141, 149, 2, launched=135)
    ev += _kernel("conv_wgrad", 150, 160, 3, launched=152)
    ev += [_x("fill", "kernel", 160, 5, correlation=4)]
    ev += _kernel("cutlass_tensorop_bf16_fprop", 231, 236, 5, launched=220)
    ev += _kernel("batch_norm_collect_statistics", 236, 246, 6, launched=232)
    return T.Trace(ev)


def test_the_stem_reader_counts_the_kernels_launched_in_the_stem_spans():
    counts = {"flops_per_step": 1.0, "attn_least_s_per_step": 1e-6}
    m = read_metrics("train", _stem_trace(), counts)
    assert m["stem_device_ms.train"] == (pytest.approx((10 + 5) * 1e-3 / 2), "ms/step")
    assert m["forward_device_ms.train"][0] == pytest.approx((18 + 15) * 1e-3 / 2)
    # a program without the stem span (the parent's): silent, the rest read
    m = read_metrics("train", _stem_trace(with_stem=False), counts)
    assert "stem_device_ms.train" not in m
    assert m["forward_device_ms.train"][0] == pytest.approx((18 + 15) * 1e-3 / 2)
