"""The port's mid-run resize (``Learner.request_resize``), on the CPU in
float64 with gloo ranks (tests/torch_dist_child.py, mode ``fit``): the
counterpart of the JAX package's in-process mesh resize
(tests/test_elastic_resume.py:136, 253).

A fit is asked to shrink at its first epoch boundary: the ranks past the
new size leave ``fit`` there, the survivors carry the whole state (model,
Adam's moments, BatchNorm statistics, a ``grad_accum`` cycle in flight,
the dropout generator, the counters) onto a mesh rebuilt over them and fit
epoch 2. A step does not depend on the number of ranks, so the resized run
must equal the straight run on the first ranks and a save on them resumed
on the survivors, within test_torch_elastic_resume.py's ``TOL`` of each
leaf's scale:

  * ``fsdp``: the SRL ``tx_only`` model with every dropout at 0.1, 4 ranks
    on a fixed ``data`` x ``fsdp`` ``[2, 2]`` mesh resized to 2, where that
    shape does not tile 2: a pure ``data`` mesh ``[2]`` (FSDP2 gone);
  * ``tp``: the same model on ``data`` x ``model`` ``[-1, 2]``: ``[2, 2]``
    resized to ``[1, 2]``, re-split; its validation decodes on the reorder
    route, one row gather a decode step on every rank, on half the heads;
  * ``i3d``: the hand-built I3D-NL of tests/vb_train_parity.py at flax's
    initial values on 2 ranks resized to 1, its BatchNorm statistics too.

The SRL cases take ``train.grad_accum=2`` over 3 steps an epoch, so a cycle
is in flight at the resize. A resize whose data extent does not divide the
eval batch raises on every rank at the boundary (no rank hangs or leaves),
and a grow raises at the request.
"""

import copy

import pytest
import torch

from tests.test_torch_elastic_resume import (
    TOL,
    _check_close,
    _srl_cfg,
    _srl_model,
)
from tests.test_torch_transformer import TINY as SRL_TINY
from tests.torch_dist_child import attention_f64, fit_case, launch
from tests.vb_train_parity import MODELS
from vidsitu_tpu_torch.data import build_comm
from vidsitu_tpu_torch.data.synth import make_synth_dataset
from vidsitu_tpu_torch.models import selector as psel
from vidsitu_tpu_torch.models import video_backbone as tvb
from vidsitu_tpu_torch.models.vb_models import VbVideoModel
from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

torch.set_num_threads(1)

LR = 1e-3
EPOCHS = 2
# the reorder route at beam 3: one row gather a decode step
DECODE = {"gen.beam_size": 3, "gen.max_len_b": 6, "tpu.ancestry_beam": False}
RATES = {"tx_dec.attention_dropout": 0.1, "tx_dec.activation_dropout": 0.1}
SRL = {"train.bs": 4, "train.bsv": 4, "train.grad_accum": 2,
       "train.save_mdl_epochs": True, **DECODE, **RATES}
MESH = {"fsdp": ("[2, 2]", "['data', 'fsdp']"),
        "tp": ("[-1, 2]", "['data', 'model']"),
        "data": ("[-1]", "['data']")}
# the meshes each run takes: before the resize, after it
SHAPES = {"fsdp": ({"data": 2, "fsdp": 2}, {"data": 2}),
          "tp": ({"data": 2, "model": 2}, {"data": 1, "model": 2}),
          "i3d": ({"data": 2}, {"data": 1})}


def _axes(mesh):
    shape, names = MESH[mesh]
    return {"tpu.mesh_shape": shape, "tpu.mesh_axis_names": names}


def _i3d_model(num_classes):
    """The hand-built I3D-NL at flax's initial values, every product in
    float64, with as many verbs as the synthetic vocabulary."""
    model = VbVideoModel(tvb.VideoCfg(**MODELS["i3d_nl"],
                                      dtype=torch.float64),
                         num_classes=num_classes)
    for m in model.modules():
        if isinstance(m, tvb.NonLocalBlock):
            m.attention = attention_f64
    return psel.init_model_variables(model, 11).double()


def _case(name, model, cfg, **kw):
    return {"name": name, "model": copy.deepcopy(model), "cfg": cfg,
            "lr": LR, "epochs": EPOCHS, **kw}


def _launch(cases, tmp, nproc):
    """Mode ``fit`` over ``cases`` (in order; a resize last) on ``nproc``
    gloo ranks."""
    tmp.mkdir(parents=True, exist_ok=True)
    files = []
    for case in cases:
        path = tmp / f"{case['name']}.pt"
        torch.save(case, path)
        files.append(str(path))
    outs, _ = launch("fit", {"cases": files, "tmp": str(tmp / "ranks")},
                     tmp, nproc=nproc, timeout=300)
    return outs


def _ckpt(tmp, uid):
    return str(tmp / "ranks" / "model_epochs" / uid / "mdl_ep_1.ckpt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resize")
    srl_paths = make_synth_dataset(tmp / "srl", n_train=12, n_valid=4,
                                   n_test=1, seed=71)
    vb_paths = make_synth_dataset(tmp / "vb", n_train=4, n_valid=2,
                                  n_test=1, seed=73, with_frames=True)
    cfg = _srl_cfg(srl_paths, tmp / "cfg", **SRL)
    tx = _srl_model(cfg, dropout=True)
    srl = {**srl_paths, **SRL_TINY, **SRL, "task_type": "vb_arg",
           "mdl.mdl_name": "tx_only", "train.nw": 0, "train.nwv": 0,
           "train.dtype": "float32"}
    vb = {**vb_paths, "task_type": "vb", "mdl.sf_mdl_name": "i3d_r50_nl_8x8",
          "vid_mdl.crop_size": 32, "vid_mdl.num_frames": 4,
          "train.bs": 2, "train.bsv": 2, "train.nw": 0, "train.nwv": 0,
          "train.dtype": "float32"}
    vb_cfg = get_cfg_with_overrides("i3d", **vb)
    i3d = _i3d_model(len(build_comm(vb_cfg).vb_id_vocab))

    fsdp = _launch([
        # bs 12 divides 4 and 3 ranks, bsv 4 only 4: the resize raises
        _case("bad", tx, {**srl, **_axes("fsdp"), "train.bs": 12},
              grow=4, resize=3, epochs=1),
        _case("fsdp_straight", tx, {**srl, **_axes("fsdp")}),
        _case("fsdp_resized", tx, {**srl, **_axes("fsdp")}, resize=2),
    ], tmp / "fsdp", 4)
    tp = _launch([
        _case("tp_straight", tx, {**srl, **_axes("tp")}),
        _case("tp_resized", tx, {**srl, **_axes("tp")}, resize=2),
    ], tmp / "tp", 4)
    # the first epoch's checkpoints resumed on the survivors' meshes; the
    # I3D-NL straight on 2 ranks, then resized to 1
    two = _launch([
        _case("fsdp_resumed", tx, {**srl, **_axes("data")}, epochs=1,
              resume=_ckpt(tmp / "fsdp", "fsdp_straight")),
        _case("tp_resumed", tx, {**srl, **_axes("tp")}, epochs=1,
              resume=_ckpt(tmp / "tp", "tp_straight")),
        # only the straight run keeps its epochs (349 MB a checkpoint)
        _case("i3d_straight", i3d, {**vb, "train.save_mdl_epochs": True}),
        _case("i3d_resized", i3d, vb, resize=1),
    ], tmp / "two", 2)
    i3d_resumed = fit_case(_case(
        "i3d_resumed", i3d, vb, epochs=1,
        resume=_ckpt(tmp / "two", "i3d_straight")), str(tmp / "one"))
    return {"fsdp": fsdp, "tp": tp, "two": two, "i3d_resumed": i3d_resumed,
            "i3d_init": i3d.state_dict()}


def _runs(runs, kind):
    """(straight runs by rank, resized by rank, resumed by rank)."""
    if kind == "i3d":
        two = runs["two"]
        return ([o["i3d_straight"] for o in two],
                [o["i3d_resized"] for o in two], [runs["i3d_resumed"]])
    return ([o[f"{kind}_straight"] for o in runs[kind]],
            [o[f"{kind}_resized"] for o in runs[kind]],
            [o[f"{kind}_resumed"] for o in runs["two"]])


KINDS = ("fsdp", "tp", "i3d")


@pytest.mark.parametrize("kind", KINDS)
def test_resized_fit_equals_the_straight_run(runs, kind):
    """The survivors' epoch 2 after the resize is the straight run's epoch 2
    on the first ranks: every step's global loss and every leaf (the
    BatchNorm statistics of the I3D-NL among them) within TOL."""
    tol = TOL["i3d_nl" if kind == "i3d" else "tx_drop"]
    straight, resized, _ = _runs(runs, kind)
    before, after = SHAPES[kind]
    survivors = [r for r in resized if not r["left"]]
    assert len(survivors) == len(resized) // 2
    want = straight[0]
    assert want["error"] is None and want["num_epoch"] == EPOCHS
    for res in resized:
        assert res["error"] is None, res["error"]
        assert res["at_resize"]["num_epoch"] == 1
        for a, b in zip(res["losses"], want["losses"]):
            assert abs(a - b) <= tol * abs(b), (a, b)
    for res in survivors:
        assert res["mesh"] == after and res["world"] == len(survivors)
        assert res["num_it"] == want["num_it"]
        assert len(res["losses"]) == len(want["losses"])
        _check_close(res["state_dict"], want["state_dict"], tol)
        assert torch.equal(res["rng"], want["rng"])
    log = survivors[0]["log"]
    assert f"elastic resize at epoch 1: {before} -> {after}" in log, log
    if kind == "i3d":
        stats = [k for k in want["state_dict"] if "running_var" in k]
        init = runs["i3d_init"]
        assert stats and all(not torch.equal(want["state_dict"][k], init[k])
                             for k in stats)


@pytest.mark.parametrize("kind", KINDS)
def test_resized_fit_equals_save_and_resume(runs, kind):
    """The same as a checkpoint of epoch 1 on the first ranks resumed on the
    survivors' number (and mesh) for epoch 2."""
    tol = TOL["i3d_nl" if kind == "i3d" else "tx_drop"]
    _, resized, resumed = _runs(runs, kind)
    res = next(r for r in resized if not r["left"])
    for want in resumed:
        assert want["error"] is None and want["num_epoch"] == EPOCHS
        for a, b in zip(res["losses"][-len(want["losses"]):],
                        want["losses"]):
            assert abs(a - b) <= tol * abs(b), (a, b)
        _check_close(res["state_dict"], want["state_dict"], tol)


@pytest.mark.parametrize("kind", KINDS)
def test_ranks_past_the_new_size_leave_at_the_boundary(runs, kind):
    """The ranks >= n train epoch 1 with the others, then leave ``fit``;
    the survivors load their new shards (data coordinates of the new
    extent) and fit epoch 2."""
    straight, resized, _ = _runs(runs, kind)
    n = len(resized) // 2
    per_epoch = len(straight[0]["losses"]) // EPOCHS
    for r, res in enumerate(resized):
        assert res["left"] == (r >= n)
        want = EPOCHS * per_epoch if r < n else per_epoch
        assert len(res["losses"]) == want
        assert len(res["metrics"]) == (EPOCHS if r < n else 1)
    after = SHAPES[kind][1]
    extent = after["data"]
    assert [r["data"] for r in resized[:n]] == [
        [r // (n // extent), extent] for r in range(n)]


def test_grad_accum_cycle_in_flight_survives_the_resize(runs):
    """3 steps an epoch at grad_accum 2: one step of a cycle is in flight at
    the boundary; its summed gradients reach the survivors (the first
    update of epoch 2 completes it), so the runs above agree."""
    for kind in ("fsdp", "tp"):
        for res in _runs(runs, kind)[1]:
            assert res["at_resize"]["accum_count"] == 1
            assert res["at_resize"]["world"] == 4


def test_tp_resize_decodes_split_on_the_survivors(runs):
    """``[2, 2]`` -> ``[1, 2]``: the survivors' model is split again over
    their model axis (half the heads); the validation of epoch 2 takes one
    row gather a decode step on each survivor, on 2-head caches (4 heads
    split by 2), as the straight run's does."""
    straight, resized, _ = _runs(runs, "tp")
    for out, want in zip(resized[:2], straight[:2]):
        assert out["split"] and out["split"] == want["split"]
        after = [h for e, h in out["gathers"] if e == 1]
        assert after and all(h == [2] for h in after)
        assert len(after) == sum(out["steps"])
        assert len(after) == len([1 for e, _ in want["gathers"] if e == 1])
        before = [h for e, h in out["gathers"] if e == 0]
        assert len(before) == sum(out["at_resize"]["steps"]) > 0
    for out in resized[2:]:
        assert out["left"] and all(e == 0 for e, _ in out["gathers"])


def test_indivisible_eval_batch_raises_on_every_rank(runs):
    """bsv 4 on the 3 ranks of ``[2, 2]`` resized to 3 (a ``data`` mesh:
    that shape does not tile 3): every rank raises at the boundary, with
    the JAX message's substance, and none leaves; a grow raises at the
    request."""
    for out in runs["fsdp"]:
        bad = out["bad"]
        assert "eval batch train.bsv=4 is not divisible by the resized " \
            "mesh's 3-way data-parallel share" in bad["error"], bad["error"]
        assert not bad["left"] and bad["world"] == 4
        assert bad["at_resize"]["world"] == 4
        assert "a resize only shrinks" in bad["grow"], bad["grow"]
