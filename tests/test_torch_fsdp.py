"""fsdp (ZeRO-3 over a ``data`` x ``fsdp`` mesh) in the port, on the CPU in
float64 with 4 gloo ranks (tests/torch_dist_child.py), after the JAX
package's tests/test_train_extras.py:459-502.

  * ``tpu.mesh_shape`` over ``tpu.mesh_axis_names`` as the JAX
    ``make_mesh`` reads it (a ``-1`` filled from the world size, a shape
    that does not cover the ranks raises, ``model`` raises); the batch is
    split over data x fsdp;
  * 2 x 2 (``data`` x ``fsdp``, HSDP) and 1 x 4 (``fsdp``) ranks equal one
    process over two Adam steps, for the hand-built I3D-NL of
    tests/vb_train_parity.py (its non-local attention in float64; every
    parameter and BatchNorm statistic) and ``tx_only`` with dropout 0.1:
    the loss, the gradients the update used and the state after it;
  * every parameter is a DTensor sharded along dim 0 over ``fsdp`` and
    replicated over ``data``, and the Learner's lists and its optimizer
    hold those; FSDP2's divide factor is per wrapped module: with the
    blocks' factor left at the world size (the root's at 1), the gradients
    are off (the control);
  * checkpoints written under fsdp resume on one process, mid-cycle of
    ``grad_accum=2`` too: the pickle backend (state gathered whole to rank
    0, Adam's state by parameter name) and the orbax backend (each rank's
    shards);
  * an fsdp fit validates through a whole copy on each rank: its merged
    predictions are one process's, and with one rank's beam search cut
    short (the ranks decode different numbers of steps) it still ends.

Each leaf is held as tests/test_torch_elastic_resume.py holds it (TOL of
its scale): the I3D-NL's BatchNorm sums over 4 ranks round differently
from one process's.
"""

import copy
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_elastic_resume import (
    _check_close,
    _i3d_model,
    _srl_cfg,
    _srl_model,
)
from tests.test_torch_transformer import TINY as SRL_TINY
from tests.torch_dist_child import launch, run_case
from vidsitu_tpu_torch import main as port_main
from vidsitu_tpu_torch.data import get_data
from vidsitu_tpu_torch.data.synth import make_synth_dataset
from vidsitu_tpu_torch.models import video_backbone as tvb
from vidsitu_tpu_torch.models.transformer import EncoderLayer
from vidsitu_tpu_torch.parallel import mesh as M
from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

torch.set_num_threads(1)

TOL = {"i3d": 1e-8, "tx": 1e-9}
LR = 1e-3
MESHES = {"2x2": {"tpu.mesh_shape": "[2, -1]",
                  "tpu.mesh_axis_names": "['data', 'fsdp']"},
          "1x4": {"tpu.mesh_shape": "[-1]",
                  "tpu.mesh_axis_names": "['fsdp']"}}
OVER = {"i3d": {"task_type": "vb", "train.dtype": "float32"},
        "tx": {"task_type": "vb_arg", "mdl.mdl_name": "tx_only",
               "train.dtype": "float32"}}
ACCUM = {**OVER["tx"], "train.grad_accum": 2}


def _vb_batch(seed):
    """4 videos, 5 clips each (folded: 20 clips), 7 classes."""
    rng = np.random.default_rng(seed)
    return {"frms_ev_fast_tensor": rng.integers(
        0, 256, (20, 4, 32, 32, 3), dtype=np.uint8),
        "label_tensor": rng.integers(-1, 7, (4, 5))}


def _split(batch, world):
    """Rank r's rows of a global batch: examples r::world (the sampler's
    layout), a video's 5 clips with it."""
    out = []
    for r in range(world):
        part = {}
        for k, v in batch.items():
            if k.startswith("frms"):
                clips = v.reshape((-1, 5) + v.shape[1:])[r::world]
                part[k] = clips.reshape((-1,) + v.shape[1:])
            else:
                part[k] = v[r::world]
        out.append(part)
    return out


def _case(name, model, cfg, batches, world, **kw):
    return {"name": name, "model": copy.deepcopy(model), "cfg": cfg,
            "lr": LR, "batches": [_split(b, world) for b in batches], **kw}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    paths = make_synth_dataset(tmp / "data", n_train=24, n_valid=2,
                               n_test=1, seed=83)
    cfg = _srl_cfg(paths, tmp / "cfg", **{"train.bs": 4})
    tx_batches = list(get_data(cfg).train_dl)
    assert len(tx_batches) == 6 and len(tx_batches[0]["vseg_idx"]) == 4
    models = {"i3d": _i3d_model(), "tx": _srl_model(cfg, dropout=True)}
    batches = {"i3d": [_vb_batch(k) for k in range(4)], "tx": tx_batches}
    ckpt = tmp / "ckpt"
    ckpt.mkdir()
    outs = {}
    for mesh, axes in MESHES.items():
        cases = {f"{n}_{mesh}": _case(n, models[n], {**OVER[n], **axes},
                                      batches[n][:2], 4) for n in models}
        if mesh == "2x2":
            # the 2 x 2 I3D-NL run saves through the orbax backend
            cases["i3d_2x2"]["cfg"]["train.ckpt_backend"] = "orbax"
            cases["i3d_2x2"]["save"] = str(ckpt / "i3d_2x2")
            cases["accum_save"] = _case(
                "tx", models["tx"], {**ACCUM, **axes}, tx_batches[:3], 4,
                save=str(ckpt / "accum_2x2.ckpt"))
            cases["control"] = _case("tx", models["tx"],
                                     {**OVER["tx"], **axes}, tx_batches[:1],
                                     4, divide=4)
        else:
            cases["accum_save"] = _case(
                "tx", models["tx"], {**ACCUM, **axes,
                                     "train.ckpt_backend": "orbax"},
                tx_batches[:3], 4, save=str(ckpt / "accum_1x4"))
        files = []
        for key, case in cases.items():
            case["name"] = key
            path = tmp / f"{key}.pt"
            torch.save(case, path)
            files.append(str(path))
        outs[mesh], _ = launch("steps", {"cases": files,
                                         "tmp": str(tmp / mesh),
                                         "whole_on_rank0": True},
                               tmp / mesh, nproc=4, timeout=300)
        for path in files:
            Path(path).unlink()  # the models' copies: 0.1 GB each
    one_tmp = str(tmp / "one")
    one = {n: run_case(_case(n, models[n], OVER[n], batches[n][:2], 1), 0,
                       one_tmp) for n in models}
    one["tx_1"] = run_case(_case("tx", models["tx"], OVER["tx"],
                                 tx_batches[:1], 1), 0, one_tmp)
    one["i3d_4"] = run_case(_case("i3d", models["i3d"], OVER["i3d"],
                                  batches["i3d"], 1), 0, one_tmp)
    one["accum_6"] = run_case(_case("tx", models["tx"], ACCUM, tx_batches,
                                    1), 0, one_tmp)
    orbax = {"train.ckpt_backend": "orbax"}
    one["i3d_resume"] = run_case(_case(
        "i3d", models["i3d"], {**OVER["i3d"], **orbax}, batches["i3d"][2:],
        1, resume=str(ckpt / "i3d_2x2")), 0, one_tmp)
    one["accum_resume_pickle"] = run_case(_case(
        "tx", models["tx"], ACCUM, tx_batches[3:], 1,
        resume=str(ckpt / "accum_2x2.ckpt")), 0, one_tmp)
    one["accum_resume_orbax"] = run_case(_case(
        "tx", models["tx"], {**ACCUM, **orbax}, tx_batches[3:], 1,
        resume=str(ckpt / "accum_1x4")), 0, one_tmp)
    return {"one": one, "outs": outs, "ckpt": ckpt, "tmp": tmp,
            "models": models}


@pytest.mark.parametrize("shape,world,want", [
    ("[2, -1]", 4, (2, 2)), ("[-1]", 4, (4,)), ("[-1, 2]", 4, (2, 2)),
    ("[1, 1]", 1, (1, 1)), ("[2, -1]", 3, None), ("[3, 3]", 4, None),
    ("[-1, -1]", 4, None), ("[4]", 4, None)])
def test_mesh_shape_rule(shape, world, want):
    """The JAX ``make_mesh``'s reading of ``tpu.mesh_shape`` (a ``-1``
    filled from the device count; a product other than it raises), over
    ``data`` x ``fsdp`` (``[4]`` names one size for two axes)."""
    n = 1 if shape == "[-1]" else 2
    axes = "['data', 'fsdp']" if n == 2 else "['fsdp']"
    cfg = get_cfg_with_overrides("t", **{"tpu.mesh_shape": shape,
                                         "tpu.mesh_axis_names": axes})
    if want is None:
        with pytest.raises(ValueError):
            M.mesh_shape(cfg, world)
    else:
        assert M.mesh_shape(cfg, world) == want


def test_fsdp_wraps_the_blocks(runs):
    i3d = runs["models"]["i3d"]
    blocks = M.fsdp_blocks(i3d)
    assert {type(b) for b in blocks} == {tvb.Bottleneck, tvb.NonLocalBlock}
    assert len(blocks) == 6 + 2
    tx = M.fsdp_blocks(runs["models"]["tx"])
    assert len(tx) == 2 and all(isinstance(b, EncoderLayer) for b in tx)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("name", ["i3d", "tx"])
def test_fsdp_equals_one_process(runs, mesh, name):
    want = runs["one"][name]
    outs = runs["outs"][mesh]
    for r, out in enumerate(outs):
        got = out[f"{name}_{mesh}"]
        assert len(got["losses"]) == 2
        for a, b in zip(got["losses"], want["losses"]):
            assert abs(a - b) <= TOL[name] * abs(b), (a, b)
        if r == 0:  # the gathered tensors, the same on every rank
            _check_close(got["grads"], want["grads"], TOL[name])
            _check_close(got["state_dict"], want["state_dict"], TOL[name])
        layout = got["layout"]
        assert layout["learner_params_sharded"]
        place = ["R", "S(0)"] if mesh == "2x2" else ["S(0)"]
        assert all(p == place for p in layout["placements"].values()), (
            layout["placements"])
    if name == "i3d":
        stats = [k for k in want["state_dict"] if "running_var" in k]
        assert stats and all(not torch.equal(
            want["state_dict"][k], runs["models"]["i3d"].state_dict()[k])
            for k in stats)
    # the shards: dim 0 over the fsdp extent, padded where it does not
    # divide (a 7-class head's bias: 2, 2, 2, 1 rows over 4 ranks)
    fsdp = 2 if mesh == "2x2" else 4
    rows = [o[f"{name}_{mesh}"]["layout"]["local_rows"] for o in outs]
    for key, full in want["state_dict"].items():
        if key in rows[0] and full.dim():
            n = full.shape[0]
            chunk = -(-n // fsdp)
            for r, rr in enumerate(rows):
                f = r % fsdp
                assert rr[key] == max(0, min(chunk, n - f * chunk)), key


def test_divide_factor_is_set_on_every_wrapped_module(runs):
    """The control: the blocks' factor back at FSDP2's default (the world
    size), the root's at 1. A block's gradient is then a quarter of the
    sum, the root's own parameters' the sum."""
    got = runs["outs"]["2x2"][0]["control"]["grads"]
    want = runs["one"]["tx_1"]["grads"]
    block = "decoder.layers_0.ffn.fc1.weight"
    root = "decoder.embed_tokens.weight"
    _check_close({root: got[root]}, {root: want[root]}, TOL["tx"])
    _check_close({block: 4 * got[block]}, {block: want[block]}, TOL["tx"])
    with pytest.raises(AssertionError):
        _check_close(got, want, TOL["tx"])


@pytest.mark.parametrize("tag", ["i3d_resume", "accum_resume_pickle",
                                 "accum_resume_orbax"])
def test_fsdp_checkpoint_resumes_on_one_process(runs, tag):
    one = runs["one"]
    name = "i3d" if tag.startswith("i3d") else "tx"
    straight = one["i3d_4"] if name == "i3d" else one["accum_6"]
    resumed = one[tag]
    assert resumed["num_it"] == straight["num_it"]
    n = len(resumed["losses"])
    for a, b in zip(resumed["losses"], straight["losses"][-n:]):
        assert abs(a - b) <= TOL[name] * abs(b), (a, b)
    _check_close(resumed["state_dict"], straight["state_dict"], TOL[name])
    log = (runs["tmp"] / "one" / "txt_logs" / "t.txt").read_text()
    assert "resumed a 4-process checkpoint on 1 processes" in log


def test_pickle_checkpoint_under_fsdp_holds_whole_tensors(runs):
    saved = torch.load(runs["ckpt"] / "accum_2x2.ckpt", weights_only=True)
    model = runs["models"]["tx"]
    shapes = {n: p.shape for n, p in model.named_parameters()}
    assert saved["world_size"] == 4 and saved["accum_count"] == 1
    for n, v in saved["model_state_dict"].items():
        assert v.shape == model.state_dict()[n].shape, n
    opt = saved["optimizer_state_dict"]
    assert set(opt["state"]) == set(shapes)
    assert opt["param_groups"][0]["params"] == list(shapes)
    for n, st in opt["state"].items():
        assert st["exp_avg"].shape == shapes[n], n
    assert {n: g.shape for n, g in saved["accum_grads"].items()} == shapes
    d = runs["ckpt"] / "accum_1x4"
    assert (d / "LIVE").read_text().strip() == "tree.g0"
    # each of the 4 ranks wrote its shards
    assert len(list((d / "tree.g0").glob("*.distcp"))) == 4


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    """An fsdp fit at lr 0 (its weights stay flax's initial values) on 2
    ranks, twice (the second with rank 1's beam search cut to 2 steps), and
    the same fit on one process."""
    root = tmp_path_factory.mktemp("fsdp_eval")
    paths = make_synth_dataset(root / "data", n_train=4, n_valid=4,
                               n_test=1, seed=89)
    kv = {**paths, **SRL_TINY, "task_type": "vb_arg",
          "mdl.mdl_name": "tx_only", "train.dtype": "float32",
          "train.bs": 2, "train.bsv": 2, "train.nw": 0, "train.nwv": 0,
          "gen.max_len_b": 6, "train.lr": 0.0, "run_final_val": False,
          "train.epochs": 1, "misc.tmp_path": str(root / "tmp")}
    fsdp = ["--tpu.mesh_shape=[-1]", "--tpu.mesh_axis_names=['fsdp']"]

    def argv(uid, *extra):
        return [uid, *[f"--{k}={v}" for k, v in kv.items()], "--device=cpu",
                *extra]

    outs, _ = launch("main", {"runs": [argv("a", *fsdp), argv("b", *fsdp)],
                              "short_decode": {"rank": 1, "run": 1}},
                     root / "fsdp")
    one = port_main.main(argv("one"))
    return {"outs": outs, "one": one, "root": root}


def test_fsdp_fit_validates_through_a_whole_copy(evals):
    outs, one = evals["outs"], evals["one"]
    assert all(o["runs"][0]["sharded"] for o in outs)
    assert not one["learner"].sharded
    pred = evals["root"] / "tmp" / "predictions"

    def load(uid):
        with open(pred / uid / "valid_0.pkl", "rb") as f:
            return pickle.load(f)

    assert load("a") == load("one")
    assert outs[0]["runs"][0]["results"] == outs[1]["runs"][0]["results"]


def test_ranks_that_decode_different_steps_do_not_wait(evals):
    steps = [o["runs"][1]["decode_steps"] for o in evals["outs"]]
    assert steps[0] != steps[1] and max(steps[1]) == 3, steps
    assert all(o["runs"][1]["num_epoch"] == 1 for o in evals["outs"])
