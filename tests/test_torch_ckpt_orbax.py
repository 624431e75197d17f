"""``ckpt_backend=orbax`` in the port: ``train/checkpoint.py:DcpBackend`` on
``torch.distributed.checkpoint``, after the JAX package's
tests/test_checkpoint_durability.py and tests/test_elastic_resume.py:171,
229.

  * saves alternate between ``tree.g0`` and ``tree.g1`` behind a ``LIVE``
    pointer published after the commit: the previous generation survives
    the next save's window, a resumed process does not overwrite the live
    generation, a legacy single ``tree`` loads, unknown meta keys are
    refused;
  * a checkpoint written by one process resumes on 2 data-parallel gloo
    ranks (tests/torch_dist_child.py), with dropout on, and equals the
    straight 2-rank run; the 2 x 2 fsdp -> one process direction is in
    tests/test_torch_fsdp.py.
"""

import copy
from pathlib import Path

import pytest
import torch

from tests.test_torch_elastic_resume import (
    _check_close,
    _i3d_model,
    _srl_cfg,
    _srl_model,
    _vb_split,
)
from tests.torch_dist_child import launch, run_case
from tests.vb_train_parity import _batch
from vidsitu_tpu_torch.data import get_data
from vidsitu_tpu_torch.data.synth import make_synth_dataset
from vidsitu_tpu_torch.train.checkpoint import DcpBackend, get_backend

torch.set_num_threads(1)

TOL = {"i3d": 1e-8, "tx": 1e-9}
LR = 1e-3
ORBAX = {"train.ckpt_backend": "orbax", "train.dtype": "float32"}
OVER = {"i3d": {"task_type": "vb", **ORBAX},
        "tx": {"task_type": "vb_arg", "mdl.mdl_name": "tx_only", **ORBAX}}


def _meta(it):
    return {"num_it": it, "num_epoch": 0,
            "dropout_rng": torch.Generator().manual_seed(it).get_state()}


def _save(be, path, value, it):
    be.save(path, {"w": torch.full((4,), float(value))}, None, _meta(it))


def _loaded(path):
    out = DcpBackend().load(path)
    return out["meta"]["num_it"], out["model"]["w"]


def test_previous_generation_survives_next_save_window(tmp_path):
    path = tmp_path / "g.ckpt"
    be = get_backend("orbax")
    _save(be, path, 1.0, 1)
    be.wait()  # commit + publish generation 1
    _save(be, path, 2.0, 2)
    # the window: save 2 not waited on, its pointer not published; a fresh
    # process restores save 1
    it, w = _loaded(path)
    assert it == 1 and torch.equal(w, torch.ones(4))
    be.wait()
    it, w = _loaded(path)
    assert it == 2 and torch.equal(w, torch.full((4,), 2.0))


def test_alternates_generations_within_one_process(tmp_path):
    path = tmp_path / "alt.ckpt"
    be = DcpBackend()
    lives = []
    for it in (1, 2, 3):
        _save(be, path, it, it)
        be.wait()
        lives.append((path / "LIVE").read_text().strip())
    assert lives == ["tree.g0", "tree.g1", "tree.g0"]
    assert _loaded(path)[0] == 3
    assert sorted(p.name for p in path.iterdir()) == [
        "LIVE", "tree.g0", "tree.g1"]


def test_legacy_single_tree_layout_still_loads(tmp_path):
    path = tmp_path / "leg.ckpt"
    be = DcpBackend()
    _save(be, path, 9.0, 9)
    be.wait()
    live = (path / "LIVE").read_text().strip()
    (path / live).rename(path / "tree")  # a checkpoint without generations
    (path / "LIVE").unlink()
    assert _loaded(path)[0] == 9


def test_resumed_process_does_not_overwrite_live_gen(tmp_path):
    path = tmp_path / "res.ckpt"
    be = DcpBackend()
    _save(be, path, 1.0, 1)
    be.wait()
    live = (path / "LIVE").read_text().strip()
    be2 = DcpBackend()
    assert be2.load(path)["meta"]["num_it"] == 1
    _save(be2, path, 2.0, 2)
    # in the window of save 2 the live generation is untouched
    assert (path / live / ".metadata").is_file()
    assert _loaded(path)[0] == 1
    be2.wait()
    assert _loaded(path)[0] == 2
    assert (path / "LIVE").read_text().strip() != live


def test_rejects_unknown_meta_keys(tmp_path):
    with pytest.raises(ValueError, match="does not persist"):
        DcpBackend().save(tmp_path / "u.ckpt", {"w": torch.ones(1)}, None,
                          {**_meta(1), "brand_new_field": 3})


def test_missing_checkpoint_loads_as_none(tmp_path):
    assert DcpBackend().load(tmp_path / "nothing.ckpt") is None


def _case(name, model, cfg, batches, ranks, **kw):
    split = _vb_split if name.startswith("i3d") else (
        lambda b: [{k: v[r::2] for k, v in b.items()} for r in range(2)])
    return {"name": name, "model": copy.deepcopy(model), "cfg": cfg,
            "lr": LR, "batches": [split(b) if ranks == 2 else [b]
                                  for b in batches], **kw}


@pytest.fixture(scope="module")
def grow(tmp_path_factory):
    """One process saves after 2 steps (orbax); 2 data ranks resume it for
    2 more, against 4 straight steps on 2 ranks."""
    tmp = tmp_path_factory.mktemp("orbax_grow")
    paths = make_synth_dataset(tmp / "data", n_train=8, n_valid=2,
                               n_test=1, seed=61)
    cfg = _srl_cfg(paths, tmp / "cfg")
    models = {"i3d": _i3d_model(), "tx": _srl_model(cfg, dropout=True)}
    batches = {"i3d": [_batch("i3d", seed=k) for k in range(4)],
               "tx": list(get_data(cfg).train_dl)[:4]}
    files = []
    for n in models:
        run_case(_case(n, models[n], OVER[n], batches[n][:2], 1,
                       save=str(tmp / f"{n}_1proc")), 0, str(tmp / "one"))
        for key, case in (
                (f"{n}_straight", _case(n, models[n], OVER[n], batches[n],
                                        2)),
                (f"{n}_grow", _case(n, models[n], OVER[n], batches[n][2:], 2,
                                    resume=str(tmp / f"{n}_1proc")))):
            case["name"] = key
            torch.save(case, tmp / f"{key}.pt")
            files.append(str(tmp / f"{key}.pt"))
    outs, _ = launch("steps", {"cases": files, "tmp": str(tmp / "two"),
                               "whole_on_rank0": True}, tmp)
    for path in files:
        Path(path).unlink()  # the models' copies
    return {"outs": outs, "tmp": tmp}


@pytest.mark.parametrize("name", ["i3d", "tx"])
def test_one_process_orbax_checkpoint_resumes_on_two_ranks(grow, name):
    for out in grow["outs"]:
        straight, resumed = out[f"{name}_straight"], out[f"{name}_grow"]
        assert resumed["num_it"] == straight["num_it"] == 4
        for a, b in zip(resumed["losses"], straight["losses"][2:]):
            assert abs(a - b) <= TOL[name] * abs(b), (a, b)
        assert torch.equal(resumed["rng"], straight["rng"])
    # rank 0's weights (the ranks' are the same: data parallel)
    straight, resumed = (grow["outs"][0][f"{name}_{k}"]
                         for k in ("straight", "grow"))
    _check_close(resumed["state_dict"], straight["state_dict"], TOL[name])
    log = (grow["tmp"] / "two" / "txt_logs" / "t.txt").read_text()
    assert "resumed a 1-process checkpoint on 2 processes" in log
    d = grow["tmp"] / f"{name}_1proc"
    assert (d / "LIVE").read_text().strip() == "tree.g0"
