"""Dropout that does not depend on the number of ranks, and a
``grad_accum`` cycle carried through a checkpoint, in the port on the CPU in
float64 (2 gloo ranks through tests/torch_dist_child.py, mode ``steps``).

  * Every rank holds one generator seeded from ``train.seed``, draws the
    global batch's mask at each site and keeps its examples' rows (the
    loader's ``r::W`` layout): 2 ranks equal one process with dropout 0.1,
    for the SRL ``tx_only`` model (two steps) and ``rob_evrel`` (one step),
    on the loss and every gradient within 1e-9 of each leaf's scale (as
    the JAX package's one program over the global batch,
    ``__graft_entry__.py:142-157``).
  * One process draws, bitwise, the masks of a plain ``torch.rand`` of the
    activation's shape; a rank's mask is its examples' rows of the
    one-process mask; a site whose leading dimension is not example-major
    raises.
  * A checkpoint written when each rank had its own generator
    (``dropout_rng_by_rank``, the optimizer state keyed by index) loads,
    every rank taking rank 0's state.
  * ``train.grad_accum=2`` at 3 steps an epoch: a checkpoint after the
    first epoch holds the cycle in flight (count 1 and the gradients so far,
    summed over the ranks); 1 epoch + resume (``load_opt``) + 1 epoch
    equals 2 straight epochs on every leaf, on one process and across a
    2 -> 1 resize. A resume without the cycle (its count and gradients
    taken out of the checkpoint) is the control: it falls outside the
    limit.
"""

import copy
import dataclasses

import pytest
import torch

from tests.test_torch_elastic_resume import (
    _check_close,
    _srl_cfg,
    _srl_model,
)
from tests.test_torch_evrel import TINY_ROB, evrel_cfg
from tests.torch_dist_child import launch, run_case
from vidsitu_tpu_torch.convert.from_flax import (
    flax_to_state_dict,
    seeded_variables,
)
from vidsitu_tpu_torch.data import build_comm, get_data
from vidsitu_tpu_torch.data.synth import make_synth_dataset
from vidsitu_tpu_torch.models import common
from vidsitu_tpu_torch.models import selector as psel
from vidsitu_tpu_torch.models.evrel_models import EvrelModel
from vidsitu_tpu_torch.train.learner import Learner
from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

torch.set_num_threads(1)

TOL = 1e-9
LR = 1e-3
LANG = {"task_type": "vb_arg", "mdl.mdl_name": "tx_only",
        "train.dtype": "float32"}
ACCUM = {**LANG, "train.grad_accum": 2}


def _evrel_model(cfg):
    pm = psel.build_model(cfg, build_comm(cfg))
    tree = seeded_variables(pm, 5)
    assert pm.rob_cfg.dropout == 0.1
    pm = EvrelModel(pm.mdl_name, dataclasses.replace(
        pm.rob_cfg, dtype=torch.float64), pm.feat_dim)
    pm.load_state_dict(flax_to_state_dict(tree), strict=True)
    return pm.double()


def _split(batch, world):
    return [{k: v[r::world] for k, v in batch.items()} for r in range(world)]


def _case(name, model, cfg, batches, world, resume=None, save=None):
    return {"name": name, "model": copy.deepcopy(model), "cfg": cfg,
            "lr": LR, "resume": resume, "save": save,
            "batches": [_split(b, world) for b in batches]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dropout_ranks")
    paths = make_synth_dataset(tmp / "data", n_train=12, n_valid=2,
                               n_test=1, seed=71)
    srl_batches = list(get_data(_srl_cfg(paths, tmp / "cfg")).train_dl)
    assert len(srl_batches) == 6
    tx = _srl_model(_srl_cfg(paths, tmp / "cfg"), dropout=True)
    assert tx.dec_cfg.dropout == 0.1
    ev_cfg = evrel_cfg(paths, tmp, "rob_evrel")
    ev_batch = next(iter(get_data(ev_cfg).train_dl))
    ev = _evrel_model(ev_cfg)
    ev_over = {"task_type": "evrel", "mdl.mdl_name": "rob_evrel",
               "train.dtype": "float32", **TINY_ROB}
    ckpt = tmp / "ckpt"
    ckpt.mkdir()
    two = {"tx": _case("tx", tx, LANG, srl_batches[:2], 2),
           "evrel": _case("evrel", ev, ev_over, [ev_batch], 2),
           "accum_save": _case("accum_save", tx, ACCUM, srl_batches[:3], 2,
                               save=str(ckpt / "accum_2rank.ckpt"))}
    cases = []
    for key, case in two.items():
        path = tmp / f"{key}.pt"
        torch.save(case, path)
        cases.append(str(path))
    outs, _ = launch("steps", {"cases": cases, "tmp": str(tmp / "two")}, tmp)
    one_tmp = str(tmp / "one")
    one = {
        "tx": run_case(_case("tx", tx, LANG, srl_batches[:2], 1), 0,
                       one_tmp),
        "evrel": run_case(_case("evrel", ev, ev_over, [ev_batch], 1), 0,
                          one_tmp),
        "accum_straight": run_case(_case("s", tx, ACCUM, srl_batches, 1), 0,
                                   one_tmp),
        "accum_save": run_case(_case("a", tx, ACCUM, srl_batches[:3], 1,
                                     save=str(ckpt / "accum_1proc.ckpt")),
                               0, one_tmp),
    }
    saved = torch.load(ckpt / "accum_1proc.ckpt", weights_only=True)
    ctl = {k: v for k, v in saved.items() if k != "accum_grads"}
    ctl["accum_count"] = 0
    torch.save(ctl, ckpt / "no_cycle.ckpt")
    for tag, src in (("resume", "accum_1proc"), ("shrink", "accum_2rank"),
                     ("control", "no_cycle")):
        one[f"accum_{tag}"] = run_case(_case(
            tag, tx, ACCUM, srl_batches[3:], 1,
            resume=str(ckpt / f"{src}.ckpt")), 0, one_tmp)
    return {"one": one, "two": outs, "ckpt": ckpt, "tmp": tmp}


@pytest.mark.parametrize("name", ["tx", "evrel"])
def test_two_ranks_with_dropout_equal_one_process(runs, name):
    want = runs["one"][name]
    assert want["losses"]
    for out in runs["two"]:
        got = out[name]
        for a, b in zip(got["losses"], want["losses"]):
            assert abs(a - b) <= TOL * abs(b), (a, b)
        _check_close(got["grads"], want["grads"], TOL)
        _check_close(got["state_dict"], want["state_dict"], TOL)
        # the ranks' generators moved alike, as the one process's
        assert torch.equal(got["rng"], want["rng"])


def test_one_process_draws_the_plain_masks():
    x = torch.randn(6, 3, 4, dtype=torch.float64)
    for kw in ({}, {"rank": 0, "world": 1, "examples": 6}):
        gen = torch.Generator().manual_seed(3)
        with common.dropout_generator(gen, **kw):
            got = common.dropout(x, 0.1, True)
        old = torch.Generator().manual_seed(3)
        keep = torch.rand(x.shape, generator=old) < 1.0 - 0.1
        assert torch.equal(got, x * keep / (1.0 - 0.1))
        assert torch.equal(gen.get_state(), old.get_state())


def test_a_rank_keeps_its_examples_rows_of_the_global_mask():
    """A (B*5, T, D) site, events folded behind the example: rank r's
    examples are the global batch's r::2."""
    glob = torch.randn(6 * 5, 2, 4, dtype=torch.float64)
    with common.dropout_generator(torch.Generator().manual_seed(9)):
        want = common.dropout(glob, 0.25, True).view(6, 5, 2, 4)
    for r in range(2):
        local = glob.view(6, 5, 2, 4)[r::2].reshape(15, 2, 4)
        with common.dropout_generator(torch.Generator().manual_seed(9), r,
                                      2, 3):
            got = common.dropout(local, 0.25, True)
        assert torch.equal(got.view(3, 5, 2, 4), want[r::2])
    with common.dropout_generator(torch.Generator(), 0, 2, 3):
        with pytest.raises(RuntimeError, match="example-major"):
            common.dropout(torch.ones(7, 4), 0.1, True)


def test_checkpoint_with_per_rank_generators_loads(runs, tmp_path):
    """The layout of a checkpoint written when each rank had its own
    generator: ``dropout_rng_by_rank`` beside rank 0's ``dropout_rng``,
    Adam's state keyed by index."""
    saved = torch.load(runs["ckpt"] / "accum_1proc.ckpt", weights_only=True)
    tx_case = torch.load(runs["tmp"] / "tx.pt", weights_only=False)
    model = tx_case["model"]
    cfg = get_cfg_with_overrides("old", **{"misc.tmp_path": str(tmp_path),
                                           **LANG})
    ref = Learner("ref", get_cfg_with_overrides("ref", **{
        "misc.tmp_path": str(tmp_path), **ACCUM}), copy.deepcopy(model),
        None, None, "cpu")
    ref.prepare_optimizer(LR)
    ref.load_model_dict(str(runs["ckpt"] / "accum_1proc.ckpt"),
                        load_opt=True)
    names = [n for n, _ in model.named_parameters()]
    index = {n: i for i, n in enumerate(names)}
    opt = saved["optimizer_state_dict"]
    gens = [torch.Generator().manual_seed(s).get_state() for s in (1, 2)]
    old = {k: v for k, v in saved.items()
           if k not in ("accum_grads", "accum_count")}
    old.update(world_size=2, dropout_rng=gens[0], dropout_rng_by_rank=gens,
               optimizer_state_dict={
                   "state": {index[n]: st for n, st in opt["state"].items()},
                   "param_groups": [{**g, "params": [index[n] for n in
                                                     g["params"]]}
                                    for g in opt["param_groups"]]})
    torch.save(old, tmp_path / "old.ckpt")
    learner = Learner("old", cfg, copy.deepcopy(model), None, None, "cpu")
    learner.prepare_optimizer(LR)
    learner.load_model_dict(str(tmp_path / "old.ckpt"), load_opt=True)
    assert torch.equal(learner.dropout_gen.get_state(), gens[0])
    assert learner._accum_count == 0
    got, want = (x.optimizer.state_dict() for x in (learner, ref))
    assert got["state"].keys() == want["state"].keys()
    for i, st in want["state"].items():
        for key, v in st.items():
            assert torch.equal(got["state"][i][key], v), (i, key)
    for k, v in ref.model.state_dict().items():
        assert torch.equal(learner.model.state_dict()[k], v), k
    log = learner.txt_log_file.read_text()
    assert "resumed a 2-process checkpoint on 1 processes" in log


@pytest.mark.parametrize("tag", ["resume", "shrink"])
def test_grad_accum_cycle_resumes_mid_cycle(runs, tag):
    one = runs["one"]
    saved = torch.load(runs["ckpt"] / ("accum_1proc.ckpt" if tag == "resume"
                                       else "accum_2rank.ckpt"),
                       weights_only=True)
    assert saved["accum_count"] == 1 and saved["num_it"] == 3
    assert saved["world_size"] == (1 if tag == "resume" else 2)
    assert set(saved["accum_grads"]) <= set(one["accum_save"]["state_dict"])
    straight, resumed = one["accum_straight"], one[f"accum_{tag}"]
    assert resumed["num_it"] == straight["num_it"] == 6
    assert straight["accum_count"] == resumed["accum_count"] == 0
    for a, b in zip(resumed["losses"], straight["losses"][3:]):
        assert abs(a - b) <= TOL * abs(b), (a, b)
    _check_close(resumed["grads"], straight["grads"], TOL)
    _check_close(resumed["state_dict"], straight["state_dict"], TOL)


def test_the_cycle_was_needed(runs):
    """The control: the same checkpoint without its cycle resumes to other
    weights."""
    one = runs["one"]
    with pytest.raises(AssertionError):
        _check_close(one["accum_control"]["state_dict"],
                     one["accum_straight"]["state_dict"], TOL)
    # the 2-rank checkpoint's summed cycle is the 1-process one's
    a = torch.load(runs["ckpt"] / "accum_1proc.ckpt", weights_only=True)
    b = torch.load(runs["ckpt"] / "accum_2rank.ckpt", weights_only=True)
    assert a["accum_grads"].keys() == b["accum_grads"].keys()
    _check_close(b["accum_grads"], a["accum_grads"], TOL)
