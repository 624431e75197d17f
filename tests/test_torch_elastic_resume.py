"""Resuming the port's training on another number of processes, on the CPU
in float64 with 2 gloo ranks (tests/torch_dist_child.py, mode ``steps``):
the counterpart of the JAX package's topology-free checkpoints
(tests/test_elastic_resume.py, the same geometry: 2 steps saved, 2 more
resumed, against 4 straight steps).

A checkpoint holds whole tensors (model, Adam's moments, BatchNorm
statistics) and the counters, so a resize restores them as they are; the
ranks' data shards of a global batch add up to the one-process batch, and
the steps over 2 ranks compute the global batch's step (BatchNorm
statistics, loss and gradients over the global batch), so a resized run
equals a straight run on the new number of processes to float64 rounding.
Checked for the SRL ``tx_only`` model (seeded weights; dropout 0, and
dropout on as ``tx_drop``) and the hand-built I3D-NL of tests/vb_train_parity.py (its BatchNorm statistics
too) at flax's initial values, with its non-local attention in float64
(the port's and the JAX package's compute it in float32 whatever the
model's dtype):

  * saved on 2 ranks, resumed on 1 process, against 4 steps on 1 process;
  * saved on 1 process, resumed on 2 ranks, against 4 steps on 2 ranks;
  * with dropout on, the one generator: every rank of the new run takes the
    saved state (every rank draws the global batch's masks, so the resized
    run is the straight run), and two resumes are bitwise equal;
  * a global batch that the new number of ranks does not divide raises.

Each leaf is held within TOL[model] of its scale, and no less than that of
1e-3 of the model's largest leaf (a leaf whose gradient is zero in exact
arithmetic, such as a key projection's bias under the softmax, moves by
rounding noise only). The I3D-NL's limit is 1e-8: its non-local and
final BatchNorm shifts start at zero with gradients near Adam's epsilon,
where Adam turns the 2-rank BatchNorm sums' float64 rounding into a few
1e-9 of the scale (3.4e-9 at most here).
"""

import copy
import dataclasses

import pytest
import torch

from tests.test_torch_transformer import TINY as SRL_TINY
from tests.torch_dist_child import attention_f64, launch, run_case
from tests.vb_train_parity import MODELS, N_CLASSES, _batch
from vidsitu_tpu_torch.convert.from_flax import (
    flax_to_state_dict,
    seeded_variables,
)
from vidsitu_tpu_torch.data import build_comm, get_data
from vidsitu_tpu_torch.data.synth import make_synth_dataset
from vidsitu_tpu_torch.models import selector as psel
from vidsitu_tpu_torch.models import video_backbone as tvb
from vidsitu_tpu_torch.models.srl_models import SRLModel
from vidsitu_tpu_torch.models.vb_models import VbVideoModel
from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

torch.set_num_threads(1)

TOL = {"i3d_nl": 1e-8, "tx_only": 1e-9, "tx_drop": 1e-9}
LR = 1e-3
NAMES = ("i3d_nl", "tx_only", "tx_drop")


def _srl_cfg(paths, tmp, **kw):
    return get_cfg_with_overrides("elastic", **{
        **paths, **SRL_TINY, "task_type": "vb_arg", "mdl.mdl_name": "tx_only",
        "train.bs": 2, "train.bsv": 2, "train.nw": 0, "train.nwv": 0,
        "train.dtype": "float32", "misc.tmp_path": str(tmp), **kw})


def _srl_model(cfg, dropout):
    pm = psel.build_model(cfg, build_comm(cfg))
    tree = seeded_variables(pm, 7)
    rates = dict(dtype=torch.float64)
    if not dropout:
        rates.update(dropout=0.0, attn_dropout=0.0, act_dropout=0.0)
    pm = SRLModel(pm.mdl_name, dataclasses.replace(pm.dec_cfg, **rates),
                  dataclasses.replace(pm.enc_cfg, **rates), pm.tx_enc_type,
                  pm.feat_dim)
    pm.load_state_dict(flax_to_state_dict(tree), strict=True)
    return pm.double()


def _i3d_model():
    """flax's initial values (what a fit starts from), every product in
    float64, the non-local attention too."""
    model = VbVideoModel(tvb.VideoCfg(**MODELS["i3d_nl"],
                                      dtype=torch.float64),
                         num_classes=N_CLASSES)
    for m in model.modules():
        if isinstance(m, tvb.NonLocalBlock):
            m.attention = attention_f64
    return psel.init_model_variables(model, 11).double()


def _vb_split(batch):
    """Rank r's share of a 2-video batch: video r, its 5 clips."""
    return [{k: v[5 * r:5 * r + 5] if k.startswith("frms") else v[r:r + 1]
             for k, v in batch.items()} for r in range(2)]


def _split(batch):
    return [{k: v[r:r + 1] for k, v in batch.items()} for r in range(2)]


def _case(name, model, cfg, batches, ranks, resume=None, save=None):
    """A case of ``run_case``: ``batches`` global batches, each split over
    ``ranks`` (1: the whole batch)."""
    split = _vb_split if name.startswith("i3d") else _split
    return {"name": name, "model": copy.deepcopy(model), "cfg": cfg,
            "lr": LR, "resume": resume, "save": save,
            "batches": [split(b) if ranks == 2 else [b] for b in batches]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    paths = make_synth_dataset(tmp / "data", n_train=8, n_valid=2, n_test=1,
                               seed=61)
    cfg = _srl_cfg(paths, tmp / "cfg")
    srl_batches = list(get_data(cfg).train_dl)[:4]
    assert len(srl_batches) == 4
    lang = {"task_type": "vb_arg", "mdl.mdl_name": "tx_only",
            "train.dtype": "float32"}
    setups = {
        "i3d_nl": (_i3d_model(), {"task_type": "vb",
                                  "train.dtype": "float32"},
                   [_batch("i3d", seed=k) for k in range(4)]),
        "tx_only": (_srl_model(cfg, dropout=False), lang, srl_batches),
        "tx_drop": (_srl_model(cfg, dropout=True), lang, srl_batches),
    }
    one_tmp, ckpt = str(tmp / "one"), tmp / "ckpt"
    ckpt.mkdir()
    one, cases = {}, []
    for name, (model, over, batches) in setups.items():
        # one process: 4 straight steps; 2 steps saved
        one[f"{name}_straight"] = run_case(
            _case(name, model, over, batches, 1), 0, one_tmp)
        one[f"{name}_save2"] = run_case(
            _case(name, model, over, batches[:2], 1,
                  save=ckpt / f"{name}_1proc.ckpt"), 0, one_tmp)
        # two ranks: the same, and both resumes of the 1-process checkpoint
        two = {f"{name}_save2": _case(name, model, over, batches[:2], 2,
                                      save=str(ckpt / f"{name}_2rank.ckpt")),
               f"{name}_straight": _case(name, model, over, batches, 2)}
        # with dropout on, each resize runs twice (the repeat)
        again = ("_again",) if name == "tx_drop" else ()
        for tag in ("grow",) + tuple("grow" + a for a in again):
            two[f"{name}_{tag}"] = _case(
                name, model, over, batches[2:], 2,
                resume=str(ckpt / f"{name}_1proc.ckpt"))
        for key, case in two.items():
            case["name"] = key
            path = tmp / f"{key}.pt"
            torch.save(case, path)
            cases.append(str(path))
    builds = {"indivisible": {
        **paths, **SRL_TINY, **lang, "train.bs": 3, "train.bsv": 2,
        "train.nw": 0, "train.nwv": 0, "misc.tmp_path": str(tmp / "bad")}}
    outs, _ = launch("steps", {"cases": cases, "builds": builds,
                               "tmp": str(tmp / "two")}, tmp)
    # one process resumes the 2-rank checkpoints, twice
    for name, (model, over, batches) in setups.items():
        again = ("_again",) if name == "tx_drop" else ()
        for tag in ("shrink",) + tuple("shrink" + a for a in again):
            one[f"{name}_{tag}"] = run_case(
                _case(name, model, over, batches[2:], 1,
                      resume=str(ckpt / f"{name}_2rank.ckpt")), 0, one_tmp)
    return {"one": one, "two": outs, "ckpt": ckpt, "tmp": tmp}


def _check_close(got, want, tol):
    """Every float tensor of ``got`` within ``tol`` of its leaf's scale in
    ``want``, no less than ``tol`` of 1e-3 of the largest leaf."""
    floats = {k: v for k, v in want.items() if v.is_floating_point()}
    floor = 1e-3 * max(float(v.abs().max()) for v in floats.values())
    worst = 0.0
    for k, w in floats.items():
        scale = max(float(w.abs().max()), floor)
        err = float((got[k] - w).abs().max()) / scale
        assert err <= tol, (k, err)
        worst = max(worst, err)
    for k, w in want.items():
        if not w.is_floating_point():
            assert torch.equal(got[k], w), k
    return worst


@pytest.mark.parametrize("name", NAMES)
def test_two_rank_checkpoint_resumes_on_one_process(runs, name):
    one = runs["one"]
    saved = torch.load(runs["ckpt"] / f"{name}_2rank.ckpt",
                       weights_only=True)
    assert saved["world_size"] == 2 and saved["num_it"] == 2
    resumed, straight = one[f"{name}_shrink"], one[f"{name}_straight"]
    assert resumed["num_it"] == straight["num_it"] == 4
    for a, b in zip(resumed["losses"], straight["losses"][2:]):
        assert abs(a - b) <= TOL[name] * abs(b), (a, b)
    _check_close(resumed["state_dict"], straight["state_dict"], TOL[name])
    if name == "i3d_nl":
        stats = [k for k in straight["state_dict"] if "running_var" in k]
        assert stats and all(
            not torch.equal(straight["state_dict"][k],
                            _i3d_model().state_dict()[k]) for k in stats)
    log = (runs["tmp"] / "one" / "txt_logs" / "t.txt").read_text()
    assert "resumed a 2-process checkpoint on 1 processes" in log


@pytest.mark.parametrize("name", NAMES)
def test_one_process_checkpoint_resumes_on_two_ranks(runs, name):
    outs, one = runs["two"], runs["one"]
    saved = torch.load(runs["ckpt"] / f"{name}_1proc.ckpt",
                       weights_only=True)
    assert saved["world_size"] == 1 and "dropout_rng_by_rank" not in saved
    for out in outs:
        resumed, straight = out[f"{name}_grow"], out[f"{name}_straight"]
        assert resumed["num_it"] == straight["num_it"] == 4
        for a, b in zip(resumed["losses"], straight["losses"][2:]):
            assert abs(a - b) <= TOL[name] * abs(b), (a, b)
        _check_close(resumed["state_dict"], straight["state_dict"],
                     TOL[name])
        # and the straight 2-rank run is the 1-process run's
        _check_close(straight["state_dict"],
                     one[f"{name}_straight"]["state_dict"], TOL[name])
    for k, v in outs[0][f"{name}_grow"]["state_dict"].items():
        assert torch.equal(v, outs[1][f"{name}_grow"]["state_dict"][k]), k
    log = (runs["tmp"] / "two" / "txt_logs" / "t.txt").read_text()
    assert "resumed a 1-process checkpoint on 2 processes" in log


def test_dropout_generators_of_a_resized_resume(runs):
    """A checkpoint holds one generator state, the same on every rank; a
    resume on any number of ranks takes it everywhere; each resume
    repeats."""
    outs, one, ckpt = runs["two"], runs["one"], runs["ckpt"]
    one_saved = torch.load(ckpt / "tx_drop_1proc.ckpt", weights_only=True)
    two_saved = torch.load(ckpt / "tx_drop_2rank.ckpt", weights_only=True)
    assert "dropout_rng_by_rank" not in two_saved
    assert torch.equal(one_saved["dropout_rng"],
                       one["tx_drop_save2"]["rng"])
    for r in range(2):
        assert torch.equal(two_saved["dropout_rng"],
                           outs[r]["tx_drop_save2"]["rng"])
        # grow: both ranks take the saved state
        assert torch.equal(outs[r]["tx_drop_grow"]["rng_loaded"],
                           one_saved["dropout_rng"])
    # the same masks drawn on 1 process and on 2 ranks: the same stream
    assert torch.equal(one_saved["dropout_rng"], two_saved["dropout_rng"])
    assert torch.equal(one["tx_drop_shrink"]["rng_loaded"],
                       two_saved["dropout_rng"])
    # the masks drew: the dropout run left the dropout-free one
    assert one["tx_drop_straight"]["losses"] != one[
        "tx_only_straight"]["losses"]
    # two resumes of one checkpoint are bitwise equal
    pairs = [(one["tx_drop_shrink"], one["tx_drop_shrink_again"])] + [
        (out["tx_drop_grow"], out["tx_drop_grow_again"]) for out in outs]
    for a, b in pairs:
        assert a["losses"] == b["losses"]
        assert torch.equal(a["rng"], b["rng"])
        for k, v in a["state_dict"].items():
            assert torch.equal(v, b["state_dict"][k]), k


def test_indivisible_global_batch_raises(runs):
    for out in runs["two"]:
        assert "not divisible by the 2 ranks" in out["indivisible"], out[
            "indivisible"]


def test_repeatable_stem_pool_is_the_stem_pool():
    """Under deterministic algorithms a CUDA step takes the stem's max pool
    as two one-axis pools: the same values, and (without ties) the same
    gradient as the fused pool, up to the order of the sums where windows
    overlap."""
    x = torch.randn(2, 3, 2, 9, 12, dtype=torch.float64, requires_grad=True)
    want = torch.nn.functional.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    got = tvb.repeatable_stem_pool(x)
    assert torch.equal(got, want)
    g = torch.randn_like(want)
    (gw,) = torch.autograd.grad(want, x, g)
    (gg,) = torch.autograd.grad(got, x, g)
    torch.testing.assert_close(gg, gw, rtol=1e-14, atol=1e-14)
    assert (gw != 0).sum() == (gg != 0).sum() > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the bitwise repeat is a property of the CUDA ops "
                    "(chip_smoke.py phase 28 runs it)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_stem_backward_repeats_bitwise_on_the_card(cuda_device):
    x = torch.randn(4, 64, 8, 112, 112, device=cuda_device)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        stem = tvb.Stem(64, 64, 1, tvb.VideoCfg()).to(cuda_device).train()
        grads = []
        for _ in range(2):
            xi = x.clone().requires_grad_()
            (gx,) = torch.autograd.grad(stem(xi).square().sum(), xi)
            grads.append(gx)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.equal(grads[0], grads[1])
