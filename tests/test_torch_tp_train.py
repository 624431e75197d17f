"""Tensor parallelism (the ``model`` mesh axis) in the port's training, on
the CPU in float64 with dropout 0.1 (tests/torch_dist_child.py, mode
``steps``), after the JAX package's tests/test_tensor_parallel.py and the
TP step of ``__graft_entry__.py:314-335``.

  * ``[1, 2]`` and ``[2, 2]`` data x model ranks equal one process (the
    SRL models with attention and activation dropout 0.1 too) over
    whole steps of ``tx_only`` (two), ``sfpret_txe_txd_vbarg`` (two) and
    ``rob_evrel`` (one), ``[1, 2, 2]`` data x model x fsdp for ``tx_only``,
    a ``grad_accum=2`` cycle on ``[1, 2]``, and the hand-built I3D-NL of
    tests/vb_train_parity.py on ``[1, 2]`` (nothing splits: it replicates):
    the loss, the gradients the update used (the split leaves gathered
    whole) and the updated weights, each within 1e-9 of its leaf's scale;
  * the split leaves hold this rank's half of the heads and hidden columns;
  * the control: with each model rank drawing its own local-shaped dropout
    mask the step parts from one process's;
  * ``tx_only`` on ``[1, 2]`` with dropout 0 against the JAX package's
    one-device float64 step (the tolerances of tests/test_torch_srl_train.py);
  * SRL validation on ``[2, 2]`` at beam 3 on the reorder route (the
    evaluators' merge with a model axis): rank 0's merged pickle is one
    process's, one reorder a decode step on every rank, on half the heads;
  * the eval batch divides by the data extent, not the world size: ``bsv=2``
    builds on ``[2, 2]`` (tests/test_tensor_parallel.py:168-186), ``bsv=3``
    raises.
"""

import copy

import pytest
import torch

from tests.test_torch_dropout_ranks import _evrel_model
from tests.test_torch_elastic_resume import (
    _check_close,
    _i3d_model,
    _srl_cfg,
    _srl_model,
)
from tests.test_torch_evrel import TINY_ROB, evrel_cfg
from tests.test_torch_transformer import TINY as SRL_TINY
from tests.torch_dist_child import launch, run_case
from tests.vb_train_parity import _batch as vb_batch
from vidsitu_tpu_torch.data import get_data
from vidsitu_tpu_torch.data.synth import make_synth_dataset

torch.set_num_threads(1)

TOL = 1e-9
LR = 1e-3
MESHES = {"1x2": ("[1, 2]", "['data', 'model']"),
          "2x2": ("[2, 2]", "['data', 'model']"),
          "1x2x2": ("[1, 2, 2]", "['data', 'model', 'fsdp']")}
OVER = {"tx": {"task_type": "vb_arg", "mdl.mdl_name": "tx_only"},
        "sfpret": {"task_type": "vb_arg",
                   "mdl.mdl_name": "sfpret_txe_txd_vbarg"},
        "evrel": {"task_type": "evrel", "mdl.mdl_name": "rob_evrel",
                  **TINY_ROB},
        "i3d": {"task_type": "vb"}}
DECODE = {"gen.beam_size": 3, "gen.max_len_b": 6,
          "tpu.ancestry_beam": False}
# the SRL configs' attention and activation dropout are 0: at 0.1 the sites
# inside the split region draw too
RATES = {"tx_dec.attention_dropout": 0.1, "tx_dec.activation_dropout": 0.1}


def _axes(mesh):
    shape, names = MESHES[mesh]
    return {"tpu.mesh_shape": shape, "tpu.mesh_axis_names": names}


def _split(batch, world):
    """Data coordinate d's rows of a global batch: examples d::world, a
    video's 5 clips with it."""
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


def _case(name, model, cfg, batches, data_world, **kw):
    return {"name": name, "model": copy.deepcopy(model),
            "cfg": {"train.dtype": "float32", **cfg}, "lr": LR,
            "batches": [_split(b, data_world) for b in batches], **kw}


def _launch(cases, tmp, nproc, builds=None):
    tmp.mkdir(parents=True, exist_ok=True)
    files = []
    for key, case in cases.items():
        case["name"] = key
        path = tmp / f"{key}.pt"
        torch.save(case, path)
        files.append(str(path))
    outs, _ = launch("steps", {"cases": files, "tmp": str(tmp / "ranks"),
                               "builds": builds or {}},
                     tmp, nproc=nproc, timeout=300)
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    paths = make_synth_dataset(tmp / "data", n_train=8, n_valid=4, n_test=1,
                               seed=97)
    cfg = _srl_cfg(paths, tmp / "cfg", **{"train.bs": 4, **RATES})
    tx_batches = list(get_data(cfg).train_dl)[:2]
    sf_cfg = _srl_cfg(paths, tmp / "cfg", **{
        "train.bs": 4, "mdl.mdl_name": "sfpret_txe_txd_vbarg", **RATES})
    sf_batches = list(get_data(sf_cfg).train_dl)[:2]
    ev_cfg = evrel_cfg(paths, tmp, "rob_evrel", **{"train.bs": 4})
    models = {"tx": _srl_model(cfg, dropout=True),
              "sfpret": _srl_model(sf_cfg, dropout=True),
              "evrel": _evrel_model(ev_cfg), "i3d": _i3d_model(),
              "tx_nodrop": _srl_model(cfg, dropout=False)}
    batches = {"tx": tx_batches, "sfpret": sf_batches,
               "evrel": [next(iter(get_data(ev_cfg).train_dl))],
               "i3d": [vb_batch("i3d", seed=k) for k in range(2)]}
    decode = {**paths, **SRL_TINY, **OVER["tx"], **DECODE,
              "train.bsv": 2, "train.nw": 0, "train.nwv": 0}
    two = {f"{n}_1x2": _case(n, models[n], {**OVER[n], **_axes("1x2")},
                             batches[n], 1) for n in batches}
    two["accum_1x2"] = _case("tx", models["tx"], {
        **OVER["tx"], **_axes("1x2"), "train.grad_accum": 2},
        tx_batches, 1)
    two["nodrop_1x2"] = _case("tx", models["tx_nodrop"],
                              {**OVER["tx"], **_axes("1x2")},
                              tx_batches[:1], 1)
    two["local_masks_1x2"] = _case("tx", models["tx"],
                                   {**OVER["tx"], **_axes("1x2")},
                                   tx_batches[:1], 1, local_masks=True)
    four = {f"{n}_2x2": _case(n, models[n], {**OVER[n], **_axes("2x2")},
                              batches[n], 2)
            for n in ("tx", "sfpret", "evrel")}
    four["tx_1x2x2"] = _case("tx", models["tx"],
                             {**OVER["tx"], **_axes("1x2x2")}, tx_batches, 2)
    four["decode_2x2"] = _case("tx", models["tx"],
                               {**decode, **_axes("2x2")}, [], 2,
                               validate=True)
    builds = {f"bsv{b}": {**decode, **_axes("2x2"), "train.bs": 4,
                          "train.bsv": b, "misc.tmp_path": str(tmp / "b")}
              for b in (2, 3)}
    outs = {"1x2": _launch(two, tmp / "two", 2),
            "2x2": _launch(four, tmp / "four", 4, builds)}
    one_tmp = str(tmp / "one")
    one = {n: run_case(_case(n, models[n], OVER[n], batches[n], 1), 0,
                       one_tmp) for n in batches}
    one["accum"] = run_case(_case("tx", models["tx"], {
        **OVER["tx"], "train.grad_accum": 2}, tx_batches, 1), 0, one_tmp)
    one["nodrop"] = run_case(_case("tx", models["tx_nodrop"], OVER["tx"],
                                   tx_batches[:1], 1), 0, one_tmp)
    one["tx_first"] = run_case(_case("tx", models["tx"], OVER["tx"],
                                     tx_batches[:1], 1), 0, one_tmp)
    one["decode"] = run_case(_case("tx", models["tx"], decode, [], 1,
                                   validate=True), 0, str(tmp / "dec"))
    return {"one": one, "outs": outs, "models": models,
            "tx_batch": tx_batches[0], "cfg": cfg}


CASES = [("1x2", n) for n in ("tx", "sfpret", "evrel", "i3d", "accum")] + [
    ("2x2", n) for n in ("tx", "sfpret", "evrel")] + [("1x2x2", "tx")]


@pytest.mark.parametrize("mesh,name", CASES,
                         ids=[f"{n}-{m}" for m, n in CASES])
def test_tp_equals_one_process(runs, mesh, name):
    want = runs["one"][name]
    launch_of = "1x2" if mesh == "1x2" else "2x2"
    for out in runs["outs"][launch_of]:
        got = out[f"{name}_{mesh}"]
        assert len(got["losses"]) == len(want["losses"])
        for a, b in zip(got["losses"], want["losses"]):
            assert abs(a - b) <= TOL * abs(b), (a, b)
        _check_close(got["grads"], want["grads"], TOL)
        _check_close(got["state_dict"], want["state_dict"], TOL)
        assert torch.equal(got["rng"], want["rng"])
        assert got["accum_count"] == want["accum_count"] == 0


@pytest.mark.parametrize("mesh,name", [("1x2", "tx"), ("2x2", "evrel"),
                                       ("1x2x2", "tx")])
def test_split_leaves_hold_half(runs, mesh, name):
    """Each rank's split leaves are half of the whole along the split
    dimension (heads of q/k/v and out_proj, columns of the FFN); the
    others keep their shape; on ``[1, 2, 2]`` FSDP2 shards the halves."""
    launch_of = "1x2" if mesh == "1x2" else "2x2"
    model = runs["models"][name]
    whole = {n: p.shape for n, p in model.named_parameters()}
    for out in runs["outs"][launch_of]:
        got = out[f"{name}_{mesh}"]
        local, dims = got["local_shapes"], got["split_dims"]
        assert set(dims) == {n for n in whole if n.endswith((
            "q_proj.weight", "q_proj.bias", "k_proj.weight", "k_proj.bias",
            "v_proj.weight", "v_proj.bias", "out_proj.weight",
            "fc1.weight", "fc1.bias", "fc2.weight"))
            and "classf_head" not in n}
        for n, shape in whole.items():
            want = list(shape)
            if n in dims:
                want[dims[n]] //= 2
            assert list(local[n]) == want, n
        if mesh == "1x2x2":
            assert got["layout"]["learner_params_sharded"]


def test_local_masks_are_the_control(runs):
    """Each model rank drawing a mask of its own slice's shape (not the
    whole mask's slice) parts from one process's step."""
    want = runs["one"]["tx_first"]
    got = runs["outs"]["1x2"][0]["local_masks_1x2"]
    assert abs(got["losses"][0] - want["losses"][0]) > TOL * abs(
        want["losses"][0])
    with pytest.raises(AssertionError):
        _check_close(got["grads"], want["grads"], TOL)


def test_tp_step_matches_jax_float64(runs):
    """``tx_only`` on ``[1, 2]``, dropout 0, against JAX's one-device
    float64 step from the same weights."""
    import dataclasses

    import jax.numpy as jnp

    from tests.test_torch_srl_train import check_step, jax_adam_step
    from vidsitu_tpu.data import build_comm
    from vidsitu_tpu.models import selector as jsel
    from vidsitu_tpu_torch.convert.from_flax import state_dict_to_flax

    cfg = runs["cfg"]
    model = runs["models"]["tx_nodrop"]
    tree = state_dict_to_flax(model.state_dict(), model)
    jm = jsel.build_model(cfg, build_comm(cfg))
    f64 = dict(dtype=jnp.float64, param_dtype=jnp.float64)
    jm = jm.clone(dec_cfg=dataclasses.replace(jm.dec_cfg, **f64),
                  enc_cfg=dataclasses.replace(jm.enc_cfg, **f64))
    ref = jax_adam_step(jm, tree, runs["tx_batch"])
    got = runs["outs"]["1x2"][0]["nodrop_1x2"]
    after = copy.deepcopy(model)
    after.load_state_dict(got["state_dict"])
    check_step(ref, got["losses"][0], got["grads"], after)


def test_tp_decode_on_2x2_equals_one_process(runs):
    want = runs["one"]["decode"]["validate"]
    outs = [o["decode_2x2"]["validate"] for o in runs["outs"]["2x2"]]
    assert want["pred"] and outs[0]["pred"] == want["pred"]
    assert all(o["acc"] == outs[0]["acc"] for o in outs)
    for o in outs:
        assert o["gathers"] == sum(o["steps"]) > 0
        assert all(h == [2] for h in o["heads"]), o["heads"]
    # the ranks of a model group decode the same rows: the same steps
    assert outs[0]["steps"] == outs[1]["steps"]
    assert outs[2]["steps"] == outs[3]["steps"]


def test_eval_batch_divides_by_the_data_extent(runs):
    res = runs["outs"]["2x2"][0]
    assert res["bsv2"] is None
    assert "train.bsv=3" in res["bsv3"] and "data x fsdp" in res["bsv3"]
