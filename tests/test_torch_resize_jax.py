"""The port's mid-run resize against the JAX package's: JAX
``Learner.request_resize`` on a 4-device virtual CPU mesh (``data`` x
``fsdp`` ``[2, 2]``, resized to 2 devices: ``[2, 1]``), against the port's
4 gloo ranks on the same mesh resized to 2 (tests/torch_dist_child.py, mode
``fit``), from one seeded flax tree of ``tx_only`` (float32, every dropout
rate 0), 2 epochs of 2 steps, each validated. (Its own file: the float64
cases of tests/test_torch_resize.py fill that file's time.)

The limit is the JAX test's own between its resized and straight runs
(tests/test_elastic_resume.py:156): every parameter within atol 3e-4 after
the 4 Adam steps. The control resizes the port's run the wrong way, its
Adam moments and step counts left out at the boundary (2 ranks to 1: a
step does not depend on the number of ranks); its parameters must part
from JAX's by more than the limit.
"""

import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tests.test_elastic_resume import TINY as JAX_TINY
from tests.torch_dist_child import launch
from vidsitu_tpu_torch.convert.from_flax import flax_to_state_dict
from vidsitu_tpu_torch.data import build_comm
from vidsitu_tpu_torch.data.synth import make_synth_dataset
from vidsitu_tpu_torch.models import selector as psel
from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

torch.set_num_threads(1)

ATOL = 3e-4  # tests/test_elastic_resume.py:156
LR = 1e-3
EPOCHS = 2


def _jax_learner(cfg, mesh):
    from vidsitu_tpu.data import build_comm as jbuild_comm
    from vidsitu_tpu.data import get_data
    from vidsitu_tpu.evaluation.evaluators import EvalB_Gen
    from vidsitu_tpu.models.selector import (
        build_model,
        build_srl_generate_fn,
        init_model_variables,
    )
    from vidsitu_tpu.train.learner import Learner

    comm = jbuild_comm(cfg)
    data = get_data(cfg)
    model = build_model(cfg, comm)
    variables = init_model_variables(model, next(iter(data.train_dl)), seed=7)
    evalb = EvalB_Gen(cfg, comm, build_srl_generate_fn(cfg, comm, model))
    return Learner(uid=cfg.uid, cfg=cfg, model=model, variables=variables,
                   data=data, eval_fn=evalb, mesh=mesh)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    tmp = tmp_path_factory.mktemp("resize_jax")
    paths = make_synth_dataset(tmp / "data", n_train=16, n_valid=4, n_test=1,
                               seed=67)
    over = {**paths, **JAX_TINY, "task_type": "vb_arg",
            "mdl.mdl_name": "tx_only", "train.bs": 8, "train.bsv": 4,
            "train.nw": 0, "train.nwv": 0, "train.dtype": "float32",
            "gen.beam_size": 3, "gen.max_len_b": 6,
            "tpu.mesh_shape": "[2, -1]",
            "tpu.mesh_axis_names": "['data', 'fsdp']"}
    cfg = get_cfg_with_overrides("rsz_jax", **{
        **over, "misc.tmp_path": str(tmp / "jax")})
    devices = jax.devices()[:4]
    jl = _jax_learner(cfg, Mesh(np.asarray(devices).reshape(2, 2),
                                ("data", "fsdp")))
    tree = jax.tree.map(np.asarray, jax.device_get(jl.variables))
    jl.request_resize(2)
    jl.fit(EPOCHS, LR)
    assert dict(jl.mesh.shape) == {"data": 2, "fsdp": 1}
    want = flax_to_state_dict(
        {"params": jax.tree.map(np.asarray,
                                jax.device_get(jl.variables["params"]))})

    pcfg = get_cfg_with_overrides("rsz_port", **over)
    model = psel.build_model(pcfg, build_comm(pcfg))
    model.load_state_dict(flax_to_state_dict(tree), strict=True)
    outs = {}
    for tag, nproc, extra in (("port", 4, {}),
                              ("no_adam", 2, {"drop_adam": True})):
        case = {"name": tag, "model": model, "cfg": over, "lr": LR,
                "epochs": EPOCHS, "resize": nproc // 2, **extra}
        path = tmp / f"{tag}.pt"
        torch.save(case, path)
        outs[tag], _ = launch("fit", {"cases": [str(path)],
                                      "tmp": str(tmp / tag)},
                              tmp / tag, nproc=nproc, timeout=300)
    return {"want": want, "outs": outs,
            "jax_log": jl.txt_log_file.read_text()}


def _max_err(got, want):
    return max(float((got[k].double() - torch.from_numpy(
        np.asarray(v, np.float64))).abs().max()) for k, v in want.items())


def test_port_resize_equals_jax_resize(runs):
    """Both runs resized at epoch 1 from ``[2, 2]`` to ``[2, 1]``; the
    port's survivors' parameters within ATOL of JAX's."""
    assert "elastic resize at epoch 1" in runs["jax_log"]
    outs = runs["outs"]["port"]
    survivors = [o["port"] for o in outs if not o["port"]["left"]]
    assert len(survivors) == 2 and all(o["port"]["left"] for o in outs[2:])
    for res in survivors:
        assert res["error"] is None and res["mesh"] == {"data": 2, "fsdp": 1}
        assert len(res["losses"]) == 2 * EPOCHS
        err = _max_err(res["state_dict"], runs["want"])
        assert err <= ATOL, err
    assert "elastic resize at epoch 1: {'data': 2, 'fsdp': 2} -> " \
        "{'data': 2, 'fsdp': 1}" in survivors[0]["log"]


def test_epoch_losses_equal_jax(runs):
    """Each epoch's mean train loss (the txt log's row, 4 decimals in the
    JAX package's) within 1e-4 of JAX's."""
    rows = [ln.split() for ln in runs["jax_log"].splitlines()
            if ln[:1].isdigit()]
    want = [float(r[1]) for r in rows]
    got = runs["outs"]["port"][0]["port"]["losses"]
    per = len(got) // EPOCHS
    means = [float(np.mean(got[e * per:(e + 1) * per]))
             for e in range(EPOCHS)]
    assert len(want) == EPOCHS
    assert all(abs(a - b) <= 1e-4 for a, b in zip(means, want)), (means,
                                                                   want)


def test_resize_without_adam_state_is_the_control(runs):
    """Adam's moments and step counts left out at the resize: beyond ATOL
    (3.2e-3 here, against 1.4e-4 for the sound resize)."""
    res = runs["outs"]["no_adam"][0]["no_adam"]
    assert res["error"] is None and not res["left"]
    assert _max_err(res["state_dict"], runs["want"]) > ATOL

