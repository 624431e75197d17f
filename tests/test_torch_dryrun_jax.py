"""The dry run's one-process step (``vidsitu_tpu_torch.dryrun.one_step``)
against the JAX entry's (``__graft_entry__._one_step`` on a 1-device
mesh): for each of the three tasks, from the JAX entry's own seeded tree
and batch, with every dropout rate 0, the loss within 1e-5 relative in
float32. (Its own file: the 4-rank dry run of tests/test_torch_dryrun.py
fills that file's time.)"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import __graft_entry__ as g
from vidsitu_tpu_torch import dryrun
from vidsitu_tpu_torch.convert.from_flax import flax_to_state_dict
from vidsitu_tpu_torch.data import build_comm
from vidsitu_tpu_torch.data.synth import make_synth_dataset
from vidsitu_tpu_torch.models import selector as psel
from vidsitu_tpu_torch.models.evrel_models import EvrelModel

torch.set_num_threads(1)

NO_DROPOUT = {"vb_arg": {"tx_dec.dropout": 0.0}, "vb": {}, "evrel": {}}


@pytest.mark.parametrize("task,mdl,extra,frames", g._DRYRUN_TASKS,
                         ids=[t[0] for t in g._DRYRUN_TASKS])
def test_one_process_step_loss_equals_jax(task, mdl, extra, frames):
    extra = {**extra, **NO_DROPOUT[task]}
    cfg, model, variables, batch = g._setup(
        bs=2, task_type=task, mdl_name=mdl, extra=extra, with_frames=frames)
    if task == "evrel":
        model = model.clone(rob_cfg=dataclasses.replace(model.rob_cfg,
                                                        dropout=0.0))
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    want = g._one_step(model, variables, batch, mesh)[0]

    # the JAX entry's tree (idempotent: the same files and paths)
    root = g._SYNTH_FRAMES_DIR if frames else g._SYNTH_DIR
    paths = make_synth_dataset(root, n_train=8, n_valid=5, seed=0,
                               with_frames=frames)
    pcfg = dryrun._cfg(paths, root, task, mdl, extra, 2)
    pm = psel.build_model(pcfg, build_comm(pcfg))
    if task == "evrel":
        pm = EvrelModel(pm.mdl_name, dataclasses.replace(
            pm.rob_cfg, dropout=0.0), pm.feat_dim)
    host = jax.tree.map(np.asarray, jax.device_get(variables))
    pm.load_state_dict(flax_to_state_dict(host), strict=True)
    got = dryrun.one_step(pcfg, pm, batch, torch.device("cpu"))["loss"]
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
