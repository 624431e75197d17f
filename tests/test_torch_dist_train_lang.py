"""Data-parallel SRL and evrel training in the port against the JAX
package's step over the global batch, on the CPU at tiny widths: one
Adam(0.9, 0.99) step of ``sfpret_txe_txd_vbarg`` and of ``rob_evrel`` over
2 gloo ranks x 1 video (tests/torch_dist_child.py, mode ``steps``) equals
JAX's float64 step over the 2-video batch, with every dropout rate 0. The
labels' pads are split unevenly between the ranks (SRL: 141 against 154
real tokens; evrel: 2 against 4 real relations), so a per-rank mean would
fail. Limits are those of tests/test_torch_srl_train.py's ``check_step``.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_evrel import TINY_ROB, evrel_cfg
from tests.test_torch_srl_train import (
    LR,
    _f64_pair,
    check_step,
    jax_adam_step,
)
from tests.test_torch_transformer import srl_cfg
from tests.torch_dist_child import launch
from vidsitu_tpu.data import build_comm, get_data
from vidsitu_tpu_torch.convert.from_flax import (
    flax_to_state_dict,
    seeded_variables,
)
from vidsitu_tpu_torch.data.synth import make_synth_dataset
from vidsitu_tpu_torch.models import selector as psel
from vidsitu_tpu_torch.models.evrel_models import EvrelModel
from vidsitu_tpu.models import selector as jsel

torch.set_num_threads(1)


def _evrel_pair(cfg, comm):
    """As tests/test_torch_evrel.py's step test: float64, dropout 0."""
    pm = psel.build_model(cfg, comm)
    tree = seeded_variables(pm, 3)
    jm = jsel.build_model(cfg, comm)
    jm = jm.clone(rob_cfg=dataclasses.replace(
        jm.rob_cfg, dtype=jnp.float64, param_dtype=jnp.float64))
    pm = EvrelModel(pm.mdl_name, dataclasses.replace(
        pm.rob_cfg, dtype=torch.float64, dropout=0.0), pm.feat_dim)
    pm.load_state_dict(flax_to_state_dict(tree), strict=True)
    return jm, pm.double(), tree


def _split(batch):
    return [{k: v[r:r + 1] for k, v in batch.items()} for r in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_lang")
    paths = make_synth_dataset(tmp / "data", n_train=4, n_valid=3, n_test=1,
                               seed=7)
    srl = srl_cfg(paths, tmp, "sfpret_txe_txd_vbarg",
                  **{"tx_dec.dropout": 0.0})
    evrel = evrel_cfg(paths, tmp, "rob_evrel")
    cases, refs = [], {}
    for name, cfg in (("srl", srl), ("evrel", evrel)):
        comm = build_comm(cfg)
        batch = next(iter(get_data(cfg).train_dl))
        if name == "srl":
            jm, pm, tree = _f64_pair(cfg, comm, seed=3)
        else:
            batch["evrel_labs"] = batch["evrel_labs"].copy()
            batch["evrel_labs"][0, 1:3] = -1
            jm, pm, tree = _evrel_pair(cfg, comm)
        refs[name] = {"ref": jax_adam_step(jm, tree, batch), "batch": batch,
                      "model": pm, "comm": comm}
        path = tmp / f"{name}.pt"
        torch.save({"name": name, "model": pm, "lr": LR,
                    "cfg": {"task_type": cfg.task_type,
                            "mdl.mdl_name": cfg.mdl.mdl_name,
                            "train.dtype": "float32", **TINY_ROB},
                    "batches": [_split(batch)]}, path)
        cases.append(str(path))
    outs, _ = launch("steps", {"cases": cases, "tmp": str(tmp / "logs")},
                     tmp)
    return refs, outs


@pytest.mark.parametrize("name", ["srl", "evrel"])
def test_step_over_two_ranks_matches_jax_global_batch(runs, name):
    refs, outs = runs
    r = refs[name]
    if name == "srl":
        pad = r["comm"].gpt2_hf_tok.pad_token_id
        real = [(r["batch"]["seq_out_by_ev"][i] != pad).sum() for i in (0, 1)]
    else:
        real = [(r["batch"]["evrel_labs"][i] != -1).sum() for i in (0, 1)]
    assert real[0] != real[1], real
    out = outs[0][name]
    model = r["model"]
    model.load_state_dict(out["state_dict"], strict=True)
    (loss,) = out["losses"]
    check_step(r["ref"], loss, out["grads"], model)
    assert outs[1][name]["losses"] == out["losses"]
    for k, v in out["state_dict"].items():
        assert torch.equal(v, outs[1][name]["state_dict"][k]), k
