"""``train.param_dtype=bfloat16`` across checkpoints and ranks in the port
(vidsitu_tpu_torch), on the CPU at tiny widths:

  * a checkpoint round trip, both backends (``pickle``, ``orbax``):
    parameters and Adam's moments come back bitwise, in bfloat16, and the
    next step of the resumed run equals the straight run's bitwise;
  * a float32 checkpoint resumed with ``train.param_dtype=bfloat16`` keeps
    float32 parameters and takes float32 Adam, as the JAX package's restore
    (flax's ``from_state_dict`` keeps the saved arrays' dtype);
  * one step over 2 gloo ranks (tests/torch_dist_child.py, mode ``steps``)
    and in one process, ``sfpret_txe_txd_vbarg`` and the I3D-NL, dropout
    0: both within the limits of tests/test_torch_param_dtype.py's
    ``check_half_step`` against the JAX package's bfloat16 step over the
    global batch, the ranks' results equal to each other (gloo sums the
    gradients in bfloat16).
"""

import copy

import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from tests.test_torch_param_dtype import (
    LR,
    _lang_models,
    _vb_models,
    check_half_step,
    jax_half_steps,
)
from tests.test_torch_transformer import to_torch
from tests.torch_dist_child import launch, run_case
from vidsitu_tpu.data.synth import make_synth_dataset
from vidsitu_tpu_torch.train.adam import HalfAdam
from vidsitu_tpu_torch.train.learner import Learner

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lang_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_param_dtype_ckpt")
    paths = make_synth_dataset(root / "data", n_train=4, n_valid=3, n_test=1,
                               seed=13)
    return paths, root


def _learner(model, cfg, backend):
    cfg = cfg.clone()
    cfg.defrost()
    cfg.train.ckpt_backend = backend
    learner = Learner("t", cfg, model, None, None, "cpu")
    return learner


@pytest.mark.parametrize("backend", ["pickle", "orbax"])
def test_bf16_checkpoint_round_trip_is_bitwise(lang_env, tmp_path, backend):
    _, _, pm, tree, batches, cfg = _lang_models(lang_env, "vb_arg",
                                                "tx_only")
    fresh = copy.deepcopy(pm)
    a = _learner(pm, cfg, backend)
    a.prepare_optimizer(LR)
    a.train_step(to_torch(batches[0]))
    a.num_it = 1
    path = tmp_path / "bf16.ckpt"
    a.save_model_dict(path)
    a.ckpt_backend.wait()
    b = _learner(fresh, cfg, backend)
    b.load_model_dict(str(path), load_opt=True)
    b.prepare_optimizer(LR)
    assert isinstance(b.optimizer, HalfAdam)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for n, v in sa.items():
        assert sb[n].dtype == v.dtype and torch.equal(sb[n], v), n
    assert {v.dtype for n, v in sb.items() if "running" not in n
            and v.is_floating_point()} == {torch.bfloat16}
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in oa["state"].items():
        for f in ("exp_avg", "exp_avg_sq"):
            assert ob["state"][i][f].dtype == torch.bfloat16
            assert torch.equal(ob["state"][i][f], st[f]), (i, f)
        assert float(ob["state"][i]["step"]) == float(st["step"]) == 1
    a.train_step(to_torch(batches[1]))
    b.train_step(to_torch(batches[1]))
    for n, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[n], v), n


def test_float32_checkpoint_resumes_in_float32_as_jax(lang_env, tmp_path):
    """The JAX package's restore (``serialization.from_state_dict`` of both
    backends) returns the saved float32 arrays into a bfloat16 target; the
    port's resumed parameters, and so its Adam, stay float32 as well."""
    _, _, pm16, tree, batches, cfg16 = _lang_models(lang_env, "vb_arg",
                                                    "tx_only")
    cfg32 = cfg16.clone()
    cfg32.defrost()
    cfg32.train.dtype = cfg32.train.param_dtype = "float32"
    pm32 = copy.deepcopy(pm16).float()
    a = Learner("t", cfg32, pm32, None, None, "cpu")
    a.prepare_optimizer(LR)
    a.train_step(to_torch(batches[0]))
    path = tmp_path / "f32.ckpt"
    a.save_model_dict(path)
    b = Learner("t", cfg16, pm16, None, None, "cpu")
    b.load_model_dict(str(path), load_opt=True)
    b.prepare_optimizer(LR)
    target = {"w": jnp.zeros(3, jnp.bfloat16)}
    restored = serialization.from_state_dict(
        target, {"w": a.model.state_dict()[
            "decoder.layers_0.ffn.fc1.bias"][:3].numpy()})
    assert restored["w"].dtype == jnp.float32
    assert {p.dtype for p in pm16.parameters()} == {torch.float32}
    assert type(b.optimizer) is torch.optim.Adam
    sa = a.model.state_dict()
    for n, v in b.model.state_dict().items():
        assert torch.equal(v, sa[n]), n
    b.train_step(to_torch(batches[1]))
    assert {st["exp_avg"].dtype for st in b.optimizer.state.values()} == {
        torch.float32}


@pytest.fixture(scope="module")
def two_ranks(lang_env, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("param_dtype_ranks")
    cases, refs = [], {}
    for name in ("srl", "i3d"):
        if name == "srl":
            jm, jm32, pm, tree, batches, cfg = _lang_models(
                lang_env, "vb_arg", "sfpret_txe_txd_vbarg")
            over = {"task_type": "vb_arg",
                    "mdl.mdl_name": "sfpret_txe_txd_vbarg"}
        else:
            jm, jm32, pm, tree, batches, cfg = _vb_models(tmp)
            over = {"task_type": "vb"}
        batch = batches[0]
        n = len(batch["vseg_idx"]) if "vseg_idx" in batch else 2
        split = [{k: v[r::2] if len(v) == n else v[5 * r:5 * r + 5]
                  for k, v in batch.items()} for r in range(2)]
        refs[name] = {"ref": jax_half_steps(jm, jm32, tree, [batch],
                                            vb=name == "i3d"),
                      "tree": tree, "model": copy.deepcopy(pm),
                      "one": None}
        case = {"name": name, "model": pm, "lr": LR,
                "cfg": {**over, "train.dtype": "bfloat16",
                        "train.param_dtype": "bfloat16"},
                "batches": [split]}
        path = tmp / f"{name}.pt"
        torch.save(case, path)
        cases.append(str(path))
        one = dict(case, model=copy.deepcopy(refs[name]["model"]),
                   batches=[[batch]])
        refs[name]["one"] = run_case(one, 0, str(tmp / "one"))
    outs, _ = launch("steps", {"cases": cases, "tmp": str(tmp / "logs")},
                     tmp)
    return refs, outs


@pytest.mark.parametrize("name", ["srl", "i3d"])
def test_bf16_step_over_two_ranks(two_ranks, name):
    refs, outs = two_ranks
    r = refs[name]
    for res in (outs[0][name], r["one"]):
        model = copy.deepcopy(r["model"])
        model.load_state_dict(res["state_dict"], strict=True)
        (loss,) = res["losses"]
        check_half_step(r["ref"], r["tree"], loss, res["grads"], model,
                        torch.bfloat16)
    assert outs[1][name]["losses"] == outs[0][name]["losses"]
    for k, v in outs[0][name]["state_dict"].items():
        assert v.dtype == r["one"]["state_dict"][k].dtype, k
        assert torch.equal(v, outs[1][name]["state_dict"][k]), k
