"""Data-parallel verb-model training in the port against the JAX package's
one program over the global batch, on the CPU: 2 gloo ranks x 1 video
(tests/torch_dist_child.py, mode ``steps``) against ``jax.value_and_grad``
+ ``optax.adam`` of the 2-video batch, in float64, for the hand-built
I3D-NL and the depth-26 SlowFast of tests/vb_train_parity.py.

The pad labels (-1) are split unevenly between the ranks (2 on rank 0, 0
on rank 1), so a per-rank mean of the loss would fail; BatchNorm takes the
global batch's statistics (a per-rank BatchNorm would fail too). Limits are
the harness's: each gradient within 1e-4 of its scale, the loss and the
BatchNorm running statistics within 1e-5. ``train.grad_accum=2`` over two
global batches equals ``optax.MultiSteps``. Both ranks end with the same
weights and statistics, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_video_backbone import init_shapes, seeded_tree
from tests.torch_dist_child import launch
from tests.vb_train_parity import (
    LOSS_TOL,
    LR,
    MODELS,
    N_CLASSES,
    STAT_TOL,
    _batch,
    _check_grads,
    _check_params,
    _check_stats,
    _jax_model,
    _jax_step,
)
from vidsitu_tpu_torch.convert.from_flax import flax_to_state_dict
from vidsitu_tpu_torch.models import video_backbone as tvb
from vidsitu_tpu_torch.models.vb_models import VbVideoModel as TorchVbModel

torch.set_num_threads(1)

# rank 0's video has two pad labels, rank 1's none (second batch: 3 and 1)
LABELS = (np.array([[1, -1, -1, 3, 0], [6, 5, 2, 2, 4]]),
          np.array([[-1, 2, -1, -1, 0], [3, -1, 6, 1, 1]]))


def _global_batches(arch):
    out = []
    for seed, labels in enumerate(LABELS):
        b = _batch(arch, seed=seed)
        b["label_tensor"] = labels
        out.append(b)
    return out


def _rank_batches(batch):
    """Rank r's share of a 2-video batch: video r, its 5 clips."""
    return [{k: v[5 * r:5 * r + 5] if k.startswith("frms") else v[r:r + 1]
             for k, v in batch.items()} for r in range(2)]


def _model(name, tree):
    model = TorchVbModel(tvb.VideoCfg(**MODELS[name], dtype=torch.float64),
                         num_classes=N_CLASSES)
    model.load_state_dict(flax_to_state_dict(tree), strict=True)
    return model.double()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX float64 references and one 2-rank launch over every case."""
    tmp = tmp_path_factory.mktemp("dist_vb")
    refs, cases = {}, []
    for name in ("i3d_nl", "slowfast26"):
        fields = MODELS[name]
        batches = _global_batches(fields["arch"])
        tree = seeded_tree(init_shapes(_jax_model(fields, jnp.float32), {
            k: jnp.asarray(v) for k, v in batches[0].items()}), 11)
        refs[name] = {"tree": tree}
        for case, kw, steps in ((name, {}, batches[:1]),
                                (f"{name}_accum", {"train.grad_accum": 2},
                                 batches)):
            if case == "slowfast26_accum":
                continue
            path = tmp / f"{case}.pt"
            torch.save({"name": case, "model": _model(name, tree),
                        "cfg": {"task_type": "vb", "train.dtype": "float32",
                                **kw},
                        "lr": LR,
                        "batches": [_rank_batches(b) for b in steps]}, path)
            cases.append(str(path))
        refs[name]["batches"] = batches
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        for name, r in refs.items():
            r["f64"] = _jax_step(MODELS[name], r["tree"], r["batches"])
    finally:
        jax.config.update("jax_enable_x64", prev)
    outs, _ = launch("steps", {"cases": cases, "tmp": str(tmp / "logs")},
                     tmp)
    return refs, outs


def _with_grads(name, tree, out):
    model = _model(name, tree)
    model.load_state_dict(out["state_dict"], strict=True)
    for n, p in model.named_parameters():
        p.grad = out["grads"][n]
    return model


@pytest.mark.parametrize("name", ["i3d_nl", "slowfast26"])
def test_step_over_two_ranks_matches_jax_global_batch(runs, name):
    refs, outs = runs
    ref = refs[name]["f64"]
    labels = LABELS[0]
    assert (labels[0] == -1).sum() != (labels[1] == -1).sum()
    for out in outs:
        (loss,) = out[name]["losses"]
        assert abs(loss - ref["loss"]) <= LOSS_TOL * abs(ref["loss"])
    model = _with_grads(name, refs[name]["tree"], outs[0][name])
    _check_grads(model, ref["grads"])
    _check_params(model, ref["grads"], ref["params"])
    _check_stats(model, ref["stats"], STAT_TOL)


def test_grad_accum_over_two_ranks_matches_multisteps(runs):
    refs, outs = runs
    ref = refs["i3d_nl"]["f64"]
    model = _with_grads("i3d_nl", refs["i3d_nl"]["tree"],
                        outs[0]["i3d_nl_accum"])
    _check_params(model, ref["accum_grads"], ref["accum_params"])
    _check_stats(model, ref["accum_stats"], STAT_TOL)
    # the first step's loss is the global one; no update after it
    assert abs(outs[0]["i3d_nl_accum"]["losses"][0] - ref["loss"]) <= (
        LOSS_TOL * abs(ref["loss"]))


@pytest.mark.parametrize("case", ["i3d_nl", "slowfast26", "i3d_nl_accum"])
def test_ranks_end_with_the_same_state(runs, case):
    _, outs = runs
    a, b = (o[case] for o in outs)
    assert a["losses"] == b["losses"]
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
