"""The verb model's training step in the port against the JAX package on
the depth-26 SlowFast preset (32 px, T = 4; tests/vb_train_parity.py has
the harness and its tolerances): one Adam step, the float32 step, remat of
the stems and of s2 / s3, gradient accumulation, BatchNorm statistics in
bf16. tests/test_torch_vb_train.py holds the hand-built I3D-NL.
"""

import pytest
import torch

from tests import vb_train_parity as V

torch.set_num_threads(1)

NAME = "slowfast26"


@pytest.fixture(scope="module")
def ref():
    return V.build_ref([NAME])


def test_train_step_matches_jax(ref, tmp_path):
    V.check_train_step(ref, tmp_path, NAME)


def test_float32_step_matches_jax_float32(ref, tmp_path):
    V.check_float32_step(ref, tmp_path, NAME)


def test_remat_same_gradients_and_stats_updated_once(ref, tmp_path):
    V.check_remat(ref, tmp_path, NAME, remat_stages=(-1, 0, 1))


def test_grad_accum_two_batches_equals_multisteps(ref, tmp_path):
    V.check_grad_accum(ref, tmp_path, NAME)


def test_bn_bf16_stats_runs_close_to_float32_stats(ref, tmp_path):
    """bn_f32_stats=False reduces the batch statistics in bf16: the loss
    stays within bf16 of the default, and the running statistics move."""
    r = ref[NAME]
    losses = {}
    for f32 in (True, False):
        learner = V._learner(tmp_path, NAME, ref, bn_f32_stats=f32,
                             dtype=torch.bfloat16)
        losses[f32] = float(learner.train_step(V._torch_batch(
            r["batches"][0])))
        stats = learner.model.state_dict()
        assert torch.isfinite(stats["backbone.s2_slow.block_0.a.bn."
                                    "running_var"]).all()
    assert abs(losses[True] - losses[False]) <= 0.05 * abs(losses[True])
    assert abs(losses[True] - r["f64"]["loss"]) <= 0.05 * r["f64"]["loss"]
