"""``train.param_dtype=bfloat16`` training steps of the I3D-NL and a
``grad_accum`` cycle in the port against the JAX package and optax, on the
CPU at tiny sizes, with the limits of tests/test_torch_param_dtype.py's
``check_half_step`` (kept apart from that file to hold each under about 90
s):

  * one ``Learner.train_step`` of the hand-built I3D-NL (``nl_1`` in s3
    and s4) in bfloat16, dropout 0, against the JAX model and
    ``optax.inject_hyperparams(adam)``: loss, well-conditioned gradients,
    updated parameters (the lr-doubled control outside), BatchNorm
    statistics in float32 within 5e-2 of their scale;
  * a ``grad_accum=2`` cycle of ``tx_only`` and of the I3D-NL against
    ``optax.MultiSteps(k=2)``: nothing moves after the first batch, then one
    update with the two batches' mean gradient (the port sums ``loss / 2``
    gradients in bfloat16 where MultiSteps keeps a running mean).
"""

import copy

import pytest
import torch

from tests.test_torch_param_dtype import (  # noqa: F401  (lang_env: fixture)
    LR,
    _check_stats,
    _lang_models,
    _vb_models,
    check_half_step,
    jax_half_steps,
    keep_grads_then_step,
    lang_env,
    port_half_steps,
)
from tests.test_torch_transformer import to_torch
from vidsitu_tpu_torch.train.adam import HalfAdam
from vidsitu_tpu_torch.train.learner import Learner

torch.set_num_threads(1)


def test_bf16_step_matches_optax_i3d_nl(tmp_path):
    jm, jm32, pm, tree, batches, cfg = _vb_models(tmp_path)
    pm0 = copy.deepcopy(pm)
    ref = jax_half_steps(jm, jm32, tree, batches[:1], vb=True)
    loss, grads, model, learner = port_half_steps(pm, cfg, batches[:1])
    assert isinstance(learner.optimizer, HalfAdam)
    check_half_step(ref, tree, loss, grads, model, torch.bfloat16)
    _check_stats(model, ref["stats"])
    _, grads2, model2, _ = port_half_steps(pm0, cfg, batches[:1], 2 * LR)
    n_out = check_half_step(ref, tree, loss, grads2, model2, torch.bfloat16,
                            control=True)
    assert n_out >= len(grads2) // 2, (n_out, len(grads2))


@pytest.mark.parametrize("model", ["tx_only", "i3d_nl"])
def test_bf16_grad_accum_matches_multisteps(lang_env, tmp_path, model):
    """``train.grad_accum=2``: nothing moves after the first batch, then one
    update with the two batches' mean gradient, against MultiSteps(k=2)."""
    if model == "i3d_nl":
        jm, jm32, pm, tree, batches, cfg = _vb_models(
            tmp_path, **{"train.grad_accum": 2})
    else:
        jm, jm32, pm, tree, batches, cfg = _lang_models(
            lang_env, "vb_arg", model, **{"train.grad_accum": 2})
    vb = model == "i3d_nl"
    ref = jax_half_steps(jm, jm32, tree, batches, vb=vb, accum=2)
    assert ref["mu_dtypes"] == {"bfloat16"}
    before = copy.deepcopy(pm.state_dict())
    learner = Learner("t", cfg, pm, None, None, "cpu")
    learner.prepare_optimizer(LR)
    learner.train_step(to_torch(batches[0]))
    assert all(torch.equal(p, before[n]) for n, p in pm.named_parameters())
    assert {p.grad.dtype for p in pm.parameters() if p.grad is not None} == {
        torch.bfloat16}
    grads = {}
    learner.optimizer.step = keep_grads_then_step(learner, grads)
    learner.train_step(to_torch(batches[1]))
    check_half_step(ref, tree, None, grads, pm, torch.bfloat16)
    if vb:
        _check_stats(pm, ref["stats"])


