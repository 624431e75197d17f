"""``train.dtype=float16`` on the I3D-NL in the port (vidsitu_tpu_torch)
against the JAX package at ``dtype=float16`` (float32 parameters), on the
CPU at tiny sizes: the hand-built I3D with ``nl_1`` in s3 and s4, one seeded
flax tree with non-zero BatchNorm gammas, 2 videos = 10 clips.

  * the train-mode logits and loss (BatchNorm on batch statistics) within
    2e-2 of the logits' scale, and the updated running statistics in
    float32;
  * the gradients of the non-local blocks' leaves, with each non-local
    block's attention run through ``NonLocalAttnFn`` wired to the tiled
    plain versions (the kernels' float16 arithmetic: P and dS rounded to
    float16, dS under its power-of-two scale) against ``jax.grad``, within
    5e-2 of each leaf's scale, where the leaf is well-conditioned (the JAX
    package's own float16 gradient within WELL_COND of its float32 one; a
    BatchNorm after a non-local block divides by the small batch deviation
    of its input at seeded weights, ROADMAP Queue 3), and elsewhere no
    further from JAX's float16 gradient than twice JAX's own float16 error
    (its distance to its float32 gradient). The wiring's calls are counted:
    2 forward and 2 backward a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_video_backbone import init_shapes, seeded_tree
from tests.vb_train_parity import MODELS, N_CLASSES, _batch, _cfg
from vidsitu_tpu.models import video_backbone as jvb
from vidsitu_tpu.models.vb_models import VbVideoModel as JaxVbModel
from vidsitu_tpu_torch.convert.from_flax import flax_to_state_dict
from vidsitu_tpu_torch.models import video_backbone as tvb
from vidsitu_tpu_torch.models.vb_models import VbVideoModel as TorchVbModel
from vidsitu_tpu_torch.ops import attention as A
from vidsitu_tpu_torch.train.learner import Learner

torch.set_num_threads(1)

LOGIT_TOL, GRAD_TOL, WELL_COND, GRAD_FLOOR = 2e-2, 5e-2, 2.5e-2, 1e-3
# well-conditioned non-local leaves at these sizes: 4 of 20 (s3 phi's bias;
# s4 phi's and g's biases, the BatchNorm bias)
MIN_HELD = 3
FIELDS = MODELS["i3d_nl"]


def _jax_model(dtype):
    return JaxVbModel(jvb.VideoCfg(**FIELDS, dtype=dtype,
                                   param_dtype=jnp.float32),
                      num_classes=N_CLASSES)


@pytest.fixture(scope="module")
def ref():
    """JAX at float16 and at float32 on one seeded tree: train-mode
    logits, loss, statistics and gradients."""
    batch = _batch("i3d")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tree = seeded_tree(init_shapes(_jax_model(jnp.float32), jb), 21)
    out = {"tree": tree, "batch": batch}
    for name, dt in (("f16", jnp.float16), ("f32", jnp.float32)):
        model = _jax_model(dt)

        def loss_fn(p, s):
            res, new = model.apply({"params": p, "batch_stats": s}, jb,
                                   deterministic=False,
                                   mutable=["batch_stats"])
            return res["loss"], (res["mdl_out"], new["batch_stats"])

        (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(tree["params"], tree["batch_stats"])
        out[name] = {"loss": float(loss),
                     "logits": np.asarray(logits, np.float32),
                     "stats": jax.tree.map(np.asarray, stats),
                     "grads": jax.tree.map(
                         lambda g: np.asarray(g, np.float32), grads)}
    return out


def _port_model(ref):
    model = TorchVbModel(tvb.VideoCfg(**FIELDS, dtype=torch.float16),
                         num_classes=N_CLASSES)
    model.load_state_dict(flax_to_state_dict(ref["tree"]), strict=True)
    return model


def _batch_t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_float16_train_mode_logits_match_jax(ref):
    model = _port_model(ref).train()
    with torch.no_grad():
        out = model(_batch_t(ref["batch"]))
    want = ref["f16"]["logits"]
    assert out["mdl_out"].dtype == torch.float16
    np.testing.assert_allclose(out["mdl_out"].float().numpy(), want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())
    assert abs(float(out["loss"]) - ref["f16"]["loss"]) <= (
        LOGIT_TOL * abs(ref["f16"]["loss"]))
    want_stats = flax_to_state_dict({"batch_stats": ref["f16"]["stats"]})
    got = model.state_dict()
    for n, w in want_stats.items():
        if "running" in n:
            assert got[n].dtype == torch.float32, n
            np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=0,
                                       atol=LOGIT_TOL * float(w.abs().max()),
                                       err_msg=n)


@pytest.fixture
def tiled_function(monkeypatch):
    """NonLocalAttnFn with the tiled plain versions (each entry's tiles, as
    routed for the input) in place of the kernels, counting calls."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, kind, scale):
        calls["fwd"] += 1
        assert q.dtype == torch.float16
        return A.attention_tiled_reference(
            q, k, v, kind, scale, A.wgmma_block_k(q.shape[-1]),
            return_lse=True)

    def bwd(q, k, v, o, do, lse, kind, scale):
        calls["bwd"] += 1
        return A.attention_backward_tiled_reference(
            q, k, v, o, do, lse, kind, scale,
            entry=A.bwd_kernel_entry(q.dtype, q.shape[-1]))

    monkeypatch.setattr(A.NonLocalAttnFn, "forward_impl", staticmethod(fwd))
    monkeypatch.setattr(A.NonLocalAttnFn, "backward_impl", staticmethod(bwd))
    return calls


def test_float16_nonlocal_gradients_match_jax(ref, tiled_function, tmp_path):
    model = _port_model(ref)
    for m in model.modules():
        if isinstance(m, tvb.NonLocalBlock):
            m.attention = A.NonLocalAttnFn.apply
    learner = Learner("t", _cfg(tmp_path, **{"train.dtype": "float16"}),
                      model, None, None, "cpu")
    learner.prepare_optimizer(1e-3)
    grads = {}
    step = learner.optimizer.step

    def keep_grads_then_step():
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        step()

    learner.optimizer.step = keep_grads_then_step
    loss = float(learner.train_step(_batch_t(ref["batch"])))
    assert tiled_function == {"fwd": 2, "bwd": 2}
    assert abs(loss - ref["f16"]["loss"]) <= LOGIT_TOL * abs(ref["f16"]["loss"])
    want = flax_to_state_dict({"params": ref["f16"]["grads"]})
    g32 = flax_to_state_dict({"params": ref["f32"]["grads"]})
    floor = GRAD_FLOOR * max(float(v.abs().max()) for v in g32.values())
    nl = [n for n in grads if ".nl_1." in n]
    assert len(nl) == 2 * 10  # theta, phi, g, out (weight, bias), bn (2)
    held = 0
    for n in nl:
        scale = max(float(want[n].abs().max()), floor)
        cond = float((want[n] - g32[n]).abs().max()) / max(
            float(g32[n].abs().max()), floor)
        err = float((grads[n].float() - want[n]).abs().max()) / scale
        assert grads[n].dtype == torch.float32, n
        if cond < WELL_COND:
            held += 1
            assert err <= GRAD_TOL, (n, err, cond)
        else:  # no further from JAX's than twice JAX's own float16 error
            assert err <= 2 * cond, (n, err, cond)
    assert held >= MIN_HELD, held
