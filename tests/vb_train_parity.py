"""Shared by tests/test_torch_vb_train*.py: one verb-model train step of the
port (vidsitu_tpu_torch) against the JAX
package's: ``jax.value_and_grad`` of ``VbVideoModel`` with mutable batch
statistics, then ``optax.adam(b1=0.9, b2=0.99)``, as its Learner runs them
(vidsitu_tpu/train/learner.py:203-289).

Two models at tiny sizes: the depth-26 SlowFast preset (32 px, T = 4) and
a hand-built I3D with non-local blocks ``nl_1`` in s3 and s4. One seeded
numpy tree each, with non-zero BatchNorm gammas and positive non-unit
running variances, goes to JAX as is and to the port through
``flax_to_state_dict``; 2 videos = 10 clips of seeded uint8 frames, labels
with pad entries (-1). The port's step is ``Learner.train_step``.

The gradients are compared in float64 on both sides (``jax_enable_x64``
for the fixture only). In float32 they are not a test of the port: at
seeded weights a non-local block's output varies little across positions,
so the BatchNorm after it divides by a small batch deviation and magnifies
any rounding of the attention, and flax's BatchNorm takes the variance as
E[x^2] - E[x]^2, whose cancellation adds more; the float32 JAX gradients
differ from its own float64 ones by percents of a leaf's scale at these
sizes. In float64 the port is held at 1e-4 of each gradient's scale, the
loss at 1e-5 and the statistics at 1e-5 of their scale; in float32 the loss
and the statistics are held to the float32 JAX step at the same limits.
Adam's first update is about lr * sign(g): where |g_ref| lies within the
gradient tolerance its sign is not determined, and the update may differ
by 2 lr there; elsewhere it is held to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tests.test_torch_video_backbone import init_shapes, seeded_tree
from vidsitu_tpu.models import video_backbone as jvb
from vidsitu_tpu.models.vb_models import VbVideoModel as JaxVbModel
from vidsitu_tpu_torch.convert.from_flax import flax_to_state_dict
from vidsitu_tpu_torch.models import video_backbone as tvb
from vidsitu_tpu_torch.models.vb_models import VbVideoModel as TorchVbModel
from vidsitu_tpu_torch.train.learner import Learner
from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

torch.set_num_threads(1)

LR = 1e-3
N_CLASSES = 7
GRAD_TOL, STAT_TOL, LOSS_TOL, UPDATE_TOL = 1e-4, 1e-5, 1e-5, 1e-6
FIELDS = ("arch", "depth_blocks", "width", "alpha", "beta_inv",
          "fusion_ratio", "fusion_kernel", "spatial_strides", "nl_location",
          "nl_instantiation", "zero_init_final_bn", "mean", "std",
          "reverse_input_channel")


def _slowfast26():
    cfg = get_cfg_with_overrides("t", **{
        "mdl.sf_mdl_name": "slow_fast_nl_r50_8x8", "vid_mdl.resnet.depth": 26,
        "vid_mdl.crop_size": 32, "vid_mdl.num_frames": 4,
        "train.dtype": "float32"})
    c = tvb.VideoCfg.from_cfg(cfg.vid_mdl)
    return {f: getattr(c, f) for f in FIELDS}


MODELS = {
    "slowfast26": _slowfast26(),
    "i3d_nl": {**{f: getattr(tvb.VideoCfg(), f) for f in FIELDS},
               "arch": "i3d", "depth_blocks": (1, 2, 2, 1),
               "nl_location": (((),), ((1,),), ((1,),), ((),)),
               "nl_instantiation": "softmax"},
}


def _batch(arch, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"frms_ev_fast_tensor": rng.integers(
        0, 256, (10, 4, 32, 32, 3), dtype=np.uint8),
        "label_tensor": np.array([[1, 5, -1, 3, 0], [6, -1, 2, 2, 4]])}
    if arch == "slowfast":
        batch["frms_ev_slow_tensor"] = rng.integers(
            0, 256, (10, 1, 32, 32, 3), dtype=np.uint8)
    if seed:
        batch["label_tensor"] = batch["label_tensor"][::-1].copy()
    return batch


def _jax_model(fields, dtype):
    return JaxVbModel(jvb.VideoCfg(**fields, dtype=dtype, param_dtype=dtype),
                      num_classes=N_CLASSES)


def _jax_step(fields, tree, batches):
    """float64: loss, gradients, updated params and statistics of one Adam
    step on ``batches[0]``; the params and statistics of MultiSteps(k=2)
    after ``batches[0]`` then ``batches[1]``."""
    model = _jax_model(fields, jnp.float64)
    tree = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
    params, stats = tree["params"], tree["batch_stats"]

    def loss_fn(p, stats, b):
        out, new = model.apply({"params": p, "batch_stats": stats}, b,
                               deterministic=False, mutable=["batch_stats"])
        return out["loss"], new["batch_stats"]

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    jbs = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    (loss, new_stats), grads = vg(params, stats, jbs[0])
    opt = optax.adam(LR, b1=0.9, b2=0.99)

    @jax.jit
    def adam_step(grads, params):
        upd, _ = opt.update(grads, opt.init(params), params)
        return optax.apply_updates(params, upd)

    out = {"loss": float(loss), "grads": grads,
           "params": adam_step(grads, params), "stats": new_stats}
    multi = optax.MultiSteps(opt, every_k_schedule=2)

    @jax.jit
    def multi_step(g, st, p):
        u, st = multi.update(g, st, p)
        return optax.apply_updates(p, u), st

    p, st, s, gsum = params, multi.init(params), stats, None
    for jb in jbs:
        (_, s), g = vg(p, s, jb)
        gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
        p, st = multi_step(g, st, p)
    out["accum_params"], out["accum_stats"] = p, s
    out["accum_grads"] = jax.tree.map(lambda x: x / 2, gsum)
    return jax.tree.map(np.asarray, out)


def _jax_forward32(fields, tree, batch):
    """float32: the train-mode loss and the updated statistics."""
    model = _jax_model(fields, jnp.float32)
    out, new = jax.jit(lambda v, b: model.apply(
        v, b, deterministic=False, mutable=["batch_stats"]))(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"loss": float(out["loss"]),
            "stats": jax.tree.map(np.asarray, new["batch_stats"])}


def build_ref(names):
    """The JAX steps of the models ``names``; the float64 flag is set for
    the float64 step only."""
    out = {}
    for name in names:
        fields = MODELS[name]
        batches = [_batch(fields["arch"]), _batch(fields["arch"], seed=1)]
        tree = seeded_tree(init_shapes(_jax_model(fields, jnp.float32), {
            k: jnp.asarray(v) for k, v in batches[0].items()}), 11)
        out[name] = {"tree": tree, "batches": batches,
                     "f32": _jax_forward32(fields, tree, batches[0])}
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        for name in names:
            out[name]["f64"] = _jax_step(MODELS[name], out[name]["tree"],
                                         out[name]["batches"])
    finally:
        jax.config.update("jax_enable_x64", prev)
    return out


def _cfg(tmp_path, **kw):
    return get_cfg_with_overrides("t", **{
        "task_type": "vb", "train.dtype": "float32",
        "misc.tmp_path": str(tmp_path), **kw})


def _learner(tmp_path, name, ref, remat=False, remat_stages=(),
             bn_f32_stats=True, dtype=torch.float64, **cfg_kw):
    """The port's Learner on the seeded tree; float64 unless ``dtype``
    says otherwise (parameters and products alike, or products only for
    bfloat16)."""
    fields = MODELS[name]
    model = TorchVbModel(tvb.VideoCfg(
        **fields, remat=remat, remat_stages=remat_stages,
        bn_f32_stats=bn_f32_stats, dtype=dtype), num_classes=N_CLASSES)
    model.load_state_dict(flax_to_state_dict(ref[name]["tree"]), strict=True)
    if dtype == torch.float64:
        model.double()
    learner = Learner("t", _cfg(tmp_path, **cfg_kw), model, None, None, "cpu")
    learner.prepare_optimizer(LR)
    return learner


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _sd(tree_params, tree_stats=None):
    return flax_to_state_dict({"params": tree_params,
                               "batch_stats": tree_stats or {}})


def _grad_atol(grads):
    """Each leaf's gradient tolerance: GRAD_TOL of its scale, and no less
    than GRAD_TOL of 1e-3 of the largest gradient of the model. A leaf whose
    gradient is zero in exact arithmetic, such as phi's bias under the
    softmax, holds rounding noise only, and the attention computes in
    float32 on both sides whatever the model's dtype (``_einsum_attention``
    casts its inputs)."""
    sd = _sd(grads)
    floor = 1e-3 * max(float(v.abs().max()) for v in sd.values())
    return sd, {n: GRAD_TOL * max(float(v.abs().max()), floor)
                for n, v in sd.items()}


def _check_grads(model, grads):
    want, atol = _grad_atol(grads)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), rtol=0,
                                   atol=atol[n], err_msg=n)


def _check_params(model, grads, params):
    """Updated params: tight where the gradient's sign is determined, within
    2 lr where |g_ref| lies within the gradient tolerance."""
    (g_ref, atol), want = _grad_atol(grads), _sd(params)
    got = model.state_dict()
    for n, _ in model.named_parameters():
        g = g_ref[n].numpy()
        undetermined = np.abs(g) <= atol[n]
        diff = np.abs(got[n].numpy() - want[n].numpy())
        assert diff[~undetermined].max(initial=0) <= UPDATE_TOL, n
        assert diff[undetermined].max(initial=0) <= 2 * LR + UPDATE_TOL, n


def _check_stats(model, stats, tol):
    want = _sd({}, stats)
    got = model.state_dict()
    for n, w in want.items():
        if n.endswith("num_batches_tracked"):
            continue
        w = w.numpy()
        np.testing.assert_allclose(got[n].double().numpy(), w, rtol=0,
                                   atol=tol * np.abs(w).max(), err_msg=n)


def check_train_step(ref, tmp_path, name):
    """Loss, every gradient, every updated parameter and every running
    statistic of one Adam step, against the float64 reference."""
    r = ref[name]
    learner = _learner(tmp_path, name, ref)
    grads = {}
    orig_step = learner.optimizer.step

    def step_and_keep_grads():
        grads.update({n: p.grad.clone() for n, p in
                      learner.model.named_parameters()})
        orig_step()

    learner.optimizer.step = step_and_keep_grads
    loss = float(learner.train_step(_torch_batch(r["batches"][0])))
    assert abs(loss - r["f64"]["loss"]) <= LOSS_TOL * abs(r["f64"]["loss"])
    for n, p in learner.model.named_parameters():
        p.grad = grads[n]
    _check_grads(learner.model, r["f64"]["grads"])
    _check_params(learner.model, r["f64"]["grads"], r["f64"]["params"])
    _check_stats(learner.model, r["f64"]["stats"], STAT_TOL)
    return grads


def check_float32_step(ref, tmp_path, name):
    """In float32 on both sides: the train-mode loss and the updated running
    statistics agree with the JAX package's."""
    r = ref[name]
    learner = _learner(tmp_path, name, ref, dtype=torch.float32)
    loss = float(learner.train_step(_torch_batch(r["batches"][0])))
    assert abs(loss - r["f32"]["loss"]) <= LOSS_TOL * abs(r["f32"]["loss"])
    _check_stats(learner.model, r["f32"]["stats"], STAT_TOL)
    assert all(p.dtype == torch.float32 for p in learner.model.parameters())


def check_remat(ref, tmp_path, name, **remat):
    """Checkpointed blocks recompute their forward in the backward: the same
    gradients, and the running statistics updated once, not twice."""
    r = ref[name]
    runs = []
    for kw in ({}, remat):
        model = _learner(tmp_path, name, ref, **kw).model
        model.train()
        model(_torch_batch(r["batches"][0]))["loss"].backward()
        runs.append(({n: p.grad for n, p in model.named_parameters()},
                     model.state_dict()))
    assert any(getattr(m, "remat", False) for m in model.modules())
    for n, g in runs[0][0].items():
        np.testing.assert_allclose(runs[1][0][n].numpy(), g.numpy(),
                                   rtol=0, atol=1e-9 * g.abs().max().item())
    for n, v in runs[0][1].items():
        if "running" in n:
            assert torch.equal(runs[1][1][n], v), n
    _check_stats(model, r["f64"]["stats"], STAT_TOL)


def check_grad_accum(ref, tmp_path, name):
    """train.grad_accum=2 over two batches: no update after the first, then
    one with the mean of the two gradients, as optax.MultiSteps; the
    statistics move at each step."""
    r = ref[name]
    learner = _learner(tmp_path, name, ref, **{"train.grad_accum": 2})
    before = {n: p.detach().clone()
              for n, p in learner.model.named_parameters()}
    learner.train_step(_torch_batch(r["batches"][0]))
    assert all(torch.equal(p, before[n])
               for n, p in learner.model.named_parameters())
    learner.train_step(_torch_batch(r["batches"][1]))
    _check_params(learner.model, r["f64"]["accum_grads"],
                  r["f64"]["accum_params"])
    _check_stats(learner.model, r["f64"]["accum_stats"], STAT_TOL)
