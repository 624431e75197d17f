"""``train.param_dtype`` in the port (vidsitu_tpu_torch) against the JAX
package, on the CPU at tiny widths:

  * the dtype of every parameter and statistic, leaf by leaf, for
    ``param_dtype`` bfloat16 and float16: SRL (``tx_only``,
    ``new_gpt2_only``, ``sfpret_txe_txd_vbarg``), evrel (``rob_evrel``,
    ``sfpret_evrel``) and vb (SlowFast-26 through the config, the hand-built
    I3D-NL with ``nl_1``), against ``jax.eval_shape`` of the flax init;
  * one ``Learner.train_step`` in bfloat16 (``train.dtype`` and
    ``train.param_dtype``, dropout 0) against the JAX model and
    ``optax.inject_hyperparams(adam)`` on the same seeded tree rounded to
    bfloat16: the loss within 1e-2 relative, each well-conditioned
    gradient within 5e-2 of its leaf's scale, every updated parameter within
    2 bfloat16 steps of optax's where the gradient's sign is determined
    (and within 2 lr where it is not), Adam's moments in bfloat16; with the
    port's lr doubled the same check fails (the control); for ``tx_only``,
    ``sfpret_txe_txd_vbarg`` and ``sfpret_evrel`` (the I3D-NL and a
    ``grad_accum`` cycle: tests/test_torch_param_dtype_steps.py);
  * ``HalfAdam`` against optax on given gradients; pretrained weights
    keeping their dtype, as the JAX package's pretrained policy leaves them.

A gradient is well-conditioned where the JAX package's own bfloat16
gradient lies within WELL_COND of its float32 one on the same
(bfloat16-rounded) weights: at seeded weights some leaves (attention
projections behind a saturated softmax, the non-local blocks behind a
BatchNorm of small batch deviation) move by tens of percents when the
products round to bfloat16, in JAX as in the port, and two bfloat16
programs cannot agree on them closer than that (ROADMAP Queue 3). XLA also
keeps float32 intermediates inside its fusions (``xla_allow_excess_precision``)
where PyTorch rounds every op's result: with that flag off, the JAX
package's own bfloat16 gradients move away from its float32 ones as far as
the port's do.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_evrel import evrel_cfg
from tests.test_torch_transformer import srl_cfg, to_torch
from tests.test_torch_video_backbone import init_shapes
from tests.vb_train_parity import MODELS, N_CLASSES, _batch
from vidsitu_tpu.data import build_comm, get_data
from vidsitu_tpu.data.synth import make_synth_dataset
from vidsitu_tpu.models import selector as jsel
from vidsitu_tpu.models import video_backbone as jvb
from vidsitu_tpu.models.vb_models import VbVideoModel as JaxVbModel
from vidsitu_tpu_torch.convert.from_flax import flax_to_state_dict
from vidsitu_tpu_torch.models import selector as psel
from vidsitu_tpu_torch.models import video_backbone as tvb
from vidsitu_tpu_torch.models.common import cast_params
from vidsitu_tpu_torch.models.evrel_models import EvrelModel
from vidsitu_tpu_torch.models.vb_models import VbVideoModel as TorchVbModel
from vidsitu_tpu_torch.convert.from_flax import seeded_variables
from vidsitu_tpu_torch.train.adam import HalfAdam
from vidsitu_tpu_torch.train.learner import Learner
from vidsitu_tpu_torch.ops.attention import bwd_kernel_entry, kernel_entry
from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

torch.set_num_threads(1)

PARAM_DTYPES = ("bfloat16", "float16")
LR = 1e-3
LOSS_TOL, GRAD_TOL, WELL_COND, GRAD_FLOOR = 1e-2, 5e-2, 2.5e-2, 1e-3
MANTISSA = {torch.bfloat16: 7, torch.float16: 10}
# the fewest well-conditioned leaves a step holds (evrel at these sizes: 3
# of 51; the SRL models and the I3D-NL most of theirs)
MIN_HELD = 2
CODES = {np.dtype(np.float32): 0.0, np.dtype(jnp.bfloat16): 1.0,
         np.dtype(np.float16): 2.0}
TORCH_CODES = {torch.float32: 0.0, torch.bfloat16: 1.0, torch.float16: 2.0}


def jax_dtypes(shapes):
    """{state_dict name: dtype code} of a flax variable tree of shapes: each
    leaf becomes a float32 array holding its dtype's code, renamed and
    transposed by ``flax_to_state_dict`` like the values themselves."""
    codes = jax.tree.map(
        lambda s: np.full(s.shape, CODES[np.dtype(s.dtype)], np.float32),
        shapes)
    return {n: float(t.reshape(-1)[0]) for n, t in
            flax_to_state_dict(codes).items()
            if not n.endswith("num_batches_tracked")}


def port_dtypes(model):
    return {n: TORCH_CODES[t.dtype] for n, t in model.state_dict().items()
            if not n.endswith("num_batches_tracked")}


@pytest.fixture(scope="module")
def lang_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_param_dtype")
    paths = make_synth_dataset(root / "data", n_train=4, n_valid=3, n_test=1,
                               seed=13)
    return paths, root


def _lang_cfg(paths, root, task, mdl_name, pd, **kw):
    make = srl_cfg if task == "vb_arg" else evrel_cfg
    return make(paths, root, mdl_name,
                **{"train.dtype": pd, "train.param_dtype": pd, **kw})


@pytest.mark.parametrize("pd", PARAM_DTYPES)
@pytest.mark.parametrize("task,mdl_name", [
    ("vb_arg", "tx_only"), ("vb_arg", "new_gpt2_only"),
    ("vb_arg", "sfpret_txe_txd_vbarg"), ("evrel", "rob_evrel"),
    ("evrel", "sfpret_evrel")])
def test_lang_leaf_dtypes_match_jax(lang_env, task, mdl_name, pd):
    paths, root = lang_env
    cfg = _lang_cfg(paths, root, task, mdl_name, pd)
    comm = build_comm(cfg)
    batch = next(iter(get_data(cfg).train_dl))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax_dtypes(init_shapes(jsel.build_model(cfg, comm), jb))
    got = port_dtypes(psel.build_model(cfg, comm))
    assert got == want
    assert set(got.values()) == {TORCH_CODES[psel.DTYPES[pd]]}


def _vb_cfg(tmp_path, pd):
    return get_cfg_with_overrides("t", **{
        "task_type": "vb", "mdl.sf_mdl_name": "slow_fast_nl_r50_8x8",
        "vid_mdl.resnet.depth": 26, "vid_mdl.crop_size": 32,
        "vid_mdl.num_frames": 4, "train.dtype": pd, "train.param_dtype": pd,
        "misc.tmp_path": str(tmp_path)})


@pytest.mark.parametrize("pd", PARAM_DTYPES)
def test_slowfast_leaf_dtypes_match_jax(tmp_path, pd):
    """SlowFast-26 through ``build_model``: parameters in ``param_dtype``,
    BatchNorm statistics in float32, as flax's ``batch_stats``."""
    from vidsitu_tpu_torch.models.vb_models import _build as pbuild

    cfg = _vb_cfg(tmp_path, pd)
    jcfg = jvb.VideoCfg.from_cfg(cfg.vid_mdl, dtype=jsel.DTYPES[pd],
                                 param_dtype=jsel.DTYPES[pd])
    jm = JaxVbModel(jcfg, num_classes=N_CLASSES)
    batch = {k: jnp.asarray(v) for k, v in _batch("slowfast").items()}
    want = jax_dtypes(init_shapes(jm, batch))
    got = port_dtypes(pbuild(cfg, N_CLASSES))
    assert got == want
    assert {v for n, v in got.items() if "running" in n} == {0.0}
    assert {v for n, v in got.items() if "running" not in n} == {
        TORCH_CODES[psel.DTYPES[pd]]}


@pytest.mark.parametrize("pd", PARAM_DTYPES)
def test_i3d_nl_leaf_dtypes_match_jax(pd):
    """The hand-built I3D with ``nl_1`` in s3 and s4: the non-local blocks'
    projections and BatchNorm scale in ``param_dtype`` (``cast_params``),
    their statistics in float32."""
    fields = MODELS["i3d_nl"]
    jdt = jsel.DTYPES[pd]
    jm = JaxVbModel(jvb.VideoCfg(**fields, dtype=jdt, param_dtype=jdt),
                    num_classes=N_CLASSES)
    batch = {k: jnp.asarray(v) for k, v in _batch("i3d").items()}
    want = jax_dtypes(init_shapes(jm, batch))
    pm = cast_params(TorchVbModel(tvb.VideoCfg(**fields, dtype=psel.DTYPES[pd]),
                                  num_classes=N_CLASSES), psel.DTYPES[pd])
    got = port_dtypes(pm)
    assert got == want
    assert any(".nl_1." in n for n in got)


@pytest.mark.parametrize("d", (64, 128, 256, 512))
def test_float16_routes_to_wgmma(d):
    """float16 takes the wgmma entries at the four widths, as bfloat16
    does; other widths the WMMA / FMA entries."""
    assert kernel_entry(torch.float16, d) == "nl_attn_fwd_wgmma"
    assert bwd_kernel_entry(torch.float16, d) == "nl_attn_bwd_wgmma"
    assert kernel_entry(torch.float16, d - 8) == "nl_attn_fwd"
    assert bwd_kernel_entry(torch.float16, d - 8) == "nl_attn_bwd"


# -- one bfloat16 training step against JAX / optax ---------------------------
def _cast_tree(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def jax_half_steps(jm, jm32, tree, batches, vb, lr=LR, accum=1):
    """The JAX package's steps in bfloat16 (its Learner's step: value and
    grad, ``inject_hyperparams(adam)``, ``MultiSteps`` for ``accum`` > 1)
    over ``batches``: the first loss, the gradient the first update takes
    (MultiSteps' running mean over a cycle, in bfloat16 as it computes
    it), the same in float32 on the same bfloat16-rounded weights (the
    condition of each leaf), the updated parameters and statistics."""
    params = _cast_tree(tree["params"], jnp.bfloat16)
    stats = tree.get("batch_stats")

    def loss_fn(model):
        def fn(p, s, b):
            if vb:
                out, new = model.apply({"params": p, "batch_stats": s}, b,
                                       deterministic=False,
                                       mutable=["batch_stats"])
                return out["loss"], new["batch_stats"]
            return model.apply({"params": p}, b, deterministic=True)[
                "loss"], s
        return jax.jit(jax.value_and_grad(fn, has_aux=True))

    vg, vg32 = loss_fn(jm), loss_fn(jm32)
    opt = optax.inject_hyperparams(lambda learning_rate: optax.adam(
        learning_rate, b1=0.9, b2=0.99))(learning_rate=lr)
    if accum > 1:
        opt = optax.MultiSteps(opt, every_k_schedule=accum)
    state = opt.init(params)

    @jax.jit
    def update(g, st, p):
        u, st = opt.update(g, st, p)
        return optax.apply_updates(p, u), st

    jbs = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    g32 = [vg32(p32, stats, jb)[1] for jb in jbs[:accum]]
    out = {"grads32": _np32(jax.tree.map(lambda *g: sum(g) / accum, *g32))}
    acc = None
    for i, jb in enumerate(jbs):
        (loss, stats), g = vg(params, stats, jb)
        if i == 0:
            out["loss"] = float(loss)
        if i < accum:
            acc = g if acc is None else jax.tree.map(
                lambda a, b: a + (b - a) / (i + 1), acc, g)
        params, state = update(g, state, params)
    out["grads"] = _np32(acc)
    inner = state.inner_opt_state if accum > 1 else state
    mu = inner.inner_state[0].mu
    out.update(params=_np32(params), mu_dtypes={
        str(a.dtype) for a in jax.tree.leaves(mu)}, stats=stats)
    return out


def keep_grads_then_step(learner, grads):
    """``learner.optimizer.step`` that first copies the gradients of the
    first update into ``grads`` (by name)."""
    step = learner.optimizer.step

    def wrapped():
        if not grads:
            grads.update({n: (torch.zeros_like(p) if p.grad is None
                              else p.grad.clone())
                          for n, p in learner.model.named_parameters()})
        step()
    return wrapped


def port_half_steps(model, cfg, batches, lr=LR):
    """``Learner.train_step`` over ``batches``: the first loss, the first
    update's gradients by name (a grad_accum cycle's sum), the model and
    the Learner."""
    learner = Learner("t", cfg, model, None, None, "cpu")
    learner.prepare_optimizer(lr)
    grads, losses = {}, []
    learner.optimizer.step = keep_grads_then_step(learner, grads)
    for b in batches:
        losses.append(float(learner.train_step(to_torch(b))))
    return losses[0], grads, model, learner


def ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of ``dtype`` at each value of ``x`` (float32 tensor)."""
    exp = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -14)))
    return torch.exp2(exp - MANTISSA[dtype])


def check_half_step(ref, tree, loss, grads, model, dtype, control=False):
    """The module's limits (see the note); returns the number of leaves
    whose updated parameters lie outside them (the control expects many,
    the real step none). A step of ``dtype`` is taken at the largest of
    the parameter before the update, after it, and 2 lr: Adam's first
    update is lr r with r a ``dtype`` value within a few steps of +-1, and
    two programs whose gradients differ by rounding may take neighbouring
    r, which shows where the update cancels most of a parameter smaller
    than lr."""
    if loss is not None:
        assert abs(loss - ref["loss"]) <= LOSS_TOL * abs(ref["loss"])
    want_g = flax_to_state_dict({"params": ref["grads"]})
    g32 = flax_to_state_dict({"params": ref["grads32"]})
    want_p = flax_to_state_dict({"params": ref["params"]})
    before = flax_to_state_dict({"params": tree["params"]})
    floor = GRAD_FLOOR * max(float(v.abs().max()) for v in g32.values())
    got_p = model.state_dict()
    outside, held = [], 0
    for n, g in grads.items():
        assert got_p[n].dtype == dtype, n
        scale = max(float(g32[n].abs().max()), floor)
        cond = float((want_g[n] - g32[n]).abs().max()) / scale
        wscale = max(float(want_g[n].abs().max()), floor)
        err = float((g.float() - want_g[n]).abs().max()) / wscale
        well = cond < WELL_COND
        if well and not control:
            held += 1
            assert err <= GRAD_TOL, (n, err, cond)
        determined = want_g[n].abs() > GRAD_TOL * wscale
        if not well:  # the sign is in doubt everywhere
            determined = torch.zeros_like(determined)
        diff = (got_p[n].float() - want_p[n]).abs()
        steps = 2 * ulp(torch.maximum(torch.maximum(
            before[n].to(dtype).float().abs(), want_p[n].abs()),
            torch.tensor(2 * LR)), dtype)
        bad = ((diff > steps) & determined) | (
            diff > 2 * LR + steps)
        if bad.any():
            outside.append(n)
    if not control:
        assert held >= MIN_HELD, (held, len(grads))
        assert not outside, outside
    return len(outside)


STEP_CASES = [("vb_arg", "tx_only"), ("vb_arg", "sfpret_txe_txd_vbarg"),
              ("evrel", "sfpret_evrel")]


def _lang_models(lang_env, task, mdl_name, **kw):
    """(JAX bf16 model, JAX float32 model, port bf16 model with every
    dropout rate 0, the seeded tree it holds, two batches, the cfg)."""
    paths, root = lang_env
    drop = {"tx_dec.dropout": 0.0} if task == "vb_arg" else {}
    cfgs = {pd: _lang_cfg(paths, root, task, mdl_name, pd, **drop, **kw)
            for pd in ("bfloat16", "float32")}
    comm = build_comm(cfgs["bfloat16"])
    batches = list(get_data(cfgs["bfloat16"]).train_dl)[:2]
    pm = psel.build_model(cfgs["bfloat16"], comm)
    if task == "evrel":  # RoBERTa's rate is no config key
        pm = cast_params(EvrelModel(mdl_name, dataclasses.replace(
            pm.rob_cfg, dropout=0.0), pm.feat_dim), torch.bfloat16)
    tree = seeded_variables(pm, 3)
    pm.load_state_dict(flax_to_state_dict(tree), strict=True)
    return (jsel.build_model(cfgs["bfloat16"], comm),
            jsel.build_model(cfgs["float32"], comm), pm, tree, batches,
            cfgs["bfloat16"])


@pytest.mark.parametrize("task,mdl_name", STEP_CASES)
def test_bf16_step_matches_optax(lang_env, task, mdl_name):
    jm, jm32, pm, tree, batches, cfg = _lang_models(lang_env, task, mdl_name)
    pm0 = copy.deepcopy(pm)
    ref = jax_half_steps(jm, jm32, tree, batches[:1], vb=False)
    loss, grads, model, learner = port_half_steps(pm, cfg, batches[:1])
    assert isinstance(learner.optimizer, HalfAdam)
    assert ref["mu_dtypes"] == {"bfloat16"}
    assert {st["exp_avg"].dtype for st in learner.optimizer.state.values()} \
        == {torch.bfloat16}
    check_half_step(ref, tree, loss, grads, model, torch.bfloat16)
    # the control: the port's lr doubled moves most leaves outside
    pm2 = copy.deepcopy(pm0)
    loss2, grads2, model2, _ = port_half_steps(pm2, cfg, batches[:1], 2 * LR)
    n_out = check_half_step(ref, tree, loss2, grads2, model2, torch.bfloat16,
                            control=True)
    assert n_out >= len(grads2) // 2, (n_out, len(grads2))


def _vb_models(tmp_path, **cfg_kw):
    """The hand-built I3D-NL: (JAX bf16 model, JAX float32 model, port bf16
    model, seeded tree with statistics, two batches, cfg)."""
    from tests.test_torch_video_backbone import seeded_tree
    from tests.vb_train_parity import _cfg

    fields = MODELS["i3d_nl"]
    batches = [_batch("i3d"), _batch("i3d", seed=1)]

    def jax_model(dt):
        return JaxVbModel(jvb.VideoCfg(**fields, dtype=dt, param_dtype=dt),
                          num_classes=N_CLASSES)

    jm32 = jax_model(jnp.float32)
    tree = seeded_tree(init_shapes(jm32, {
        k: jnp.asarray(v) for k, v in batches[0].items()}), 11)
    pm = cast_params(TorchVbModel(tvb.VideoCfg(**fields, dtype=torch.bfloat16),
                                  num_classes=N_CLASSES), torch.bfloat16)
    pm.load_state_dict(flax_to_state_dict(tree), strict=True)
    cfg = _cfg(tmp_path, **{"train.dtype": "bfloat16",
                            "train.param_dtype": "bfloat16", **cfg_kw})
    return jax_model(jnp.bfloat16), jm32, pm, tree, batches, cfg


def _check_stats(model, stats):
    want = flax_to_state_dict({"batch_stats": _np32(stats)})
    got = model.state_dict()
    for n, w in want.items():
        if "running" in n:
            assert got[n].dtype == torch.float32, n
            np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=0,
                                       atol=GRAD_TOL * float(w.abs().max()),
                                       err_msg=n)


def test_pretrained_weights_keep_their_dtype_as_jax(lang_env, tmp_path):
    """``mdl.gpt2_mdl_path`` with ``train.param_dtype=bfloat16``: the JAX
    package's pretrained policy puts the converted float32 arrays into its
    variables as they are, so the loaded leaves stay float32 beside the
    bfloat16 initial ones; the port's loaded parameters take the same
    dtypes (``common.take_dtypes``) and values."""
    from tests.test_torch_srl_train import _seeded_gpt2
    from vidsitu_tpu.train.pretrained import (
        load_pretrained_variables as jax_load_pretrained,
    )
    from vidsitu_tpu_torch.train.pretrained import load_pretrained_variables

    paths, root = lang_env
    ckpt = tmp_path / "gpt2.pt"
    torch.save(_seeded_gpt2(np.random.default_rng(0), 2, 64, 50, 128), ckpt)
    cfg = _lang_cfg(paths, root, "vb_arg", "new_gpt2_only", "bfloat16",
                    **{"mdl.gpt2_mdl_path": str(ckpt)})
    comm = build_comm(cfg)
    batch = next(iter(get_data(cfg).train_dl))
    jm = jsel.build_model(cfg, comm)
    jvars = jsel.init_model_variables(jm, batch)
    loaded = jax_load_pretrained(cfg, jm, jvars)
    want = jax_dtypes(jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), loaded))
    pm = psel.init_model_variables(psel.build_model(cfg, comm), 0)
    assert {p.dtype for p in pm.parameters()} == {torch.bfloat16}
    load_pretrained_variables(cfg, pm)
    assert port_dtypes(pm) == want
    assert 0.0 in want.values()  # the loaded leaves: float32
    values = flax_to_state_dict(jax.tree.map(
        lambda a: np.asarray(a, np.float32), loaded))
    for n, v in pm.state_dict().items():
        assert torch.equal(v.float(), values[n]), n


@pytest.mark.parametrize("pd", PARAM_DTYPES)
def test_half_adam_matches_optax(pd):
    """``HalfAdam`` against ``optax.inject_hyperparams(adam)`` on the same
    16-bit parameters and gradients, three steps, then two more after the
    lr is set again (the JAX Learner's ``_set_lr`` writes a float32 lr,
    which optax casts to the parameters' dtype as it does the first):
    bfloat16 bitwise equal, parameters and moments; float16 within one
    float16 step a update (XLA keeps float32 between the float16 ops it
    fuses, where bfloat16 rounds at each; a step taken as in
    ``check_half_step``; its gradients are drawn large enough that nu does
    not underflow float16 everywhere: where it does, eps = 1e-8 rounds to
    0 and optax divides by zero, and so does the port). In bfloat16
    ``torch.optim.Adam`` on the same inputs is not bitwise optax's (the
    measurement that chose the port's own optimizer: other order of
    operations, unrounded constants)."""
    rng = np.random.default_rng(0)
    p0 = (rng.standard_normal(20000) * 0.1).astype(np.float32)
    scales = ((1e-3, 3e-2, 1e-4, 1e-3, 1e-2) if pd == "bfloat16"
              else (0.5, 1.0, 0.3, 0.5, 0.8))
    g0 = [(rng.standard_normal(20000) * s).astype(np.float32)
          for s in scales]
    jdt, tdt = jsel.DTYPES[pd], psel.DTYPES[pd]
    opt = optax.inject_hyperparams(lambda learning_rate: optax.adam(
        learning_rate, b1=0.9, b2=0.99))(learning_rate=LR)
    jp = jnp.asarray(p0, jdt)
    st = opt.init(jp)
    update = jax.jit(opt.update)
    tp = torch.nn.Parameter(torch.from_numpy(p0).to(tdt))
    port = HalfAdam([tp], LR, betas=(0.9, 0.99))
    ref = torch.nn.Parameter(torch.from_numpy(p0).to(tdt))
    torch_adam = torch.optim.Adam([ref], lr=LR, betas=(0.9, 0.99))

    start = torch.from_numpy(p0).to(tdt).float().abs()

    def close(got, want, updates):
        if pd == "bfloat16":
            return torch.equal(got, want)
        # equal infinities count as equal
        diff = torch.where(got == want, 0.0, (got - want).abs())
        at = torch.maximum(torch.maximum(start, want.abs()),
                           torch.tensor(2 * LR))
        return bool((diff <= updates * ulp(at, tdt)).all())

    for i, g in enumerate(g0):
        if i == 3:  # the lr set again: a float32 array in JAX
            st.hyperparams["learning_rate"] = jnp.asarray(LR / 2, jnp.float32)
            port.param_groups[0]["lr"] = LR / 2
            torch_adam.param_groups[0]["lr"] = LR / 2
        u, st = update(jnp.asarray(g, jdt), st, jp)
        jp = optax.apply_updates(jp, u)
        for p, o in ((tp, port), (ref, torch_adam)):
            p.grad = torch.from_numpy(g).to(tdt)
            o.step()
        want = torch.from_numpy(np.asarray(jp, np.float32))
        assert close(tp.detach().float(), want, i + 1), i
        mu = torch.from_numpy(np.asarray(st.inner_state[0].mu, np.float32))
        if pd == "bfloat16":
            assert torch.equal(port.state[tp]["exp_avg"].float(), mu), i
    assert port.state[tp]["exp_avg"].dtype == tdt
    if pd == "bfloat16":
        assert not close(ref.detach().float(), want, len(g0))
