"""Port video backbone (vidsitu_tpu_torch/models/) against the JAX package.

One numpy weight tree per case, in the structure of flax ``init`` (taken
with ``jax.eval_shape``) and drawn from a seed: kernels normal with std
fan_in**-0.5, every BatchNorm gamma, beta and running statistic and every
bias seeded and non-zero (flax initialises the non-local and
final-bottleneck gammas to zero, which would hide the blocks). JAX applies
the tree as is; the port loads it through ``flax_to_state_dict`` with
``strict=True``. Inputs are numpy-seeded.

Tolerance: float32 throughout, atol 1e-4 at a feature scale of O(1):
PyTorch's CPU convolutions and matmuls sum in another order than XLA's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsitu_tpu.models import video_backbone as jvb
from vidsitu_tpu.models.vb_models import VbVideoModel as JaxVbModel
from vidsitu_tpu.models.vb_models import build_feat_extractor as jax_build
from vidsitu_tpu.utils.config import get_cfg_with_overrides
from vidsitu_tpu_torch.convert.from_flax import (
    flax_to_state_dict,
    load_flax_variables,
    seeded_variables,
)
from vidsitu_tpu_torch.models import video_backbone as tvb
from vidsitu_tpu_torch.models.vb_models import VbVideoModel as TorchVbModel
from vidsitu_tpu_torch.models.vb_models import build_feat_extractor as torch_build

torch.set_num_threads(1)

ATOL = 1e-4
PRESETS = ["slow_fast_nl_r50_8x8", "slow_nl_r50_8x8", "c2d_r50_8x8",
           "i3d_r50_8x8", "i3d_r50_nl_8x8"]
TINY_VID = {"vid_mdl.resnet.depth": 26, "vid_mdl.crop_size": 32,
            "vid_mdl.num_frames": 4, "train.dtype": "float32"}


def seeded_tree(shapes, seed):
    """numpy tree with the structure and shapes of flax variables
    ``shapes``, drawn from ``seed``: gamma in [0.5, 1], var in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name == "kernel":
            return rng.standard_normal(shape) * np.prod(shape[:-1]) ** -0.5
        if name == "scale":
            return rng.uniform(0.5, 1.0, shape)
        if name == "bias":
            return 0.05 * rng.standard_normal(shape)
        if name == "mean":
            return 0.1 * rng.standard_normal(shape)
        assert name == "var", name
        return rng.uniform(0.5, 1.5, shape)

    def walk(tree):
        return {k: walk(v) if hasattr(v, "items")
                else leaf(k, tuple(v.shape)).astype(np.float32)
                for k, v in tree.items()}

    return walk(shapes)


def init_shapes(module, *args, **kw):
    """flax variable shapes of ``module`` without running its init."""
    return jax.eval_shape(
        lambda *a: module.init(jax.random.PRNGKey(0), *a, **kw), *args)


def _ncdhw(x):
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _torch_cfg(jcfg: jvb.VideoCfg) -> tvb.VideoCfg:
    return tvb.VideoCfg(
        arch=jcfg.arch, depth_blocks=jcfg.depth_blocks, width=jcfg.width,
        nl_location=jcfg.nl_location, nl_instantiation=jcfg.nl_instantiation)


@pytest.mark.parametrize("kind", ["softmax", "dot_product"])
def test_nonlocal_block(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 6, 6, 32)).astype(np.float32)
    jblock = jvb.NonLocalBlock(jvb.VideoCfg(nl_instantiation=kind))
    tree = seeded_tree(init_shapes(jblock, jnp.asarray(x)), 1)
    ref = np.asarray(jblock.apply(tree, jnp.asarray(x)))
    block = tvb.NonLocalBlock(32, kind).eval()
    load_flax_variables(block, tree)
    with torch.inference_mode():
        out = block(_ncdhw(x)).permute(0, 2, 3, 4, 1).numpy()
    assert np.abs(ref - x).max() > 0.1  # the block is not an identity
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["softmax", "dot_product"])
def test_i3d_backbone_with_nonlocal_blocks(kind):
    """NL blocks that exist and carry block index 1 (s3.nl_1, s4.nl_1):
    two blocks per stage in s3/s4, 32 px, T=4."""
    jcfg = jvb.VideoCfg(arch="i3d", depth_blocks=(1, 2, 2, 1),
                        nl_location=(((),), ((1,),), ((1,),), ((),)),
                        nl_instantiation=kind)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 32, 32, 3)).astype(np.float32)
    jmodel = jvb.ResNet3DBackbone(jcfg)
    tree = seeded_tree(init_shapes(jmodel, jnp.asarray(x)), 3)
    ref = np.asarray(jax.jit(jmodel.apply)(tree, jnp.asarray(x)))
    model = tvb.ResNet3DBackbone(_torch_cfg(jcfg)).eval()
    load_flax_variables(model, tree)
    assert {"s3.nl_1.theta.weight", "s4.nl_1.bn.running_var"} <= set(
        model.state_dict())
    with torch.inference_mode():
        out = model(_ncdhw(x)).permute(0, 2, 3, 4, 1).numpy()
    assert out.shape == ref.shape == (2, 2, 1, 1, 2048)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def _frames(cfg, n_clips, seed):
    rng = np.random.default_rng(seed)
    t, hw = cfg.vid_mdl.num_frames, cfg.vid_mdl.crop_size
    inp = {"frms_ev_fast_tensor": rng.integers(
        0, 256, (n_clips, t, hw, hw, 3), dtype=np.uint8)}
    if cfg.vid_mdl.arch == "slowfast":
        inp["frms_ev_slow_tensor"] = rng.integers(
            0, 256, (n_clips, t // cfg.vid_mdl.slowfast.alpha, hw, hw, 3),
            dtype=np.uint8)
    return inp


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_clip_features(preset):
    """Every sf_mdl_name preset at depth 26, 32 px, T=4: uint8 frames ->
    (N, D) clip features through build_feat_extractor on both sides."""
    # one preset with channel-reversed input and per-channel mean/std, so
    # the reversed normalisation (vb_models.py:37-53) is visible
    extra = {} if preset != "i3d_r50_8x8" else {
        "vid_mdl.reverse_input_channel": True,
        "vid_mdl.mean": [0.40, 0.45, 0.50], "vid_mdl.std": [0.20, 0.225, 0.25]}
    cfg = get_cfg_with_overrides(
        "t", **{"mdl.sf_mdl_name": preset, **TINY_VID, **extra})
    inp = _frames(cfg, 5, seed=4)
    jinp = {k: jnp.asarray(v) for k, v in inp.items()}
    jmodel = jax_build(cfg)
    tree = seeded_tree(init_shapes(
        jmodel, jinp, method=JaxVbModel.clip_features), 5)
    ref = np.asarray(jax.jit(lambda v, b: jmodel.apply(
        v, b, method=JaxVbModel.clip_features))(tree, jinp))
    model = torch_build(cfg)
    load_flax_variables(model, tree)
    with torch.inference_mode():
        out = model.clip_features(
            {k: torch.from_numpy(v) for k, v in inp.items()}).numpy()
    assert out.shape == ref.shape == (5, tvb.backbone_out_dim(
        model.vid_cfg))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_vb_head_logits():
    """SFBase (backbone + 2-layer head) verb logits, (B, 5, V), from the
    6-D (B, 5, T, H, W, C) frame layout."""
    cfg = get_cfg_with_overrides(
        "t", **{"mdl.sf_mdl_name": "i3d_r50_nl_8x8", **TINY_VID,
                "vid_mdl.nl.location": [[[]], [[0]], [[0]], [[]]]})
    inp = _frames(cfg, 10, seed=6)
    inp = {k: v.reshape((2, 5) + v.shape[1:]) for k, v in inp.items()}
    jinp = {k: jnp.asarray(v) for k, v in inp.items()}
    jmodel = JaxVbModel(jvb.VideoCfg.from_cfg(cfg.vid_mdl), num_classes=7)
    tree = seeded_tree(init_shapes(jmodel, jinp), 7)
    ref = np.asarray(jax.jit(jmodel.apply)(tree, jinp)["mdl_out"])
    model = TorchVbModel(tvb.VideoCfg.from_cfg(cfg.vid_mdl), num_classes=7)
    load_flax_variables(model.eval(), tree)
    assert "backbone.s3.nl_0.theta.weight" in model.state_dict()
    with torch.inference_mode():
        out = model({k: torch.from_numpy(v) for k, v in inp.items()})
    assert out["mdl_out"].shape == ref.shape == (2, 5, 7)
    np.testing.assert_allclose(out["mdl_out"].numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("preset", ["slow_fast_nl_r50_8x8", "i3d_r50_nl_8x8"])
def test_seeded_variables_match_flax_tree(preset):
    """seeded_variables (the JAX-free weights chip_smoke.py uses) yields the
    flax tree of the same model, leaf for leaf and shape for shape, at R50
    depth with the preset's non-local blocks."""
    cfg = get_cfg_with_overrides(
        "t", **{"mdl.sf_mdl_name": preset, "vid_mdl.crop_size": 32,
                "vid_mdl.num_frames": 8, "train.dtype": "float32"})
    jinp = {k: jnp.asarray(v) for k, v in _frames(cfg, 1, seed=8).items()}
    jmodel = jax_build(cfg)
    shapes = init_shapes(jmodel, jinp, method=JaxVbModel.clip_features)
    tree = seeded_variables(torch_build(cfg), seed=0)
    flat = lambda t: {jax.tree_util.keystr(p): tuple(x.shape)
                      for p, x in jax.tree_util.tree_leaves_with_path(t)}
    assert flat(tree) == flat(dict(shapes))
    sd = flax_to_state_dict(tree)
    assert all(v.dtype in (torch.float32, torch.int64) for v in sd.values())
