"""The verb model's training step in the port against the JAX package
(tests/vb_train_parity.py has the harness and its tolerances): the
hand-built I3D with non-local blocks ``nl_1`` in s3 and s4, one Adam step,
remat, gradient accumulation and the freeze mask; flax-style initial
values, the verb loss and its pad label, build_vb_model's dtypes.
tests/test_torch_vb_train_slowfast.py holds the depth-26 SlowFast preset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import vb_train_parity as V
from vidsitu_tpu.models import video_backbone as jvb
from vidsitu_tpu.models.srl_models import (
    masked_cross_entropy as jax_masked_ce,
)
from vidsitu_tpu.models.vb_models import VbVideoModel as JaxVbModel
from vidsitu_tpu_torch.convert.from_flax import flax_to_state_dict
from vidsitu_tpu_torch.models import video_backbone as tvb
from vidsitu_tpu_torch.models.selector import init_model_variables
from vidsitu_tpu_torch.models.srl_models import masked_cross_entropy
from vidsitu_tpu_torch.models.vb_models import VbVideoModel as TorchVbModel
from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

torch.set_num_threads(1)

NAME = "i3d_nl"


@pytest.fixture(scope="module")
def ref():
    return V.build_ref([NAME])


def test_train_step_matches_jax(ref, tmp_path):
    grads = V.check_train_step(ref, tmp_path, NAME)
    # the non-local blocks take part: their weights have gradients
    for block in ("s3.nl_1", "s4.nl_1"):
        for conv in ("theta", "phi", "g", "out"):
            assert grads[f"backbone.{block}.{conv}.weight"].abs().max() > 0


def test_float32_step_matches_jax_float32(ref, tmp_path):
    V.check_float32_step(ref, tmp_path, NAME)


def test_remat_same_gradients_and_stats_updated_once(ref, tmp_path):
    V.check_remat(ref, tmp_path, NAME, remat=True)


def test_grad_accum_two_batches_equals_multisteps(ref, tmp_path):
    V.check_grad_accum(ref, tmp_path, NAME)


def test_freeze_mask_zeroes_the_backbone(ref, tmp_path):
    """train.freeze_sfbase: the backbone's weights stay, its BatchNorm
    statistics move, the head takes the same update as without the mask."""
    r = ref[NAME]
    learner = V._learner(tmp_path, NAME, ref, **{"train.freeze_sfbase": True})
    before = {k: v.clone() for k, v in learner.model.state_dict().items()}
    learner.train_step(V._torch_batch(r["batches"][0]))
    after = learner.model.state_dict()
    for n, _ in learner.model.named_parameters():
        assert torch.equal(after[n], before[n]) == n.startswith("backbone."), n
    want = V._sd(r["f64"]["params"])
    for n in ("proj_head.layers_0.bias", "proj_head.layers_1.weight"):
        np.testing.assert_allclose(after[n].numpy(), want[n].numpy(),
                                   rtol=0, atol=V.UPDATE_TOL)
    V._check_stats(learner.model, r["f64"]["stats"], V.STAT_TOL)


def test_remat_stages_parse_like_jax():
    vm = get_cfg_with_overrides("t").vid_mdl
    assert tvb.VideoCfg.from_cfg(vm, remat_stages="stem,s2,3").remat_stages \
        == jvb.VideoCfg.from_cfg(vm, remat_stages="stem,s2,3").remat_stages \
        == (-1, 0, 3)


def test_flax_style_init_statistics():
    """init_model_variables draws flax's distributions: lecun_normal kernels
    (std sqrt(1/fan_in), cut at 2 / 0.8796 of it), zero biases, unit BN
    scales except the zero-initialised ones, and the same zeros as
    ``model.init`` of the JAX package."""
    fields = V.MODELS["i3d_nl"]
    jmodel = JaxVbModel(jvb.VideoCfg(**fields), num_classes=V.N_CLASSES)
    batch = V._batch("i3d")
    jvars = jax.jit(jmodel.init)(jax.random.PRNGKey(0), {
        k: jnp.asarray(v) for k, v in batch.items()})
    want = flax_to_state_dict(jax.tree.map(np.asarray, jvars))
    model = init_model_variables(TorchVbModel(tvb.VideoCfg(**fields),
                                              V.N_CLASSES), seed=3)
    got = model.state_dict()
    assert set(got) == set(want)
    zero_scales = 0
    for n, w in want.items():
        g, w = got[n].float(), w.float()
        if n.endswith("num_batches_tracked"):
            continue
        if w.dim() >= 2:  # kernels
            fan_in = int(np.prod(w.shape[1:]))
            bound = 2 * fan_in ** -0.5 / 0.87962566103423978
            assert g.abs().max() <= bound + 1e-6, n
            if w.numel() >= 4096:
                assert abs(g.std().item() / w.std().item() - 1) < 0.1, n
                assert abs(g.std().item() * fan_in ** 0.5 - 1) < 0.1, n
        else:  # biases, BN scales and statistics: constants, equal exactly
            assert torch.equal(g, w), n
            zero_scales += n.endswith("bn.weight") and not w.any()
    # the final BN of every bottleneck and the two non-local BNs
    assert zero_scales == sum(fields["depth_blocks"]) + 2
    again = init_model_variables(TorchVbModel(tvb.VideoCfg(**fields),
                                              V.N_CLASSES), seed=3)
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in got.items())


def test_forward_returns_the_loss_only_with_labels():
    fields = V.MODELS["i3d_nl"]
    model = TorchVbModel(tvb.VideoCfg(**fields), V.N_CLASSES).eval()
    batch = V._torch_batch(V._batch("i3d"))
    with torch.no_grad():
        out = model(batch)
        assert set(out) == {"mdl_out", "loss"}
        assert out["mdl_out"].shape == (2, 5, V.N_CLASSES)
        del batch["label_tensor"]
        assert set(model(batch)) == {"mdl_out"}


@pytest.mark.parametrize("pad_id", [-1, 2])
def test_masked_cross_entropy_pad_minus_one_matches_jax(pad_id):
    """The verb task pads with -1, outside the classes: the port masks the
    pad label before the gather, as the JAX package does."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 7)).astype(np.float32)
    labels = np.array([1, pad_id, 3, pad_id, 0, 6])
    want = float(jax_masked_ce(jnp.asarray(logits), jnp.asarray(labels),
                               pad_id))
    got = float(masked_cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels), pad_id))
    assert np.isfinite(got) and abs(got - want) <= 1e-6 * abs(want)
    all_pad = np.full(6, pad_id)
    assert float(masked_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(all_pad), pad_id)) == 0.0


def test_build_vb_model_keeps_float32_parameters(tmp_path):
    """build_vb_model: float32 parameters and statistics, products and
    logits in train.dtype (flax's param_dtype / dtype)."""
    from vidsitu_tpu_torch.models.vb_models import build_vb_model

    cfg = get_cfg_with_overrides("t", **{
        "mdl.sf_mdl_name": "i3d_r50_nl_8x8", "vid_mdl.resnet.depth": 26,
        "vid_mdl.crop_size": 32, "vid_mdl.num_frames": 4,
        "train.dtype": "bfloat16", "train.remat_stages": "s2"})

    class Comm:
        vb_id_vocab = list(range(V.N_CLASSES))

    model = build_vb_model(cfg, Comm())
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in model.state_dict().values())
    assert model.backbone.s2.block_0.remat and not model.backbone.s3.block_0.remat
    with torch.no_grad():
        out = model(V._torch_batch(V._batch("i3d")))
    assert out["mdl_out"].dtype == torch.bfloat16
    assert out["loss"].dtype == torch.float32
