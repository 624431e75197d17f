"""Port feature extraction (vidsitu_tpu_torch/extract.py) against the JAX
package's, plus the port's import and device contracts.

Both extractors run on one synthetic valid split (32 px JPEG frames) with
clip_batch=7, so every segment's 5 clips span dispatches and the tail is
zero-padded; they must write the same files with the same (5, D) float32
arrays (atol 1e-4, float32 on both sides). The backbone is I3D-NL at depth
26 with non-local blocks moved to block 0 of s3 and s4, so they exist.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsitu_tpu.data.comm import build_comm
from vidsitu_tpu.data.synth import make_synth_dataset
from vidsitu_tpu.extract import extract_features as jax_extract
from vidsitu_tpu.models.vb_models import VbVideoModel as JaxVbModel
from vidsitu_tpu.models.vb_models import build_feat_extractor as jax_build
from vidsitu_tpu.utils.config import get_cfg_with_overrides
from vidsitu_tpu_torch import extract as port_extract
from vidsitu_tpu_torch.convert.from_flax import flax_to_state_dict
from vidsitu_tpu_torch.convert.to_pyslowfast import pysf_state_dict

from .test_torch_video_backbone import init_shapes, seeded_tree

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


TINY = {"mdl.sf_mdl_name": "i3d_r50_nl_8x8", "vid_mdl.resnet.depth": 26,
        "vid_mdl.crop_size": 32, "vid_mdl.num_frames": 4,
        "vid_mdl.sampling_rate": 2,
        "vid_mdl.nl.location": "[[[]], [[0]], [[0]], [[]]]",
        "train.dtype": "float32"}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("featext")
    paths = make_synth_dataset(root, n_train=1, n_valid=4, n_test=1,
                               seed=11, with_frames=True)
    overrides = {**paths, **TINY}
    cfg = get_cfg_with_overrides("featext_test", **overrides)
    return cfg, build_comm(cfg), [f"--{k}={v}" for k, v in overrides.items()]


def test_extract_matches_jax(env, tmp_path):
    """JAX extract_features(variables) == the port's extract_features(
    state_dict) == the port's CLI on the same weights saved as a PySlowFast
    checkpoint (--ckpt goes through the shared converter)."""
    cfg, comm, overrides = env
    one = {"frms_ev_fast_tensor": jnp.zeros((1, 4, 32, 32, 3), jnp.uint8)}
    tree = seeded_tree(init_shapes(
        jax_build(cfg), one, method=JaxVbModel.clip_features), seed=12)
    out_j, out_t, out_c = (tmp_path / d for d in ("jax", "torch", "ckpt"))
    counts_j = jax_extract(cfg, comm, variables=tree, splits=["valid"],
                           out_dir=str(out_j), batch_size=3, clip_batch=7)
    state_dict = flax_to_state_dict(tree)
    counts_t = port_extract.extract_features(
        cfg, comm, state_dict=state_dict, splits=["valid"],
        out_dir=str(out_t), batch_size=3, clip_batch=7, device="cpu")
    assert counts_t == counts_j == {"valid": 4}
    ckpt = tmp_path / "sfbase.pth"
    torch.save(pysf_state_dict(state_dict, prefix=""), ckpt)
    port_extract.main(["--device=cpu", f"--ckpt={ckpt}", "--split=valid",
                       f"--out_dir={out_c}", "--batch_size=3",
                       "--clip_batch=7", "--num_threads=0", *overrides])
    files = sorted(p.name for p in out_t.iterdir())
    assert files == sorted(p.name for p in out_j.iterdir())
    assert files == sorted(p.name for p in out_c.iterdir())
    assert len(files) == 4 and all(f.endswith("_feats.npy") for f in files)
    for f in files:
        ref = np.load(out_j / f)
        for out in (out_t, out_c):
            a = np.load(out / f)
            assert a.dtype == np.float32 and a.shape == ref.shape == (5, 2048)
            np.testing.assert_allclose(a, ref, atol=1e-4, rtol=0)


def test_cli_random_weights_on_cpu(env, tmp_path):
    """``main`` end to end on the CPU: seeded random weights, one split."""
    _, _, overrides = env
    port_extract.main(["--device=cpu", "--allow_random_weights",
                       "--split=valid", f"--out_dir={tmp_path}",
                       "--clip_batch=8", "--num_threads=0", *overrides])
    arrs = [np.load(p) for p in sorted(tmp_path.glob("*_feats.npy"))]
    assert len(arrs) == 4
    assert all(a.shape == (5, 2048) and np.isfinite(a).all() for a in arrs)


def test_cuda_without_gpu_raises(env, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg, comm, _ = env
    with pytest.raises(RuntimeError, match="cuda"):
        port_extract.extract_features(cfg, comm, splits=["valid"],
                                      out_dir=str(tmp_path), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        port_extract.main(["--device=cuda", "--allow_random_weights"])
    assert not list(tmp_path.iterdir())


def test_several_devices_not_ported(env, tmp_path):
    """One process drives one GPU; the refusal names the torchrun command
    that runs one process per GPU instead (several processes:
    tests/test_torch_dist_eval.py)."""
    cfg, comm, _ = env
    with pytest.raises(NotImplementedError,
                       match="torchrun --standalone --nproc_per_node=2"):
        port_extract.extract_features(cfg, comm, out_dir=str(tmp_path),
                                      device="cpu", n_devices=2)


def test_port_never_imports_jax():
    """Importing every module of the port loads neither jax nor flax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vidsitu_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'vidsitu_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert 'vidsitu_tpu_torch.extract' in mods, mods\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 9


def test_converter_nonlocal_index_fault_is_pinned():
    """Known fault of the JAX package's --ckpt path: its PySlowFast
    converter walks ``nonlocal{j}`` from j=0 (vidsitu_tpu/convert/
    slowfast_torch.py:121-141), but PySlowFast, flax and the port name
    non-local modules by block index (``nonlocal1``). Such a block's
    weights are dropped, and strict conversion refuses the leftovers. The
    port's own converter walks the block indices (next test); the JAX
    package stays as it is, and this test pins it (ROADMAP.md, Queue 3)."""
    from vidsitu_tpu.convert.slowfast_torch import convert_video_backbone

    rng = np.random.default_rng(0)
    sd = {}
    for conv in ("conv_theta", "conv_phi", "conv_g", "conv_out"):
        sd[f"s3.pathway0_nonlocal1.{conv}.weight"] = rng.standard_normal(
            (4, 4, 1, 1, 1)).astype(np.float32)
        sd[f"s3.pathway0_nonlocal1.{conv}.bias"] = np.zeros(4, np.float32)
    for name in ("weight", "bias", "running_mean", "running_var"):
        sd[f"s3.pathway0_nonlocal1.bn.{name}"] = np.ones(4, np.float32)
    sd["s1.pathway0_stem.conv.weight"] = np.zeros((8, 3, 1, 7, 7), np.float32)
    for name in ("weight", "bias", "running_mean", "running_var"):
        sd[f"s1.pathway0_stem.bn.{name}"] = np.ones(8, np.float32)
    params, _ = convert_video_backbone(sd, "i3d")
    assert "nl_1" not in params.get("s3", {})
    with pytest.raises(ValueError, match="12"):
        convert_video_backbone(sd, "i3d", strict=True)


@pytest.mark.parametrize("blocks", [(1,), (1, 3), (1, 3, 5)])
def test_port_converter_keeps_nonlocal_weights_named_by_block_index(blocks):
    """The port's own converter (vidsitu_tpu_torch/convert/slowfast_torch.py)
    walks ``nonlocal{i}`` by block index, so an I3D-NL state dict keeps all
    twelve keys of every non-local block and strict conversion passes."""
    from vidsitu_tpu_torch.convert.slowfast_torch import convert_video_backbone

    rng = np.random.default_rng(0)
    sd = {}
    for i in blocks:
        for conv in ("conv_theta", "conv_phi", "conv_g", "conv_out"):
            sd[f"s3.pathway0_nonlocal{i}.{conv}.weight"] = (
                rng.standard_normal((4, 4, 1, 1, 1)).astype(np.float32))
            sd[f"s3.pathway0_nonlocal{i}.{conv}.bias"] = rng.standard_normal(
                4).astype(np.float32)
        for name in ("weight", "bias", "running_mean", "running_var"):
            sd[f"s3.pathway0_nonlocal{i}.bn.{name}"] = rng.standard_normal(
                4).astype(np.float32)
    sd["s1.pathway0_stem.conv.weight"] = np.zeros((8, 3, 1, 7, 7), np.float32)
    for name in ("weight", "bias", "running_mean", "running_var"):
        sd[f"s1.pathway0_stem.bn.{name}"] = np.ones(8, np.float32)
    params, stats = convert_video_backbone(sd, "i3d", strict=True)
    assert sorted(params["s3"]) == [f"nl_{i}" for i in blocks]
    for i in blocks:
        nl = params["s3"][f"nl_{i}"]
        src = f"s3.pathway0_nonlocal{i}"
        for ours, theirs in (("theta", "conv_theta"), ("phi", "conv_phi"),
                             ("g", "conv_g"), ("out", "conv_out")):
            np.testing.assert_array_equal(
                nl[ours]["kernel"],
                sd[f"{src}.{theirs}.weight"].transpose(2, 3, 4, 1, 0))
            np.testing.assert_array_equal(nl[ours]["bias"],
                                          sd[f"{src}.{theirs}.bias"])
        np.testing.assert_array_equal(nl["bn"]["scale"], sd[f"{src}.bn.weight"])
        np.testing.assert_array_equal(stats["s3"][f"nl_{i}"]["bn"]["var"],
                                      sd[f"{src}.bn.running_var"])
