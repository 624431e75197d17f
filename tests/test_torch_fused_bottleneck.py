"""The port's fused inference bottleneck (vidsitu_tpu_torch/ops/
fused_bottleneck.py) against the TPU probe and the unfused blocks.

On the CPU the port's wrapper takes its plain version, and the TPU probe
(benchmarks/probe_fused_bottleneck.py) runs in Pallas interpret mode, loaded
from its file as tests/test_fused_bottleneck.py loads it. The same seeded
flax-layout weights feed both (convert/from_flax.py carries them into the
port's ``Bottleneck``), and the inputs come from a numpy seed. Tolerance:
rtol = atol = 2e-5 in float32, that test's own.

``benchmarks/micro4.py`` (the multi-frame TPU variant) and ``micro3.py`` time
their kernels on a TPU while they are imported, so they cannot be imported on
the CPU: the multi-frame entry is held against
``probe.fused_bottleneck_frames(..., interpret=True)`` without projection,
which computes the same function.

The CUDA kernels run only on a GPU: those cases are marked ``cuda`` and skip
elsewhere.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsitu_tpu_torch.convert.from_flax import (
    load_flax_variables,
    seeded_variables,
)
from vidsitu_tpu_torch.models.video_backbone import Bottleneck, VideoCfg
from vidsitu_tpu_torch.ops import fused_bottleneck as FB

_spec = importlib.util.spec_from_file_location(
    "probe_fused_bottleneck",
    Path(__file__).resolve().parent.parent
    / "benchmarks" / "probe_fused_bottleneck.py",
)
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)

TOL = dict(rtol=2e-5, atol=2e-5)
DIM_INNER, DIM_OUT = 16, 32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _block_and_vars(needs_proj: bool, seed: int = 0, temp_kernel: int = 1,
                    stride: int = 1):
    """A port Bottleneck in eval mode, the seeded flax-layout variables it
    was loaded from, and an input (N, T, H, W, Cin) from a numpy seed."""
    cin = 24 if needs_proj else DIM_OUT
    block = Bottleneck(cin, DIM_OUT, DIM_INNER, temp_kernel, stride, VideoCfg())
    variables = seeded_variables(block, seed)
    load_flax_variables(block, variables)
    block.eval()
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, 2, 7, 9, cin)).astype(np.float32)
    return block, variables, x


def _jnp_tree(tree):
    return {k: _jnp_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("needs_proj", [False, True])
def test_plain_fused_block_matches_tpu_probe(needs_proj):
    block, variables, x = _block_and_vars(needs_proj)
    want = probe.run_fused_block(
        _jnp_tree(variables), jnp.asarray(x), dim_inner=DIM_INNER,
        dim_out=DIM_OUT, bn_eps=block.a.bn.eps, interpret=True)
    got = FB.run_fused_block(block, torch.from_numpy(x))
    assert ("proj" in variables["params"]) == needs_proj
    assert got.shape == (2, 2, 7, 9, DIM_OUT) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("needs_proj", [False, True])
def test_plain_fused_block_matches_unfused_blocks(needs_proj):
    """Against the port's unfused Bottleneck in eval mode, and the JAX
    package's on the same weights."""
    block, variables, x = _block_and_vars(needs_proj, seed=3)
    got = FB.run_fused_block(block, torch.from_numpy(x)).numpy()
    with torch.no_grad():
        unfused = block(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(
        got, unfused.permute(0, 2, 3, 4, 1).numpy(), **TOL)
    # imported here: flax is not needed by the cuda-marked cases below
    from vidsitu_tpu.models.video_backbone import Bottleneck as FlaxBottleneck
    from vidsitu_tpu.models.video_backbone import VideoCfg as FlaxVideoCfg

    flax_block = FlaxBottleneck(
        dim_out=DIM_OUT, dim_inner=DIM_INNER, temp_kernel=1, spatial_stride=1,
        cfg=FlaxVideoCfg(dtype=jnp.float32, param_dtype=jnp.float32,
                         zero_init_final_bn=False))
    want = flax_block.apply(_jnp_tree(variables), jnp.asarray(x), train=False)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_fold_conv_bn_matches_jax():
    rng = np.random.default_rng(5)
    kernel = rng.standard_normal((3, 3, 8, 12)).astype(np.float32)
    scale, bias, mean = (rng.standard_normal(12).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    w_j, b_j = probe.fold_conv_bn(*map(jnp.asarray,
                                       (kernel, scale, bias, mean, var)), 1e-5)
    w_t, b_t = FB.fold_conv_bn(*map(torch.from_numpy,
                                    (kernel, scale, bias, mean, var)), 1e-5)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("needs_proj", [False, True])
def test_fold_bottleneck_layouts_match_the_probe_operands(needs_proj):
    """The folded weights of a port Bottleneck equal, operand by operand,
    what the TPU probe folds from the same flax variables."""
    block, variables, x = _block_and_vars(needs_proj, seed=7)
    got = FB.fold_bottleneck(block)
    params, stats = variables["params"], variables["batch_stats"]
    cin = x.shape[-1]
    shapes = {"a": (cin, DIM_INNER), "b": (3, 3, DIM_INNER, DIM_INNER),
              "c": (DIM_INNER, DIM_OUT), "proj": (cin, DIM_OUT)}
    names = ("a", "b", "c") + (("proj",) if needs_proj else ())
    for i, name in enumerate(names):
        w, b = probe.fold_conv_bn(
            jnp.asarray(params[name]["conv"]["kernel"]),
            *(jnp.asarray(t[name]["bn"][k]) for t, k in (
                (params, "scale"), (params, "bias"), (stats, "mean"),
                (stats, "var"))), block.a.bn.eps)
        assert tuple(got[2 * i].shape) == shapes[name]
        assert tuple(got[2 * i + 1].shape) == (1, shapes[name][-1])
        np.testing.assert_allclose(
            got[2 * i].numpy(), np.asarray(w).reshape(shapes[name]),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            got[2 * i + 1].numpy().ravel(), np.asarray(b), rtol=1e-6, atol=1e-6)
    if not needs_proj:
        assert got[6] is None and got[7] is None


@pytest.mark.parametrize("frames_per_step", [1, 2, 4])
def test_multi_frame_entry_plain_path_matches_tpu_probe(frames_per_step):
    block, _, x = _block_and_vars(False, seed=11)
    wa, ba, wb, bb, wc, bc, _, _ = FB.fold_bottleneck(block)
    frames = torch.from_numpy(x).reshape(4, 7, 9, DIM_OUT)
    got = FB.fused_bottleneck(frames, wa, ba, wb, bb, wc, bc,
                              frames_per_step=frames_per_step)
    want = probe.fused_bottleneck_frames(
        jnp.asarray(frames.numpy()),
        *(jnp.asarray(t.numpy()) for t in (wa, ba, wb, bb, wc, bc)),
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("temp_kernel,stride,match", [
    (3, 1, "temporal kernel"), (1, 2, "stride")])
def test_contract_errors(temp_kernel, stride, match):
    block, _, x = _block_and_vars(True, temp_kernel=temp_kernel, stride=stride)
    with pytest.raises(ValueError, match=match):
        FB.run_fused_block(block, torch.from_numpy(x))


def test_shape_errors_and_cpu_refusal_of_the_kernel_wrappers():
    block, _, x = _block_and_vars(True)
    ops = FB.fold_bottleneck(block)
    frames = torch.from_numpy(x).reshape(4, 7, 9, 24)
    with pytest.raises(ValueError, match="projection"):
        FB.fused_bottleneck_plain(frames, *ops[:6])  # Cin != Cout, no wp
    with pytest.raises(ValueError, match="wb must be"):
        FB.fused_bottleneck_plain(frames, ops[0], ops[1], ops[2][:2], *ops[3:])
    with pytest.raises(ValueError, match="no projection"):
        FB.fused_bottleneck(frames, *ops, frames_per_step=2)
    # the kernel wrappers never fall back: a CPU tensor is refused
    with pytest.raises(ValueError, match="not CUDA"):
        FB.fused_bottleneck_frames(frames, *ops)
    assert FB.LAUNCHES == {"fused_bottleneck_frames": 0,
                           "fused_bottleneck_multi": 0}


def test_bf16_plain_rounds_where_the_kernel_rounds():
    """bf16 in, bf16 out, float32 sums: close to the float32 result at
    bf16's resolution."""
    block, _, x = _block_and_vars(True, seed=13)
    y32 = FB.run_fused_block(block, torch.from_numpy(x))
    y16 = FB.run_fused_block(block, torch.from_numpy(x), dtype=torch.bfloat16)
    assert y16.dtype == torch.bfloat16
    scale = y32.abs().max().item()
    assert (y16.float() - y32).abs().max().item() <= 5e-2 * scale


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _seeded_operands(rng, cin, cmid, cout, proj, dtype, dev):
    def w(*shape):
        fan_in = int(np.prod(shape[:-1]))
        return torch.from_numpy(
            (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)
        ).to(dev, dtype)

    def b(n):
        return torch.from_numpy(
            (0.1 * rng.standard_normal((1, n))).astype(np.float32)).to(dev)

    ops = [w(cin, cmid), b(cmid), w(3, 3, cmid, cmid), b(cmid),
           w(cmid, cout), b(cout)]
    return ops + ([w(cin, cout), b(cout)] if proj else [None, None])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("shape", [
    (3, 7, 9, 24, 16, 32, True), (2, 56, 56, 80, 64, 256, True),
    (2, 56, 56, 256, 64, 256, False), (2, 28, 28, 512, 128, 512, False)])
def test_kernels_match_plain_on_gpu(cuda_device, shape, dtype, tol):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, w, cin, cmid, cout, proj = shape
    rng = np.random.default_rng(0)
    ops = _seeded_operands(rng, cin, cmid, cout, proj, dtype, cuda_device)
    x = torch.from_numpy(rng.standard_normal((b, h, w, cin)).astype(
        np.float32)).to(cuda_device, dtype)
    want = FB.fused_bottleneck_plain(x, *ops).float()
    limit = tol * (want.abs().max().item() if dtype == torch.bfloat16 else 1)
    got = FB.fused_bottleneck_frames(x, *ops)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= limit
    if not proj:
        for fps in (1, 4):
            got = FB.fused_bottleneck_multi(x, *ops[:6], frames_per_step=fps)
            torch.cuda.synchronize()
            assert (got.float() - want).abs().max().item() <= limit
