"""Port attention (vidsitu_tpu_torch/ops/attention.py) against the JAX
package's: the plain PyTorch version against ``_einsum_attention`` and
against the Pallas kernel in interpret mode, on numpy-seeded inputs.

Tolerances are the JAX package's own (tests/test_pallas_attention.py):
atol 2e-4 in float32, 5e-2 for bfloat16 inputs compared in float32; float16
inputs (three more bits than bfloat16) are held at 2e-2. The
CUDA kernels themselves run only on a GPU: their tests here skip without one,
and chip_smoke.py holds both entries against the plain version at the
backbone's shapes. tests/test_torch_attention_tiled.py holds the wgmma
kernel's tiled arithmetic and the routing between the entries.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsitu_tpu.ops.attention import _einsum_attention, fused_attention
from vidsitu_tpu_torch.ops import attention as port

torch.set_num_threads(1)

ATOL = {"float32": 2e-4, "bfloat16": 5e-2, "float16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}


def _inputs(seed, b, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, d)).astype(np.float32)
            for s in (sq, sk, sk)]


def _port(arrs, dtype, kind, scale, fn=port.attention_reference):
    q, k, v = (torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs)
    return fn(q, k, v, kind, scale).float().numpy()


def _jax(arrs, dtype, kind, scale):
    q, k, v = (jnp.asarray(a, dtype) for a in arrs)
    return np.asarray(_einsum_attention(q, k, v, kind, scale), np.float32)


# (b, sq, sk, d): the shapes of tests/test_pallas_attention.py, then key
# counts that are no multiple of 128 (the I3D-NL stage-4 count is 196)
SHAPES = [(2, 640, 640, 128), (1, 200, 256, 128), (1, 128, 200, 128),
          (1, 256, 256, 128), (2, 100, 196, 64), (1, 64, 200, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["softmax", "dot_product"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_reference_matches_einsum(shape, kind, dtype):
    arrs = _inputs(0, *shape)
    scale = shape[-1] ** -0.5
    out = _port(arrs, dtype, kind, scale)
    ref = _jax(arrs, dtype, kind, scale)
    assert out.shape == ref.shape == shape[:2] + shape[-1:]
    np.testing.assert_allclose(out, ref, atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("kind", ["softmax", "dot_product"])
def test_reference_matches_pallas_interpret(kind):
    """The Pallas kernel as the JAX tests run it on a CPU (interpret mode),
    at a shape where it takes the kernel (Sk a multiple of 128)."""
    b, s, d = 2, 640, 128
    arrs = _inputs(1, b, s, s, d)
    q, k, v = (jnp.asarray(a) for a in arrs)
    ref = np.asarray(fused_attention(q, k, v, kind=kind, scale=d ** -0.5,
                                     q_block=128, interpret=True))
    np.testing.assert_allclose(_port(arrs, "float32", kind, d ** -0.5), ref,
                               atol=ATOL["float32"], rtol=0)


def test_dispatch_cpu_takes_reference_and_counts_nothing():
    arrs = _inputs(2, 2, 50, 30, 16)
    before = port.LAUNCHES
    out = _port(arrs, "float32", "softmax", 0.25, fn=port.nonlocal_attention)
    np.testing.assert_array_equal(
        out, _port(arrs, "float32", "softmax", 0.25))
    assert port.LAUNCHES == before


def test_kernel_wrapper_rejects_cpu_and_bad_kind():
    q = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="not CUDA"):
        port.fused_attention(q, q, q, "softmax")
    with pytest.raises(ValueError, match="kind"):
        port.fused_attention(q, q, q, "linear")
    with pytest.raises(ValueError, match="kind"):
        port.attention_reference(q, q, q, "linear", 1.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a GPU (chip_smoke.py runs it)")
    return torch.device("cuda")


# (entry, dtype, d): what each entry takes; B = 33 spans more than one wave
# of neither kernel but exercises gridDim.y, Sq and Sk are ragged against
# both kernels' tiles
GPU_CASES = (
    [("nl_attn_fwd_wgmma", "bfloat16", d) for d in (64, 128, 256, 512)]
    + [("nl_attn_fwd", "bfloat16", d) for d in (24, 64, 128, 256, 512)]
    + [("nl_attn_fwd", "float32", d) for d in (24, 64, 128, 256, 512)]
    + [("nl_attn_fwd_wgmma", "float16", d) for d in (64, 128, 256, 512)]
    + [("nl_attn_fwd", "float16", d) for d in (24, 64, 128, 256, 512)])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 33])
@pytest.mark.parametrize("kind", ["softmax", "dot_product"])
@pytest.mark.parametrize("entry,dtype,d", GPU_CASES,
                         ids=lambda x: str(x))
def test_kernel_matches_reference_on_gpu(cuda_device, entry, dtype, d, kind, b):
    sq, sk = 70, 130
    arrs = _inputs(3, b, sq, sk, d)
    if kind == "dot_product":
        # keeps one 16-bit step of the largest output under the tolerance
        arrs[0] *= np.float32(0.25)
    q, k, v = (torch.from_numpy(a).to(cuda_device, TORCH_DT[dtype])
               for a in arrs)
    port.reset_launches()
    out = port.fused_attention(q, k, v, kind, d ** -0.5, entry=entry)
    ref = port.attention_reference(q, k, v, kind, d ** -0.5)
    torch.cuda.synchronize()
    assert port.LAUNCHES == 1 and port.LAUNCHES_BY_ENTRY[entry] == 1
    assert out.dtype == q.dtype
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(),
                               atol=ATOL[dtype], rtol=0)


@pytest.mark.cuda
def test_routing_and_forced_entry_on_gpu(cuda_device):
    """Unforced calls take the entry ``kernel_entry`` names; the wgmma entry
    refuses what it does not take instead of handing it on."""
    port.reset_launches()
    for dtype, d in ((torch.bfloat16, 256), (torch.float32, 256),
                     (torch.bfloat16, 24)):
        q = torch.zeros(2, 40, d, device=cuda_device, dtype=dtype)
        port.fused_attention(q, q, q, "softmax")
    torch.cuda.synchronize()
    assert port.LAUNCHES_BY_ENTRY == {"nl_attn_fwd_wgmma": 1, "nl_attn_fwd": 2,
                                      **dict.fromkeys(port.BWD_ENTRIES, 0)}
    assert port.LAUNCHES_BY_DTYPE["bfloat16"]["nl_attn_fwd"] == 1
    for dtype, d in ((torch.float32, 256), (torch.bfloat16, 24)):
        q = torch.zeros(2, 40, d, device=cuda_device, dtype=dtype)
        with pytest.raises(ValueError, match="nl_attn_fwd_wgmma takes"):
            port.fused_attention(q, q, q, "softmax", entry="nl_attn_fwd_wgmma")
    assert port.LAUNCHES == 3


@pytest.mark.cuda
def test_float16_routing_on_gpu(cuda_device):
    """float16 takes the wgmma entry at the four widths and the WMMA entry
    at the others, counted under its dtype."""
    port.reset_launches()
    for d in (64, 256, 24):
        q = torch.zeros(2, 40, d, device=cuda_device, dtype=torch.float16)
        port.fused_attention(q, q, q, "softmax")
    torch.cuda.synchronize()
    assert port.LAUNCHES_BY_DTYPE["float16"] == {
        "nl_attn_fwd_wgmma": 2, "nl_attn_fwd": 1,
        **dict.fromkeys(port.BWD_ENTRIES, 0)}
    assert port.LAUNCHES == 3


def test_launch_counts_by_dtype_reset_together():
    port.LAUNCHES_BY_DTYPE["float16"]["nl_attn_fwd"] = 3
    port.LAUNCHES_BY_ENTRY["nl_attn_fwd"] = 3
    port.reset_launches()
    assert not any(any(c.values()) for c in port.LAUNCHES_BY_DTYPE.values())
    assert set(port.LAUNCHES_BY_DTYPE) == {"float32", "bfloat16", "float16"}
    assert not any(port.LAUNCHES_BY_ENTRY.values())
