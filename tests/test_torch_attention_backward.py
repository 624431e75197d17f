"""The attention's backward in the port (vidsitu_tpu_torch/ops/attention.py)
against ``jax.grad`` of the JAX package's ``nonlocal_attention``, which on
the CPU (and at the backbone's key counts on any device) takes
``_einsum_attention``, on numpy-seeded inputs and output gradients.

Checked: ``attention_backward_reference``, autograd of
``attention_reference``, ``attention_backward_tiled_reference`` on the
statistics of ``attention_tiled_reference``, and ``NonLocalAttnFn`` with
those tiled plain versions swapped in for the kernels (so that its wiring,
saved tensors, scale, casts and non-contiguous upstream gradients run here).
Both kinds, ragged Sq / Sk. Tolerances are the JAX package's: atol 2e-4 in
float32 and 5e-2 for bfloat16 inputs, relative to each gradient's scale.
``gradcheck`` in float64. The ``cuda`` cases compare the kernel with the
plain versions and skip without a GPU; chip_smoke.py phase 16 runs them at
the backbone's shapes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsitu_tpu.ops.attention import nonlocal_attention as jax_attention
from vidsitu_tpu_torch.ops import attention as port

torch.set_num_threads(1)

TOL = {"float32": 2e-4, "bfloat16": 5e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (B, Sq, Sk, d): ragged against every tile of both passes
SHAPES = [(2, 70, 33, 64), (1, 45, 130, 128), (2, 37, 19, 256)]
KINDS = ("softmax", "dot_product")


def _inputs(seed, b, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, d)).astype(np.float32)
            for s in (sq, sk, sk, sq)]  # q, k, v, dO


@pytest.fixture(scope="module")
def jax_grads():
    """jax.grad of the JAX package's attention for every case, built once."""
    out = {}
    for i, (b, sq, sk, d) in enumerate(SHAPES):
        arrs = _inputs(i, b, sq, sk, d)
        for kind in KINDS:
            for dtype in ("float32", "bfloat16"):
                q, k, v, do = (jnp.asarray(a, dtype) for a in arrs)
                scale = d ** -0.5

                def f(q, k, v):
                    o = jax_attention(q, k, v, kind, scale)
                    return jnp.sum(o.astype(jnp.float32)
                                   * do.astype(jnp.float32))

                grads = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
                out[(i, kind, dtype)] = [np.asarray(g, np.float32)
                                         for g in grads]
    return out


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs]


def _check(got, want, dtype):
    for g, w in zip(got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        scale = np.abs(w).max()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=TOL[dtype] * scale, rtol=0)


def _tiled_forward(q, k, v, kind, scale):
    return port.attention_tiled_reference(
        q, k, v, kind, scale, port.wgmma_block_k(q.shape[-1]), return_lse=True)


@pytest.fixture
def plain_function(monkeypatch):
    """NonLocalAttnFn with the tiled plain versions in place of the
    kernels."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(*a):
        calls["fwd"] += 1
        return _tiled_forward(*a)

    def bwd(*a):
        calls["bwd"] += 1
        return port.attention_backward_tiled_reference(*a)

    monkeypatch.setattr(port.NonLocalAttnFn, "forward_impl",
                        staticmethod(fwd))
    monkeypatch.setattr(port.NonLocalAttnFn, "backward_impl",
                        staticmethod(bwd))
    return calls


CASES = [(i, kind, dtype) for i in range(len(SHAPES)) for kind in KINDS
         for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("i,kind,dtype", CASES)
def test_backward_reference_matches_jax_grad(jax_grads, i, kind, dtype):
    b, sq, sk, d = SHAPES[i]
    q, k, v, do = _torch(_inputs(i, b, sq, sk, d), dtype)
    o = port.attention_reference(q, k, v, kind, d ** -0.5)
    got = port.attention_backward_reference(q, k, v, o, do, kind, d ** -0.5)
    assert all(g.dtype == q.dtype for g in got)
    _check(got, jax_grads[(i, kind, dtype)], dtype)


@pytest.mark.parametrize("i,kind,dtype", CASES)
def test_autograd_of_plain_attention_matches_jax_grad(jax_grads, i, kind,
                                                      dtype):
    b, sq, sk, d = SHAPES[i]
    q, k, v, do = _torch(_inputs(i, b, sq, sk, d), dtype)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    o = port.nonlocal_attention(*leaves, kind, d ** -0.5)  # CPU: plain
    got = torch.autograd.grad(o, leaves, do)
    _check(got, jax_grads[(i, kind, dtype)], dtype)


@pytest.mark.parametrize("i,kind,dtype", CASES)
def test_tiled_backward_matches_jax_grad(jax_grads, i, kind, dtype):
    b, sq, sk, d = SHAPES[i]
    q, k, v, do = _torch(_inputs(i, b, sq, sk, d), dtype)
    o, lse = _tiled_forward(q, k, v, kind, d ** -0.5)
    if kind == "softmax":
        # the statistics: log2 of the row sums of 2^(logits * scale * log2 e)
        logits = torch.bmm(q.float(), k.float().transpose(1, 2)) * d ** -0.5
        want = torch.logsumexp(logits, -1) / math.log(2)
        np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5)
    else:
        assert lse is None
    tiles = port.bwd_tiles(q.dtype, d)
    for block_q, block_k in (tiles["kv"][::-1], tiles["q"]):
        got = port.attention_backward_tiled_reference(
            q, k, v, o, do, lse, kind, d ** -0.5, block_q, block_k)
        _check(got, jax_grads[(i, kind, dtype)], dtype)


@pytest.mark.parametrize("i,kind,dtype", CASES)
def test_function_with_plain_versions_matches_jax_grad(
        jax_grads, plain_function, i, kind, dtype):
    b, sq, sk, d = SHAPES[i]
    q, k, v, do = _torch(_inputs(i, b, sq, sk, d), dtype)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    o = port.NonLocalAttnFn.apply(*leaves, kind, d ** -0.5)
    assert o.dtype == q.dtype and plain_function == {"fwd": 1, "bwd": 0}
    # the upstream gradient arrives as a non-contiguous view
    o.backward(do.transpose(1, 2).contiguous().transpose(1, 2))
    assert plain_function == {"fwd": 1, "bwd": 1}
    _check([t.grad for t in leaves], jax_grads[(i, kind, dtype)], dtype)


@pytest.mark.parametrize("kind", KINDS)
def test_function_gradcheck_float64(plain_function, kind):
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, s, 8)))
               .requires_grad_() for s in (9, 7, 7))
    assert torch.autograd.gradcheck(
        lambda q, k, v: port.NonLocalAttnFn.apply(q, k, v, kind, 0.4),
        (q, k, v))


def test_function_saves_inputs_output_and_statistics(plain_function):
    q, k, v = (torch.randn(1, s, 16, requires_grad=True) for s in (5, 4, 4))
    o = port.NonLocalAttnFn.apply(q, k, v, "softmax", 0.25)
    saved = o.grad_fn.saved_tensors
    assert len(saved) == 5
    assert all(a is b or torch.equal(a, b) for a, b in zip(saved[:3], (q, k, v)))
    assert torch.equal(saved[3], o.detach()) and saved[4].shape == (1, 5)
    dot = port.NonLocalAttnFn.apply(q, k, v, "dot_product", 0.25)
    assert dot.grad_fn.saved_tensors[4] is None  # no statistics


def test_function_scale_reaches_both_sides(plain_function):
    """A scale other than d**-0.5 changes the forward and the gradient as
    the plain autograd does."""
    rng = np.random.default_rng(8)
    arrs = [torch.from_numpy(rng.standard_normal((1, s, 16)).astype(
        np.float32)) for s in (6, 5, 5)]
    a = [t.clone().requires_grad_() for t in arrs]
    b = [t.clone().requires_grad_() for t in arrs]
    port.NonLocalAttnFn.apply(*a, "softmax", 0.9).sum().backward()
    port.attention_reference(*b, "softmax", 0.9).sum().backward()
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), atol=1e-5)


def test_cpu_dispatch_is_plain_autograd_and_counts_nothing():
    port.reset_launches()
    q, k, v = (torch.randn(1, s, 16, requires_grad=True) for s in (5, 4, 4))
    port.nonlocal_attention(q, k, v, "softmax", 0.25).sum().backward()
    assert q.grad is not None and port.LAUNCHES == 0
    assert not any(port.LAUNCHES_BY_ENTRY.values())


def test_backward_wrapper_raises_on_cpu_before_any_build(monkeypatch):
    from vidsitu_tpu_torch.ops import _build

    def no_build():
        raise AssertionError("the library must not be built for a CPU tensor")

    monkeypatch.setattr(_build, "load_nonlocal_attn", no_build)
    q = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError, match="not CUDA"):
        port.fused_attention_backward(q, q, q, q, q, torch.zeros(1, 8))
    with pytest.raises(ValueError, match="kind"):
        port.fused_attention_backward(q, q, q, q, q, None, kind="linear")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128, 256, 512])
def test_backward_tiles_fit_shared_memory(dtype, d):
    for kv in (True, False):
        assert port.bwd_smem_bytes(dtype, d, kv) <= port.BWD_SMEM_LIMIT
    na, ns = port.bwd_tiles(dtype, d)["kv"]
    assert na % 16 == 0 and ns % 16 == 0


def test_backward_tiles_match_the_cuda_source():
    """bwd_tiles repeats the table of bwd::Cfg in csrc/nonlocal_attn.cu."""
    text = (port._build.CSRC_DIR / "nonlocal_attn.cu").read_text()
    assert ("static constexpr int NA = kBf16 ? (DP >= 512 ? (KV ? 16 : 32)\n"
            "                                     : DP == 256 ? (KV ? 32 : 64) "
            ": 64)\n                                  : (DP >= 512 ? 16 : 32);"
            in text)
    assert ("static constexpr int NS = kBf16 ? (DP >= 512 ? 32\n"
            "                                     : DP == 256 ? (KV ? 64 : 32) "
            ": 64)\n                                  : (DP >= 512 ? 16 : 32);"
            in text)
    assert "static_assert(kBytes <= 232448" in text


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a GPU (chip_smoke.py runs it)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES + [(3, 65, 196, 512)])
def test_backward_kernel_matches_plain_on_gpu(cuda_device, shape, kind,
                                              dtype):
    b, sq, sk, d = shape
    q, k, v, do = (t.to(cuda_device)
                   for t in _torch(_inputs(3, b, sq, sk, d), dtype))
    port.reset_launches()
    o, lse = port.fused_attention(q, k, v, kind, d ** -0.5, with_lse=True)
    got = port.fused_attention_backward(q, k, v, o, do, lse, kind, d ** -0.5)
    torch.cuda.synchronize()
    assert port.LAUNCHES_BY_ENTRY[port.BWD_ENTRY] == 1
    for want in (port.attention_backward_reference(q, k, v, o, do, kind,
                                                   d ** -0.5),
                 port.attention_backward_tiled_reference(
                     q, k, v, o, do, lse, kind, d ** -0.5)):
        _check([g.cpu() for g in got], [w.float().cpu().numpy()
                                        for w in want], dtype)


@pytest.mark.cuda
def test_dispatch_takes_the_function_under_grad_on_gpu(cuda_device):
    q, k, v = (torch.randn(2, s, 64, device=cuda_device,
                           dtype=torch.bfloat16, requires_grad=True)
               for s in (40, 30, 30))
    port.reset_launches()
    port.nonlocal_attention(q, k, v, "softmax", 0.125).float().sum().backward()
    assert port.LAUNCHES_BY_ENTRY["nl_attn_fwd_wgmma"] == 1
    assert port.LAUNCHES_BY_ENTRY[port.BWD_ENTRY] == 1
    with torch.no_grad():
        port.nonlocal_attention(q, k, v, "softmax", 0.125)
    assert port.LAUNCHES_BY_ENTRY[port.BWD_ENTRY] == 1
