"""The wgmma backward entry (``nl_attn_bwd_wgmma``) of the port's attention,
without a GPU: its arithmetic, routing, forced-entry refusals and the
shared-memory budget that the CUDA source asserts.

``attention_backward_tiled_reference(..., entry="nl_attn_bwd_wgmma")``
repeats the kernel's steps in plain PyTorch at its tiles (``bwd_wgmma_tiles``:
64 own keys against 64 streamed queries, 16 at d = 512; 128 own queries
against 64 / 32 / 16 streamed keys), with Sq and Sk ragged against every
tile. It is held against ``jax.grad`` of the JAX package's
``_einsum_attention`` on numpy-seeded inputs and output gradients, both
kinds, in float64 and bfloat16. Tolerances, relative to each gradient's
scale, are tests/test_torch_attention_backward.py's: 5e-2 for bfloat16
inputs, 2e-4 for float64, since ``_einsum_attention`` computes in float32
whatever its inputs' type. The ``cuda`` cases hold the kernel against the
plain versions at chip_smoke.py phase 2's shapes and skip without a GPU.
"""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsitu_tpu.ops.attention import _einsum_attention
from vidsitu_tpu_torch.ops import _build
from vidsitu_tpu_torch.ops import attention as port

torch.set_num_threads(1)

WGMMA = "nl_attn_bwd_wgmma"
TOL = {"float64": 2e-4, "bfloat16": 5e-2}
TORCH_DT = {"float64": torch.float64, "bfloat16": torch.bfloat16}
JAX_DT = {"float64": jnp.float64, "bfloat16": jnp.bfloat16}
# (B, Sq, Sk, d), ragged against both passes' tiles at each width: Sq past
# 64 (and 128), Sk past 64 / 32 / 16
SHAPES = [(2, 70, 33, 64), (1, 45, 130, 128), (1, 130, 70, 256),
          (1, 20, 19, 512)]
KINDS = ("softmax", "dot_product")
CASES = [(i, kind, dtype) for i in range(len(SHAPES)) for kind in KINDS
         for dtype in ("float64", "bfloat16")]
SOURCE = _build.CSRC_DIR / "nonlocal_attn.cu"


def _inputs(seed, b, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, d)).astype(np.float32)
            for s in (sq, sk, sk, sq)]  # q, k, v, dO


@pytest.fixture(scope="module")
def jax_grads():
    """jax.grad of ``_einsum_attention`` for every case; float64 with
    ``jax_enable_x64`` set for the call only."""
    out = {}
    prev = jax.config.jax_enable_x64
    try:
        for i, (b, sq, sk, d) in enumerate(SHAPES):
            arrs = _inputs(100 + i, b, sq, sk, d)
            for kind in KINDS:
                for dtype in ("float64", "bfloat16"):
                    jax.config.update("jax_enable_x64", dtype == "float64")
                    q, k, v, do = (jnp.asarray(a, JAX_DT[dtype]) for a in arrs)
                    scale = d ** -0.5

                    def f(q, k, v):
                        o = _einsum_attention(q, k, v, kind, scale)
                        return jnp.sum(o.astype(jnp.float32)
                                       * do.astype(jnp.float32))

                    grads = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
                    out[(i, kind, dtype)] = [np.asarray(g, np.float64)
                                             for g in grads]
    finally:
        jax.config.update("jax_enable_x64", prev)
    return out


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs]


def _check(got, want, dtype):
    for g, w in zip(got, want):
        g = g.double().numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=TOL[dtype] * np.abs(w).max(),
                                   rtol=0)


def _tiled_forward(q, k, v, kind, scale):
    return port.attention_tiled_reference(
        q, k, v, kind, scale, port.wgmma_block_k(q.shape[-1]), return_lse=True)


@pytest.mark.parametrize("i,kind,dtype", CASES)
def test_wgmma_tiled_backward_matches_jax_grad(jax_grads, i, kind, dtype):
    """Both passes' tiles: the dK / dV pass's (keys, queries) and the dQ
    pass's (queries, keys)."""
    b, sq, sk, d = SHAPES[i]
    q, k, v, do = _torch(_inputs(100 + i, b, sq, sk, d), dtype)
    o, lse = _tiled_forward(q, k, v, kind, d ** -0.5)
    want = jax_grads[(i, kind, dtype)]
    got = port.attention_backward_tiled_reference(
        q, k, v, o, do, lse, kind, d ** -0.5, entry=WGMMA)
    assert all(g.dtype == q.dtype for g in got)
    _check(got, want, dtype)
    q_rows, block_k = port.bwd_wgmma_tiles(d)["q"]
    _check(port.attention_backward_tiled_reference(
        q, k, v, o, do, lse, kind, d ** -0.5, q_rows, block_k), want, dtype)


@pytest.fixture
def wgmma_function(monkeypatch):
    """NonLocalAttnFn with the tiled plain versions in place of the kernels,
    the backward at the wgmma entry's tiles."""
    calls = []

    def bwd(*a):
        calls.append(a[-2:])  # kind, scale
        return port.attention_backward_tiled_reference(*a, entry=WGMMA)

    monkeypatch.setattr(port.NonLocalAttnFn, "forward_impl",
                        staticmethod(_tiled_forward))
    monkeypatch.setattr(port.NonLocalAttnFn, "backward_impl",
                        staticmethod(bwd))
    return calls


@pytest.mark.parametrize("i,kind", [(i, kind) for i in range(len(SHAPES))
                                    for kind in KINDS])
def test_function_at_wgmma_tiles_matches_jax_grad(jax_grads, wgmma_function,
                                                  i, kind):
    b, sq, sk, d = SHAPES[i]
    q, k, v, do = _torch(_inputs(100 + i, b, sq, sk, d), "bfloat16")
    leaves = [t.requires_grad_() for t in (q, k, v)]
    o = port.NonLocalAttnFn.apply(*leaves, kind, d ** -0.5)
    o.backward(do)
    assert wgmma_function == [(kind, d ** -0.5)]
    _check([t.grad for t in leaves], jax_grads[(i, kind, "bfloat16")],
           "bfloat16")


@pytest.mark.parametrize("d", [64, 128, 256, 512])
def test_bwd_kernel_entry_takes_bf16_at_the_wgmma_widths(d):
    assert port.bwd_kernel_entry(torch.bfloat16, d) == WGMMA
    assert port.bwd_kernel_entry(torch.float32, d) == "nl_attn_bwd"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [8, 24, 200, 320])
def test_bwd_kernel_entry_other_widths_keep_the_first_kernel(d, dtype):
    assert port.bwd_kernel_entry(dtype, d) == "nl_attn_bwd"


@pytest.mark.parametrize("dtype,d,exc", [
    (torch.bfloat16, 4, ValueError), (torch.bfloat16, 520, ValueError),
    (torch.float32, 36, ValueError), (torch.float8_e4m3fn, 64, TypeError),
    (torch.float64, 64, TypeError)])
def test_bwd_kernel_entry_raises_on_what_no_kernel_takes(dtype, d, exc):
    with pytest.raises(exc):
        port.bwd_kernel_entry(dtype, d)


def test_backward_entries_and_their_counts():
    assert port.BWD_ENTRIES == (WGMMA, "nl_attn_bwd")
    assert port.WGMMA_BWD_ENTRY == WGMMA and port.BWD_ENTRY == "nl_attn_bwd"
    port.LAUNCHES_BY_ENTRY[WGMMA] = 2
    port.reset_launches()
    assert port.LAUNCHES_BY_ENTRY[WGMMA] == 0


@pytest.fixture
def no_build(monkeypatch):
    def fail():
        raise AssertionError("the library must not be built for a CPU tensor")

    monkeypatch.setattr(_build, "load_nonlocal_attn", fail)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 256),
                                     (torch.bfloat16, 200),
                                     (torch.bfloat16, 24)])
def test_forced_wgmma_entry_refuses_before_any_build(no_build, dtype, d):
    q = torch.zeros(1, 8, d, dtype=dtype)
    before = (port.LAUNCHES, dict(port.LAUNCHES_BY_ENTRY))
    with pytest.raises(ValueError, match="nl_attn_bwd_wgmma takes"):
        port.fused_attention_backward(q, q, q, q, q, torch.zeros(1, 8),
                                      entry=WGMMA)
    assert (port.LAUNCHES, dict(port.LAUNCHES_BY_ENTRY)) == before


@pytest.mark.parametrize("entry", [None, *port.BWD_ENTRIES])
def test_cpu_tensors_raise_before_any_build(no_build, entry):
    q = torch.zeros(1, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not CUDA"):
        port.fused_attention_backward(q, q, q, q, q, torch.zeros(1, 8),
                                      entry=entry)


def test_unknown_backward_entry_is_rejected(no_build):
    q = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError, match="entry"):
        port.fused_attention_backward(q, q, q, q, q, None,
                                      entry="nl_attn_bwd_tma")
    with pytest.raises(ValueError, match="entry"):
        port.attention_backward_tiled_reference(q, q, q, q, q, None,
                                                "softmax", 1.0, entry="x")


@pytest.mark.parametrize("d", [8, 200, 640])
def test_wgmma_tiles_only_at_the_routed_widths(d):
    with pytest.raises(ValueError, match="nl_attn_bwd_wgmma takes"):
        port.bwd_wgmma_tiles(d)


def _wgb_constants():
    text = SOURCE.read_text()
    section = text[text.index("namespace wgb {"):]
    return {name: int(value) for name, value in re.findall(
        r"^constexpr int (k\w+) = (\d+);", section, flags=re.M)}


def test_wgmma_bwd_constants_match_the_cuda_source():
    consts = _wgb_constants()
    mirror = {
        "kBwdRows": port.WGMMA_BWD_ROWS,
        "kBwdStages": port.WGMMA_BWD_STAGES,
        "kBwdChunk": port.WGMMA_BWD_CHUNK,
        "kBwdKvBlockQ": port.WGMMA_BWD_KV_BLOCK_Q,
        "kBwdKvBlockQWide": port.WGMMA_BWD_KV_BLOCK_Q_WIDE,
        "kBwdQBlockK": port.WGMMA_BWD_Q_BLOCK_K,
        "kBwdQBlockKMid": port.WGMMA_BWD_Q_BLOCK_K_MID,
        "kBwdQBlockKWide": port.WGMMA_BWD_Q_BLOCK_K_WIDE,
    }
    assert {name: consts.get(name) for name in mirror} == mirror
    # the struct's formulas, as bwd_wgmma_tiles / bwd_wgmma_smem_bytes
    # repeat them
    text = SOURCE.read_text()
    for needle in (
            "BQ = kWide ? kBwdKvBlockQWide : kBwdKvBlockQ;",
            "QROWS = kWide ? kBwdRows : 2 * kBwdRows;",
            "kWide ? kBwdQBlockKWide : (D <= 128 ? kBwdQBlockK : "
            "kBwdQBlockKMid);",
            "kKvOwn = 2 * kBwdRows * D * 2;",
            "kKvRing = kBwdStages * 2 * kKvTile;",
            "kKvStats = kBwdStages * 2 * BQ * 4;",
            "kKvHand = kBwdRows * BQ * 4;",
            "kSmemAlign + kKvOwn + kKvRing + kKvStats + kKvHand;",
            "kQOwn = 2 * QROWS * D * 2;",
            "kQBytes = kSmemAlign + kQOwn + kBwdStages * 2 * kQTile;",
            "static_assert(kKvBytes <= kSmemLimit && kQBytes <= kSmemLimit"):
        assert needle in text, needle


@pytest.mark.parametrize("d,kv_bytes,q_bytes", [
    (64, 67584, 66560), (128, 116736, 132096), (256, 215040, 197632),
    (512, 201984, 197632)])
def test_wgmma_bwd_budget_fits_shared_memory(d, kv_bytes, q_bytes):
    assert port.bwd_wgmma_smem_bytes(d, kv=True) == kv_bytes
    assert port.bwd_wgmma_smem_bytes(d, kv=False) == q_bytes
    assert max(kv_bytes, q_bytes) <= port.WGMMA_SMEM_LIMIT == 232448
    (keys, block_q), (q_rows, block_k) = port.bwd_wgmma_tiles(d).values()
    # wgmma's M is 64 rows; its depth and the B widths step by 16
    assert keys == 64 and q_rows in (64, 128)
    assert block_q % 16 == 0 and block_k % 16 == 0


def test_source_has_the_wgmma_backward():
    text = SOURCE.read_text()
    section = text[text.index("// nl_attn_bwd_wgmma: the same gradient"):]
    for needle in ("wgmma.mma_async.sync.aligned.m64n64k16",
                   "wgmma.mma_async.sync.aligned.m64n16k16",
                   "wg::MmaRS<NC, T>::run", "cp.async.ca.shared.global",
                   "wg::cp_async_wait_all", "wg::fence_async_proxy",
                   "wg::bar_arrive(kBarHand", "wg::bar_sync(kBarHand",
                   'extern "C" int nl_attn_bwd_wgmma('):
        assert needle in section, needle
    # deterministic: no atomic instruction or intrinsic
    assert not re.search(r"\batomic[A-Z]|\batom\.|[\s\"]red\.", section)
    assert 'extern "C" int nl_attn_bwd(' in text  # the first kernel stays
    assert "vidsitu_tpu/ops/attention.py:121" in section


def test_loader_binds_both_backward_entries():
    body = inspect.getsource(_build.load_nonlocal_attn.__wrapped__)
    assert "nl_attn_bwd.argtypes" in body
    assert "nl_attn_bwd_wgmma.argtypes" in body


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a GPU (chip_smoke.py runs it)")
    return torch.device("cuda")


# chip_smoke.py phase 2's shapes: (B, Sq, Sk, d)
GPU_SHAPES = [(8, 3136, 784, 256), (8, 784, 196, 512), (8, 200, 200, 128),
              (8, 130, 57, 256), (3, 65, 196, 512)]


def _gpu_case(dev, shape, kind):
    b, sq, sk, d = shape
    q, k, v, do = (t.to(dev, torch.bfloat16) for t in _torch(
        _inputs(7, b, sq, sk, d), "float64"))
    o, lse = port.fused_attention(q, k, v, kind, d ** -0.5, with_lse=True)
    return q, k, v, o, do, lse


def _gpu_check(got, wants):
    for g, *ws in zip(got, *wants):
        for w in ws:
            top = w.float().abs().max().item()
            lim = max(TOL["bfloat16"] * top,
                      2.0 ** (np.floor(np.log2(top)) - 7))
            assert (g.float() - w.float()).abs().max().item() <= lim


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_wgmma_backward_matches_plain_and_repeats_on_gpu(cuda_device, shape,
                                                         kind):
    q, k, v, o, do, lse = _gpu_case(cuda_device, shape, kind)
    scale = shape[-1] ** -0.5
    port.reset_launches()
    got = port.fused_attention_backward(q, k, v, o, do, lse, kind, scale)
    again = port.fused_attention_backward(q, k, v, o, do, lse, kind, scale)
    torch.cuda.synchronize()
    assert port.LAUNCHES_BY_ENTRY[WGMMA] == 2 == port.LAUNCHES
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _gpu_check(got, [
        port.attention_backward_reference(q, k, v, o, do, kind, scale),
        port.attention_backward_tiled_reference(q, k, v, o, do, lse, kind,
                                                scale, entry=WGMMA)])


@pytest.mark.cuda
@pytest.mark.parametrize("entry", port.BWD_ENTRIES)
def test_both_backward_entries_forced_on_gpu(cuda_device, entry):
    shape = (3, 65, 196, 512)
    q, k, v, o, do, lse = _gpu_case(cuda_device, shape, "softmax")
    scale = shape[-1] ** -0.5
    port.reset_launches()
    got = port.fused_attention_backward(q, k, v, o, do, lse, "softmax",
                                        scale, entry=entry)
    torch.cuda.synchronize()
    assert port.LAUNCHES_BY_ENTRY[entry] == 1 == port.LAUNCHES
    _gpu_check(got, [
        port.attention_backward_reference(q, k, v, o, do, "softmax", scale),
        port.attention_backward_tiled_reference(q, k, v, o, do, lse,
                                                "softmax", scale,
                                                entry=entry)])
    q32 = q.float()
    with pytest.raises(ValueError, match="nl_attn_bwd_wgmma takes"):
        port.fused_attention_backward(q32, q32, q32, q32, q32, lse,
                                      entry=WGMMA)
