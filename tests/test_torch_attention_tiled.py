"""The wgmma attention kernel's arithmetic and routing, without a GPU.

``attention_tiled_reference`` repeats the kernel's steps in plain PyTorch
(key tiles with masked tails, running max and sum, exp2 with the folded
scale, P rounded to the input type before P V, one division at the end).
Here it is held against the JAX package's ``_einsum_attention`` and its
Pallas kernel in interpret mode, on numpy-seeded inputs, with the JAX
package's tolerances (atol 2e-4 float32, 5e-2 bfloat16). The routing
(``kernel_entry``), the launch counts and the shared-memory budget that the
CUDA source asserts are checked as plain Python.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsitu_tpu.ops.attention import _einsum_attention, fused_attention
from vidsitu_tpu_torch.ops import _build
from vidsitu_tpu_torch.ops import attention as port

torch.set_num_threads(1)

ATOL = {"float32": 2e-4, "bfloat16": 5e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BLOCK_KS = [8, 40, 56, 64]
KEY_COUNTS = [1, 7, 57, 196]  # below, beside and across the tile sizes
SOURCE = Path(port.__file__).resolve().parent.parent / "csrc" / "nonlocal_attn.cu"


def _inputs(seed, b, sq, sk, d, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, d)).astype(np.float32)
               for s in (sq, sk, sk))
    return [q * np.float32(q_scale), k, v]


def _tiled(arrs, dtype, kind, scale, block_k):
    q, k, v = (torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs)
    out = port.attention_tiled_reference(q, k, v, kind, scale, block_k)
    assert out.dtype == TORCH_DT[dtype]
    return out.float().numpy()


@pytest.mark.parametrize("sk", KEY_COUNTS)
@pytest.mark.parametrize("block_k", BLOCK_KS)
@pytest.mark.parametrize("kind", ["softmax", "dot_product"])
def test_tiled_matches_einsum(kind, block_k, sk):
    b, sq, d = 2, 70, 32
    arrs = _inputs(10, b, sq, sk, d)
    q, k, v = (jnp.asarray(a) for a in arrs)
    ref = np.asarray(_einsum_attention(q, k, v, kind, d ** -0.5), np.float32)
    out = _tiled(arrs, "float32", kind, d ** -0.5, block_k)
    assert out.shape == ref.shape == (b, sq, d)
    np.testing.assert_allclose(out, ref, atol=ATOL["float32"], rtol=0)


@pytest.mark.parametrize("kind", ["softmax", "dot_product"])
def test_tiled_matches_pallas_interpret(kind):
    """Against the Pallas kernel as the JAX tests run it on a CPU, at the
    shape tests/test_torch_attention.py uses (Sk a multiple of 128), with
    the wgmma kernel's own tile of 80 keys."""
    b, s, d = 2, 640, 128
    arrs = _inputs(11, b, s, s, d)
    q, k, v = (jnp.asarray(a) for a in arrs)
    ref = np.asarray(fused_attention(q, k, v, kind=kind, scale=d ** -0.5,
                                     q_block=128, interpret=True))
    out = _tiled(arrs, "float32", kind, d ** -0.5, port.wgmma_block_k(d))
    np.testing.assert_allclose(out, ref, atol=ATOL["float32"], rtol=0)


@pytest.mark.parametrize("sk", KEY_COUNTS)
@pytest.mark.parametrize("block_k", BLOCK_KS)
@pytest.mark.parametrize("kind", ["softmax", "dot_product"])
def test_tiled_bf16_matches_reference(kind, block_k, sk):
    """bf16 in and out, P rounded to bf16 before P V, against the plain
    float32 version on the same bf16 inputs. dot_product over few keys
    grows with |q|, so its q is scaled down to keep one bf16 step of the
    output under the tolerance."""
    b, sq, d = 2, 70, 32
    arrs = _inputs(12, b, sq, sk, d,
                   q_scale=0.1 if kind == "dot_product" else 1.0)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    ref = port.attention_reference(q, k, v, kind, d ** -0.5).float().numpy()
    out = _tiled(arrs, "bfloat16", kind, d ** -0.5, block_k)
    np.testing.assert_allclose(out, ref, atol=ATOL["bfloat16"], rtol=0)


def test_tiled_rescales_after_a_very_negative_first_tile():
    """Tile 0 holds only logits near -1e4 and tile 1 one of +30: the running
    max jumps, the first tile's weight goes to zero, nothing is NaN."""
    d, sk, block_k = 16, 20, 8
    q = np.zeros((1, 3, d), np.float32)
    q[:, :, 0] = 1.0
    k = np.zeros((1, sk, d), np.float32)
    k[0, :block_k, 0] = -1e4
    k[0, 11, 0] = 30.0
    v = np.random.default_rng(13).standard_normal((1, sk, d)).astype(np.float32)
    out = _tiled([q, k, v], "float32", "softmax", 1.0, block_k)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = port.attention_reference(tq, tk, tv, "softmax", 1.0).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=ATOL["float32"], rtol=0)
    np.testing.assert_allclose(out[0, 0], v[0, 11], atol=1e-5, rtol=0)


@pytest.mark.parametrize("block_k", BLOCK_KS)
def test_tiled_uniform_softmax_is_the_mean_of_v(block_k):
    """Equal logits everywhere: every key weighs 1 / Sk, the masked tail of
    the last tile nothing."""
    sk, d = 57, 16
    v = np.random.default_rng(14).standard_normal((2, sk, d)).astype(np.float32)
    q = np.zeros((2, 5, d), np.float32)
    k = np.ones((2, sk, d), np.float32)
    out = _tiled([q, k, v], "float32", "softmax", d ** -0.5, block_k)
    assert np.isfinite(out).all()
    want = np.broadcast_to(v.mean(axis=1, keepdims=True), out.shape)
    np.testing.assert_allclose(out, want, atol=1e-6, rtol=0)


def test_tiled_rejects_bad_kind():
    q = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="kind"):
        port.attention_tiled_reference(q, q, q, "linear", 1.0, 8)


@pytest.mark.parametrize("d", [64, 128, 256, 512])
def test_kernel_entry_bf16_wgmma_widths(d):
    assert port.kernel_entry(torch.bfloat16, d) == "nl_attn_fwd_wgmma"
    assert port.kernel_entry(torch.float32, d) == "nl_attn_fwd"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 24, 200])
def test_kernel_entry_other_widths_keep_the_wmma_kernel(d, dtype):
    assert port.kernel_entry(TORCH_DT[dtype], d) == "nl_attn_fwd"


@pytest.mark.parametrize("dtype,d,exc", [
    (torch.bfloat16, 4, ValueError), (torch.bfloat16, 520, ValueError),
    (torch.float32, 36, ValueError), (torch.float16, 64, TypeError),
    (torch.float64, 64, TypeError)])
def test_kernel_entry_raises_on_what_no_kernel_takes(dtype, d, exc):
    with pytest.raises(exc):
        port.kernel_entry(dtype, d)


def test_kernel_entry_names_are_the_entries():
    assert set(port.ENTRIES) == {"nl_attn_fwd_wgmma", "nl_attn_fwd"}
    assert port.BWD_ENTRY == "nl_attn_bwd"
    assert set(port.LAUNCHES_BY_ENTRY) == set(port.ENTRIES) | {port.BWD_ENTRY}


@pytest.mark.parametrize("entry", [None, *port.ENTRIES])
def test_forced_entry_on_cpu_raises_before_any_build(entry, monkeypatch):
    def no_build():
        raise AssertionError("the library must not be built for a CPU tensor")

    monkeypatch.setattr(_build, "load_nonlocal_attn", no_build)
    q = torch.zeros(1, 8, 64, dtype=torch.bfloat16)
    before = (port.LAUNCHES, dict(port.LAUNCHES_BY_ENTRY))
    with pytest.raises(ValueError, match="not CUDA"):
        port.fused_attention(q, q, q, "softmax", entry=entry)
    assert (port.LAUNCHES, dict(port.LAUNCHES_BY_ENTRY)) == before


def test_unknown_entry_is_rejected():
    q = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError, match="entry"):
        port.fused_attention(q, q, q, "softmax", entry="nl_attn_fwd_tma")


def test_cpu_dispatch_counts_no_launch_by_entry():
    port.reset_launches()
    arrs = _inputs(15, 2, 50, 30, 64)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    port.nonlocal_attention(q, k, v, "softmax", 0.125)
    assert port.LAUNCHES == 0
    assert not any(port.LAUNCHES_BY_ENTRY.values())


def test_reset_launches_zeroes_both_counts():
    port.LAUNCHES = 3
    port.LAUNCHES_BY_ENTRY["nl_attn_fwd"] = 3
    port.reset_launches()
    assert port.LAUNCHES == 0 and not any(port.LAUNCHES_BY_ENTRY.values())


def _source_constants():
    text = SOURCE.read_text()
    return {name: int(value) for name, value in re.findall(
        r"^constexpr int (k\w+) = (\d+);", text, flags=re.M)}


def test_smem_constants_match_the_cuda_source():
    consts = _source_constants()
    mirror = {
        "kSmemLimit": port.WGMMA_SMEM_LIMIT,
        "kSmemAlign": port.WGMMA_SMEM_ALIGN,
        "kStages": port.WGMMA_STAGES,
        "kBlockK": port.WGMMA_BLOCK_K,
        "kBlockKSplit": port.WGMMA_BLOCK_K_SPLIT,
        "kSplitAbove": port.WGMMA_SPLIT_ABOVE,
        "kRowsPerGroup": port.WGMMA_ROWS_PER_GROUP,
        "kGroups": port.WGMMA_GROUPS,
    }
    assert {name: consts.get(name) for name in mirror} == mirror
    # the struct's formula, as wgmma_smem_bytes repeats it
    text = SOURCE.read_text()
    assert ("kBytes = kSmemAlign + kQBytes + kStages * kStageBytes" in text
            and "static_assert(kBytes <= kSmemLimit" in text)


@pytest.mark.parametrize("d,want", [(64, 58368), (128, 115712),
                                    (256, 230400), (512, 197632)])
def test_smem_budget_of_the_routed_widths(d, want):
    block_k = port.wgmma_block_k(d)
    assert block_k % 16 == 0  # the P V product's depth
    got = port.wgmma_smem_bytes(d, block_k, port.WGMMA_STAGES)
    assert got == want <= port.WGMMA_SMEM_LIMIT == 232448
    # one more ring slot would not fit at the backbone's stage-3 width
    if d == 256:
        assert port.wgmma_smem_bytes(d, block_k, 3) > port.WGMMA_SMEM_LIMIT


def test_tiles_fit_the_backbone_key_counts():
    """784 keys at d=256 and 196 at d=512: the last tile wastes little."""
    for sk, d, tiles in ((784, 256, 10), (196, 512, 7)):
        block_k = port.wgmma_block_k(d)
        assert -(-sk // block_k) == tiles
        assert tiles * block_k - sk < block_k


def test_source_is_a_hand_written_wgmma_kernel():
    text = SOURCE.read_text()
    for needle in ("wgmma.mma_async.sync.aligned", "wgmma.fence.sync.aligned",
                   "wgmma.commit_group", "wgmma.wait_group",
                   "cp.async.cg.shared.global", "fence.proxy.async",
                   'extern "C" int nl_attn_fwd(',
                   'extern "C" int nl_attn_fwd_wgmma('):
        assert needle in text, needle
    for banned in ("#include <torch", "#include <cutlass", "#include <cublas",
                   "#include <cudnn"):
        assert banned not in text, banned


def test_loader_binds_both_entries():
    """``load_nonlocal_attn`` sets argtypes for both C entries (read from
    its source: the library itself builds only where nvcc is)."""
    import inspect

    body = inspect.getsource(_build.load_nonlocal_attn.__wrapped__)
    assert "nl_attn_fwd.argtypes" in body
    assert "nl_attn_fwd_wgmma.argtypes" in body
