"""The fused bottleneck's kernel designed for Hopper (the ``*_wgmma`` entries
of vidsitu_tpu_torch/csrc/fused_bottleneck.cu): its routing, its
shared-memory budget and the plain PyTorch version that repeats its walk
(``fused_bottleneck_tiled_reference``), on the CPU.

The same inputs, made from a numpy seed, go through the tiled plain version,
``fused_bottleneck_plain`` and the TPU probe
(benchmarks/probe_fused_bottleneck.py in Pallas interpret mode, loaded from
its file as tests/test_torch_fused_bottleneck.py loads it). Tolerances:
float32 atol 1e-5 against the plain version (the same sums in another
order) and 2e-4 against the probe (the JAX package's own for float32
kernels); bf16 one bf16 step of the output scale.

The CUDA kernels run only on a GPU: those cases are marked ``cuda`` and skip
elsewhere.
"""

import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsitu_tpu_torch.ops import fused_bottleneck as FB

REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "vidsitu_tpu_torch" / "csrc" / "fused_bottleneck.cu"

_spec = importlib.util.spec_from_file_location(
    "probe_fused_bottleneck_tiled",
    REPO / "benchmarks" / "probe_fused_bottleneck.py")
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)

# (H, W, Cin, Cmid, Cout, projection): the shapes the on-card check runs
FB_SHAPES = {
    "slow-s2 proj": (56, 56, 80, 64, 256, True),
    "slow-s2": (56, 56, 256, 64, 256, False),
    "slow-s3": (28, 28, 512, 128, 512, False),
    "ragged proj": (7, 9, 24, 16, 32, True),
}
# the same channel ratios at widths a CPU test can afford
SMALL = {
    "slow-s2": (32, 8, 32, False),
    "slow-s2 proj": (10, 8, 32, True),
    "slow-s3": (64, 16, 64, False),
}
FRAMES = {"12x12": (12, 12), "7x9": (7, 9), "5x58": (5, 58)}
F32_ATOL = 1e-5
PROBE_ATOL = 2e-4
WGMMA = ("fused_bottleneck_frames_wgmma", "fused_bottleneck_multi_wgmma")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _operands(seed, b, h, w, cin, cmid, cout, proj, shift_mean=0.0):
    """Seeded numpy operands in the probe's layouts: x, then wa, ba, wb, bb,
    wc, bc, wp, bp (weights of std fan_in**-0.5, shifts 0.1 around
    ``shift_mean``)."""
    rng = np.random.default_rng(seed)

    def weight(*shape):
        fan_in = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    def shift(n):
        return (shift_mean + 0.1 * rng.standard_normal((1, n))).astype(
            np.float32)

    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    ops = [weight(cin, cmid), shift(cmid), weight(3, 3, cmid, cmid),
           shift(cmid), weight(cmid, cout), shift(cout)]
    return x, ops + ([weight(cin, cout), shift(cout)] if proj
                     else [None, None])


def _torch(arrs, dtype):
    """Weights and x in ``dtype``, the shifts (shape (1, C)) in float32."""
    return [None if a is None else torch.from_numpy(a).to(
        torch.float32 if a.shape[0] == 1 and a.ndim == 2 else dtype)
        for a in arrs]


def _bf16_step(scale: float) -> float:
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


@pytest.mark.parametrize("fps", [1, 2, 4])
@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("widths", SMALL)
def test_tiled_reference_matches_plain_float32(widths, frame, fps):
    h, w = FRAMES[frame]
    x, ops = _operands(1, 5, h, w, *SMALL[widths])  # 5 frames: a short group
    x, *ops = _torch([x] + ops, torch.float32)
    want = FB.fused_bottleneck_plain(x, *ops)
    got = FB.fused_bottleneck_tiled_reference(x, *ops, frames_per_step=fps)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= F32_ATOL


@pytest.mark.parametrize("fps", [1, 2, 4])
@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("widths", SMALL)
def test_tiled_reference_matches_plain_bf16(widths, frame, fps):
    h, w = FRAMES[frame]
    x, ops = _operands(2, 5, h, w, *SMALL[widths])
    x, *ops = _torch([x] + ops, torch.bfloat16)
    want = FB.fused_bottleneck_plain(x, *ops).float()
    got = FB.fused_bottleneck_tiled_reference(x, *ops, frames_per_step=fps)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs().max().item()
    assert err <= _bf16_step(want.abs().max().item())


@pytest.mark.parametrize("fps", [1, 2, 4])
@pytest.mark.parametrize("widths", ["slow-s2", "slow-s2 proj"])
def test_tiled_reference_matches_tpu_probe(widths, fps):
    x, ops = _operands(3, 5, 7, 9, *SMALL[widths])
    want = probe.fused_bottleneck_frames(
        *(None if a is None else jnp.asarray(a) for a in [x] + ops),
        interpret=True)
    got = FB.fused_bottleneck_tiled_reference(
        *_torch([x] + ops, torch.float32), frames_per_step=fps)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= PROBE_ATOL


@pytest.mark.parametrize("fps", [1, 4])
def test_h1_outside_the_frame_is_zero_not_relu_of_the_shift(fps):
    """With positive shifts relu(ba) is far from zero: the walk equals the
    plain version only if h1 is zero at every pad position, and the variant
    that leaves relu(ba) there is visibly wrong."""
    x, ops = _operands(4, 3, 7, 9, 32, 8, 32, False, shift_mean=0.5)
    x, *ops = _torch([x] + ops, torch.float32)
    want = FB.fused_bottleneck_plain(x, *ops)
    got = FB.fused_bottleneck_tiled_reference(x, *ops, frames_per_step=fps)
    assert (got - want).abs().max().item() <= F32_ATOL
    wrong = FB.fused_bottleneck_tiled_reference(
        x, *ops, frames_per_step=fps, zero_outside=False)
    assert (wrong - want).abs().max().item() > 0.1
    # only the frame's border sees the pad positions
    assert (wrong - want)[:, 1:-1, 1:-1].abs().max().item() <= F32_ATOL


def test_tiled_reference_refuses_a_width_past_the_lag():
    x, ops = _operands(5, 1, 3, FB.WGMMA_MAX_W + 1, 8, 8, 8, False)
    with pytest.raises(ValueError, match="W <="):
        FB.fused_bottleneck_tiled_reference(*_torch([x] + ops, torch.float32))


@pytest.mark.parametrize("name", FB_SHAPES)
def test_kernel_entry_and_budget_of_the_checked_shapes(name):
    h, w, cin, cmid, cout, proj = FB_SHAPES[name]
    budget = FB.wgmma_budget(cin, cmid, cout, proj)
    assert budget["bytes"] == sum(
        budget[k] for k in ("wa", "wb", "wc", "wp", "h1_ring", "x_ring",
                            "shifts", "stage", "align"))
    frames = FB.kernel_entry(torch.bfloat16, cin, cmid, cout, proj, w)
    if name == "slow-s2":
        assert frames == "fused_bottleneck_frames_wgmma"
        assert FB.kernel_entry(torch.bfloat16, cin, cmid, cout, proj, w,
                               multi=True) == "fused_bottleneck_multi_wgmma"
        assert budget["resident"] == ("wa", "wb", "wc") and budget["fits"]
        assert budget["bytes"] == 231936 <= FB.WGMMA_SMEM_LIMIT == 232448
        assert (budget["wa"], budget["wb"], budget["wc"]) == (
            32768, 73728, 32768)
    else:
        # resident weights beside the rings would not fit a block: the
        # projection's (s2 block 0), Cmid 128 (s3); the ragged widths are
        # off the wgmma shapes
        assert frames == "fused_bottleneck_frames"
        assert FB.wgmma_refusal(torch.bfloat16, cin, cmid, cout, proj, w)
        if name != "ragged proj":
            assert not budget["fits"]
    # float32 always takes the first kernel
    assert FB.kernel_entry(torch.float32, cin, cmid, cout, proj, w) == (
        "fused_bottleneck_frames")
    if not proj:
        assert FB.kernel_entry(torch.float32, cin, cmid, cout, proj, w,
                               multi=True) == "fused_bottleneck_multi"


def test_kernel_entry_routes_on_width_and_refuses_other_types():
    assert FB.kernel_entry(torch.bfloat16, 128, 64, 128, False, 61) in WGMMA
    assert FB.kernel_entry(torch.bfloat16, 128, 64, 128, False, 62) == (
        "fused_bottleneck_frames")
    assert FB.kernel_entry(torch.bfloat16, 256, 64, 256, False) in WGMMA
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        FB.kernel_entry(torch.float16, 256, 64, 256, False)
    with pytest.raises(ValueError, match="no projection"):
        FB.kernel_entry(torch.bfloat16, 80, 64, 256, True, multi=True)


def _source_constants():
    return {name: int(value) for name, value in re.findall(
        r"^constexpr int (k\w+) = (\d+);", SOURCE.read_text(), flags=re.M)}


def test_budget_constants_match_the_cuda_source():
    consts = _source_constants()
    mirror = {
        "kSmemLimit": FB.WGMMA_SMEM_LIMIT,
        "kSmemAlign": FB.WGMMA_SMEM_ALIGN,
        "kGroups": FB.WGMMA_GROUPS,
        "kCmid": FB.WGMMA_CMID,
        "kTileM": FB.WGMMA_TILE_M,
        "kLag": FB.WGMMA_LAG,
        "kRing": FB.WGMMA_RING,
        "kChunkK": FB.WGMMA_CHUNK_K,
        "kXStages": FB.WGMMA_X_STAGES,
        "kNC": FB.WGMMA_NC,
        "kStageCols": FB.WGMMA_STAGE_COLS,
    }
    assert {name: consts.get(name) for name in mirror} == mirror
    text = SOURCE.read_text()
    # the derived constants and the struct's formula, as the module repeats them
    for line in ("constexpr int kStepM = kGroups * kTileM;",
                 "constexpr int kMaxW = kLag - 3;",
                 "kBytes = kSmemAlign + kOffStage + kStageBytes;",
                 "static_assert(kBytes <= kSmemLimit"):
        assert line in text, line
    assert FB.WGMMA_STEP_M == 128 and FB.WGMMA_MAX_W == 61
    # the widths the source instantiates are the widths the router sends
    assert tuple(int(c) for c in re.findall(
        r"case (\d+): return launch<\1>", text)) == FB.WGMMA_WIDTHS
    # the ring holds a step, the lag and a tap's reach at the widest frame
    assert (FB.WGMMA_STEP_M + FB.WGMMA_LAG + FB.WGMMA_MAX_W + 3
            <= FB.WGMMA_RING)


def test_source_holds_both_kernels_and_four_entries():
    text = SOURCE.read_text()
    for entry in (name for pair in FB.ENTRIES.values() for name in pair):
        assert re.search(rf'extern "C" int {entry}\(', text), entry
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in text
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in text
    assert "ldmatrix.sync.aligned.m8n8.x4.shared.b16" in text
    assert "cp.async.cg.shared.global" in text
    assert "cudaDevAttrMultiProcessorCount" in text  # no literal SM count
    assert "benchmarks/micro4.py:84" in text
    assert "benchmarks/probe_fused_bottleneck.py:108" in text
    for library in ("cutlass", "cublas", "cudnn", "torch/"):
        assert library not in text.lower()


def test_wrappers_refuse_a_cpu_tensor_and_an_entry_of_the_other_wrapper():
    FB.reset_launches()
    x, ops = _operands(6, 2, 7, 9, 256, 64, 256, False)
    x, *ops = _torch([x] + ops, torch.bfloat16)
    for entry in (None,) + FB.ENTRIES["fused_bottleneck_frames"]:
        with pytest.raises(ValueError, match="not CUDA"):
            FB.fused_bottleneck_frames(x, *ops, entry=entry)
    with pytest.raises(ValueError, match="not CUDA"):
        FB.fused_bottleneck_multi(x, *ops[:6], frames_per_step=2,
                                  entry="fused_bottleneck_multi_wgmma")
    # the CPU branch of the dispatcher is the plain version
    got = FB.fused_bottleneck(x, *ops, frames_per_step=2)
    assert torch.equal(got, FB.fused_bottleneck_plain(x, *ops))
    assert not any(FB.LAUNCHES.values())
    assert FB.LAUNCHES_BY_ENTRY == {
        name: 0 for pair in FB.ENTRIES.values() for name in pair}


@pytest.mark.parametrize("name,reason", [
    ("slow-s2 proj", "projection"), ("slow-s3", "Cmid 128"),
    ("ragged proj", "projection")])
def test_forcing_the_wgmma_entry_raises_on_what_it_does_not_take(
        name, reason, monkeypatch):
    """The refusal comes before any launch; the device check is lifted so
    that the CPU can reach it."""
    h, w, cin, cmid, cout, proj = FB_SHAPES[name]
    x, ops = _operands(7, 1, 3, 5, cin, cmid, cout, proj)
    x, *ops = _torch([x] + ops, torch.bfloat16)
    dims = (cin, -(-cin // 16) * 16, cmid, cout)
    monkeypatch.setattr(FB, "_prepare", lambda *a: ({}, dims, 1))
    with pytest.raises(ValueError, match=reason):
        FB.fused_bottleneck_frames(
            x, *ops, entry="fused_bottleneck_frames_wgmma")
    with pytest.raises(ValueError, match="entry must be one of"):
        FB.fused_bottleneck_frames(x, *ops, entry="fused_bottleneck_multi")
    with pytest.raises(ValueError, match="W 62"):
        FB._pick_entry("fused_bottleneck_multi",
                       "fused_bottleneck_multi_wgmma",
                       torch.zeros((1, 3, 62, 256), dtype=torch.bfloat16),
                       (256, 256, 64, 256), False)


def test_reset_launches_zeroes_both_counts():
    FB.LAUNCHES["fused_bottleneck_multi"] = 2
    FB.LAUNCHES_BY_ENTRY["fused_bottleneck_multi_wgmma"] = 2
    FB.reset_launches()
    assert not any(FB.LAUNCHES.values())
    assert not any(FB.LAUNCHES_BY_ENTRY.values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [1, 5])
@pytest.mark.parametrize("name", FB_SHAPES)
def test_every_entry_matches_both_plain_versions_on_gpu(
        cuda_device, name, frames):
    """Every entry that takes the shape, routed and forced, against the plain
    version (5e-2 of the output scale in bf16, as the on-card smoke run) and,
    for the wgmma entries, the plain version that repeats their walk."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w, cin, cmid, cout, proj = FB_SHAPES[name]
    x, ops = _operands(8, frames, h, w, cin, cmid, cout, proj)
    x, *ops = (None if t is None else t.to(cuda_device)
               for t in _torch([x] + ops, torch.bfloat16))
    want = FB.fused_bottleneck_plain(x, *ops).float()
    limit = 5e-2 * want.abs().max().item()
    routed = FB.kernel_entry(torch.bfloat16, cin, cmid, cout, proj, w)
    FB.reset_launches()
    runs = []
    for entry in dict.fromkeys((routed, "fused_bottleneck_frames")):
        runs.append((entry, 1, FB.fused_bottleneck_frames(
            x, *ops, entry=entry)))
    if not proj:
        for entry in dict.fromkeys((
                FB.kernel_entry(torch.bfloat16, cin, cmid, cout, proj, w,
                                multi=True), "fused_bottleneck_multi")):
            for fps in (1, 2, 4):
                runs.append((entry, fps, FB.fused_bottleneck_multi(
                    x, *ops[:6], frames_per_step=fps, entry=entry)))
    torch.cuda.synchronize()
    for entry, fps, got in runs:
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert (got.float() - want).abs().max().item() <= limit, (entry, fps)
        if entry in WGMMA:
            tiled = FB.fused_bottleneck_tiled_reference(
                x, *ops, frames_per_step=fps).float()
            assert (got.float() - tiled).abs().max().item() <= limit, (
                entry, fps)
    assert sum(FB.LAUNCHES_BY_ENTRY.values()) == len(runs)
    assert (FB.LAUNCHES_BY_ENTRY["fused_bottleneck_frames_wgmma"] > 0) == (
        name == "slow-s2")


@pytest.mark.cuda
@pytest.mark.parametrize("fps", [1, 2, 3, 7])
def test_wgmma_walk_across_group_boundaries_on_gpu(cuda_device, fps):
    """More work than blocks, so that every block's run crosses from one
    group of frames into the next (groups of 2, 3 and 7 frames have an odd
    number of steps: the h1 ring's halves must alternate by the run's steps,
    not by the step's number in its group) and most runs start inside a
    group. Against the first kernel's entry, which shares no code with it."""
    x, ops = _operands(9, 67, 56, 56, 256, 64, 256, False)
    x, *ops = (None if t is None else t.to(cuda_device)
               for t in _torch([x] + ops, torch.bfloat16))
    want = FB.fused_bottleneck_frames(
        x, *ops, entry="fused_bottleneck_frames").float()
    limit = 5e-2 * want.abs().max().item()
    for _ in range(3):  # a race shows in some launches only
        got = FB.fused_bottleneck_multi(
            x, *ops[:6], frames_per_step=fps,
            entry="fused_bottleneck_multi_wgmma")
        torch.cuda.synchronize()
        assert (got.float() - want).abs().max().item() <= limit


@pytest.mark.cuda
def test_wgmma_budget_equals_the_built_kernel(cuda_device):
    from vidsitu_tpu_torch.ops import _build

    lib = _build.load_fused_bottleneck()
    for c in FB.WGMMA_WIDTHS:
        assert lib.fused_bottleneck_wgmma_smem_bytes(c) == FB.wgmma_budget(
            c, FB.WGMMA_CMID, c, False)["bytes"]
    assert lib.fused_bottleneck_wgmma_smem_bytes(512) == 0
