#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vidsitu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases, each of which must pass (any failure raises and exits non-zero):

1. build: the non-local attention kernels (one source, two entries: the
   wgmma kernel and the wmma / float32 one) from vidsitu_tpu_torch/csrc/;
2. kernel vs plain: both entries against the plain PyTorch version at the
   I3D-NL 224 px shapes (B=8: stage 3 3136x784x256, stage 4 784x196x512),
   a ragged one (200x200x128) and two whose Sq and Sk are no multiples of
   the wgmma kernel's tiles (B=8 130x57x256, B=3 65x196x512), both kinds,
   with the JAX package's tolerances (atol 2e-4 float32, which only the
   wmma entry takes; 5e-2 bf16, or one bf16 step of the largest output
   where that is more); the wgmma entry also against the plain version
   that repeats its tiled arithmetic; then the wgmma entry, the wmma entry,
   the plain version and the library's fused attention timed in turns in
   bf16 at the main path's batch (32 clips);
3. main path: ``extract_features`` of I3D-NL R50 (full width and depth,
   224 px, 8 frames, bf16, seeded weights with non-zero BatchNorm gammas)
   over a synthetic valid split of 8 segments = 40 clips at clip_batch 32:
   2 dispatches (the second zero-padded), 8 files of (5, 2048), finite, and
   exactly 5 non-local blocks x 2 dispatches kernel launches, all on the
   entry that ``kernel_entry`` names for bf16 at d = 256 and 512;
4. kernel path == plain path: one batch of those clips through the model
   once with the routed kernel and once with the plain attention, features
   within 2e-2 of the feature scale (bf16); the forward timed in turns with
   the routed kernel, with the wmma entry forced, and with the plain
   attention;
5. the default configuration (SlowFast R50 8x8) forward on 8 clips;
6. build: the beam-cache row-gather kernel (built with phase 1's, both
   nvcc processes started together);
7. kernel vs plain: the row gather against ``index_select`` on the SRL
   decode's cache at beam 5 (400 rows; per layer 2 self leaves of
   8 x L x 128 for L = 65, 129, 201 and 2 cross leaves of 8 x 1 x 128;
   3 layers = 12 leaves per launch), bf16 and float32, bit-identical; then
   the 12-leaf reorder at each L timed against the plain version, in
   turns, with calls queued back to back (device time) and one call at a
   time (host time of the wrapper included);
8. SRL main path: ``python -m vidsitu_tpu_torch.main`` in process,
   ``sfpret_txe_txd_vbarg`` at full width (3+3 layers, d 1024, 8 heads),
   bf16, seeded weights, beam 5 without ancestry, on the features phase 3
   wrote (8 real segments padded to the eval batch of 16 = 400 beam rows):
   one pkl entry per segment with 5 events whose text starts with the
   forced verb, finite metrics, and exactly one kernel launch per decode
   step;
9. routes agree on that batch: the reorder route with the kernel and with
   the plain gather (identical tokens and scores, timed in turns), the
   ancestry route against the reorder route in float32 (tokens equal on
   >= 95 % of events, see ROUTE_AGREEMENT), greedy once; each route's
   time per batch; then a ``torch.profiler`` trace of one more decode of
   the main path's batch (phase 8's profile);
10. the generator alone at the real vocabulary size (GPT-2's 50,257 tokens
   plus the 23 role/separator tokens and pad), beam 5, both routes, timed;
11. build: the fused inference bottleneck and the copy probes (built with
   phase 1's and phase 6's, four nvcc processes started together);
12. kernel vs plain: the fused bottleneck's two entry points (one block per
   tile and frame; several frames per block with resident weights) against
   the plain version in float32 (atol 2e-4) and bf16 (5e-2 of the output
   scale) at slow-s2 with projection (56x56, 80->64->256), slow-s2 without
   (256/64/256), slow-s3 (28x28, 512/128/512) and a ragged one (7x9,
   24->16->32, with projection), seeded non-zero shifts; then timed in turns
   against the unfused chain (``Bottleneck.forward``, bf16, channels-last)
   at 256 and 960 frames, and the plain version timed at 256;
13. this slice's model path at full width: one forward of the seeded
   SlowFast R50 8x8 (phase 5's model) on 8 clips in bf16 with hooks on the
   six eligible slow-pathway blocks (s2 blocks 0-2, s3 blocks 1-3);
   ``run_fused_block`` on each captured input equals the captured output
   within 2e-2 of its scale; six kernel launches;
14. the copy probes bit-identical to their input on a 768 MB bf16 tensor,
   at every block shape, the TPU probe's VMEM-sized blocks refused; GB/s of
   each beside ``clone()`` and one elementwise op;
15. ``vidsitu_tpu_torch.bench`` in process: ``gates`` (FLIP / no-flip lines),
   ``featext 32`` and ``decode5_real``, one JSON line each.

Phases 1-10 run as before, at the same depth and repeats.

Prints the GPU's name and power limit first, a JSON line of kernel results
before the last line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import functools
import json
import math
import pickle
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
S3, S4, RAGGED = (3136, 784, 256), (784, 196, 512), (200, 200, 128)
# (name, B, (Sq, Sk, d)) of phase 2's checks; the last two are ragged against
# the wgmma kernel's 128 / 64 query rows and 80 / 32 keys per tile
ATTN_CHECKS = (("s3", 8, S3), ("s4", 8, S4), ("ragged", 8, RAGGED),
               ("ragged-d256", 8, (130, 57, 256)),
               ("ragged-d512", 3, (65, 196, 512)))
ATOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
V1_ENTRY = "nl_attn_fwd"  # the wmma / float32 entry
FEATURE_RTOL = 2e-2  # kernel vs plain path, relative to max |feature|
# built together: phases 1, 6 and 11 (twice)
KERNELS = ("nonlocal_attn", "beam_gather", "fused_bottleneck", "copy_probe")
BUILD_PHASE = dict(zip(KERNELS, (1, 6, 11, 11)))
# published peaks of one H100 SXM (NVIDIA's data sheet, 700 W), for bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "float32": 67e12}
# fused bottleneck shapes: (H, W, Cin, Cmid, Cout, projection)
FB_SHAPES = {
    "slow-s2 proj": (56, 56, 80, 64, 256, True),
    "slow-s2": (56, 56, 256, 64, 256, False),
    "slow-s3": (28, 28, 512, 128, 512, False),
    "ragged proj": (7, 9, 24, 16, 32, True),
}
FB_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}  # bf16: of the scale
FUSED_BLOCKS = ("s2_slow.block_0", "s2_slow.block_1", "s2_slow.block_2",
                "s3_slow.block_1", "s3_slow.block_2", "s3_slow.block_3")
# SRL decode at beam 5: 16 segments x 5 events x 5 beams, 3 decoder layers
BEAM, EVENTS, HEADS, HEAD_DIM, LAYERS = 5, 80, 8, 128, 3
SELF_LENS = (65, 129, 201)  # the segmented cache: 64, 128, then 200 + 1
REAL_VOCAB = 50257 + 1 + 2 * 11 + 1  # GPT-2 + <EV_SEP> + <ArgX>/</ArgX> + pad
# ancestry vs reorder in float32, share of events with equal top-beam tokens.
# The routes sum in other orders (cuBLAS takes a gemv for the reorder
# route's one query per row, a gemm for ancestry's five), and with seeded
# weights the 427-way output distributions are flat, so a near-tie among
# the 10 candidates flips now and then: 396 of 400 events agreed over 5
# batches on the H100. A broken route disagrees on most events.
ROUTE_AGREEMENT = 0.95
QUEUED = 10  # calls queued between two CUDA events: device time per call


def log(*a):
    print(*a, flush=True)


def bound(n_bytes: float, n_ops: float, kind: str = "bf16"):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of bytes over its memory rate and operations over its peak rate."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def attn_limit(dtype, ref):
    """The attention check's tolerance: ATOL, and for bf16 no less than one
    bf16 step at the largest output. A dot_product over few keys gives
    outputs beyond 6.4, where one rounding step of the bf16 output itself
    (2**-4 from 8 on) exceeds 5e-2, for any kernel and the plain version."""
    if dtype != torch.bfloat16:
        return ATOL[dtype]
    top = ref.abs().max().item()
    return max(ATOL[dtype], 2.0 ** (math.floor(math.log2(top)) - 7))


def seeded_qkv(rng, b, sq, sk, d, dtype, dev):
    return [torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))
            .to(dev, dtype) for s in (sq, sk, sk)]


def phase_build():
    """Phases 1, 6 and 11: every kernel from the checkout's source, one nvcc
    per source, all started together."""
    from vidsitu_tpu_torch.ops import _build

    def timed(name):
        t0 = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - t0

    for name in KERNELS:
        _build.library_path(name).unlink(missing_ok=True)
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        secs = dict(zip(KERNELS, pool.map(timed, KERNELS)))
    _build.load_nonlocal_attn()
    _build.load_beam_gather()
    _build.load_fused_bottleneck()
    _build.load_copy_probe()
    for name, phase in BUILD_PHASE.items():
        log(f"[{phase} build] {name}.cu -> {_build.library_path(name).name} "
            f"in {secs[name]:.2f} s")
        for line in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "Used" in line or "spill" in line:
                log("    ptxas:", line.strip())


def phase_kernel(dev):
    """Phase 2: every entry that takes the input against the plain version,
    then the four ways to compute the attention timed in turns."""
    from vidsitu_tpu_torch.ops import attention as A

    rng = np.random.default_rng(0)
    worst = {name: 0.0 for name in A.ENTRIES}  # bf16, by entry
    for name, b, (sq, sk, d) in ATTN_CHECKS:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = seeded_qkv(rng, b, sq, sk, d, dtype, dev)
            # the routed entry, and the wmma entry where it is another
            entries = dict.fromkeys((A.kernel_entry(dtype, d), V1_ENTRY))
            for kind in ("softmax", "dot_product"):
                ref = A.attention_reference(q, k, v, kind, d ** -0.5)
                limit = attn_limit(dtype, ref)
                for entry in entries:
                    out = A.fused_attention(q, k, v, kind, d ** -0.5,
                                            entry=entry)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    ok = out.shape == ref.shape and out.dtype == dtype and (
                        err <= limit)
                    tiled = ""
                    if entry != V1_ENTRY:
                        til = A.attention_tiled_reference(
                            q, k, v, kind, d ** -0.5, A.wgmma_block_k(d))
                        err_t = (out.float() - til.float()).abs().max().item()
                        tiled = f" vs tiled plain {err_t:.3e}"
                        ok = ok and err_t <= limit
                    log(f"[2 kernel] {entry} {name} B={b} Sq={sq} Sk={sk} "
                        f"d={d} {str(dtype)[6:]} {kind}: max_abs_err="
                        f"{err:.3e} (limit {limit:g}){tiled} "
                        f"{'ok' if ok else 'FAIL'}")
                    assert ok, "kernel disagrees with the plain version"
                    if dtype == torch.bfloat16:
                        worst[entry] = max(worst[entry], err)
    times = {}
    for name, (sq, sk, d) in (("s3", S3), ("s4", S4)):
        q, k, v = seeded_qkv(rng, 32, sq, sk, d, torch.bfloat16, dev)
        routed = A.kernel_entry(torch.bfloat16, d)
        ref = A.attention_reference(q, k, v, "softmax", d ** -0.5)
        for entry in dict.fromkeys((routed, V1_ENTRY)):
            out = A.fused_attention(q, k, v, "softmax", d ** -0.5, entry=entry)
            err = (out.float() - ref.float()).abs().max().item()
            assert err <= ATOL[torch.bfloat16], f"{entry} {name} B=32: {err}"
            worst[entry] = max(worst[entry], err)
        # the library's fused attention, timed as a yardstick only
        q4, k4, v4 = (t.unsqueeze(1) for t in (q, k, v))
        ms, v1_ms, plain_ms, lib_ms = medians_in_turns([
            lambda: A.fused_attention(q, k, v, "softmax", d ** -0.5),
            lambda: A.fused_attention(q, k, v, "softmax", d ** -0.5,
                                      entry=V1_ENTRY),
            lambda: A.attention_reference(q, k, v, "softmax", d ** -0.5),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, scale=d ** -0.5)], 20)
        # where the routed kernel's time goes: the same products without the
        # softmax (dot_product), and 5 clips, whose blocks fit the card's SMs
        # at once (the time of one block)
        dot_ms, wave_ms = (float(np.median(cuda_ms(fn, 20))) for fn in (
            lambda: A.fused_attention(q, k, v, "dot_product", d ** -0.5),
            lambda: A.fused_attention(q[:5], k[:5], v[:5], "softmax",
                                      d ** -0.5)))
        flops = 4 * 32 * sq * sk * d
        moved = sum(t.numel() * t.element_size() for t in (q, k, v, out))
        bound_ms, bound_by = bound(moved, flops)
        times[name] = {"entry": routed, "ms": ms, "v1_ms": v1_ms,
                       "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "dot_product_ms": dot_ms, "five_clips_ms": wave_ms}
        log(f"[2 kernel] time {name} B=32 bf16 softmax: {routed} {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), {V1_ENTRY} {v1_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, scaled_dot_product_attention "
            f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}; {routed} "
            f"dot_product {dot_ms:.4f} ms, softmax on 5 clips {wave_ms:.4f} ms")
    return worst, times


def smoke_cfg(paths, root, preset):
    from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

    return get_cfg_with_overrides("chip_smoke", **{
        **paths,
        "mdl.sf_mdl_name": preset,
        "train.dtype": "bfloat16",
        "misc.tmp_path": str(root / "tmp"),
    })


def seeded_state_dict(cfg):
    from vidsitu_tpu_torch.convert.from_flax import (
        flax_to_state_dict,
        seeded_variables,
    )
    from vidsitu_tpu_torch.models.vb_models import build_feat_extractor

    return flax_to_state_dict(seeded_variables(build_feat_extractor(cfg), 0))


def phase_main_path(cfg, state_dict, out_dir):
    from vidsitu_tpu_torch.data.comm import build_comm
    from vidsitu_tpu_torch.extract import extract_features
    from vidsitu_tpu_torch.ops import attention as A

    comm = build_comm(cfg)
    timings = []
    A.reset_launches()
    t0 = time.perf_counter()
    counts = extract_features(
        cfg, comm, state_dict=state_dict, splits=["valid"], out_dir=out_dir,
        batch_size=4, num_threads=8, clip_batch=32, device="cuda",
        timings=timings)
    wall = time.perf_counter() - t0
    launches, by_entry = A.LAUNCHES, dict(A.LAUNCHES_BY_ENTRY)
    files = sorted(Path(out_dir).glob("*_feats.npy"))
    arrs = [np.load(f) for f in files]
    log(f"[3 main] counts={counts} files={len(files)} dispatches="
        f"{len(timings)} nl_launches={launches} by entry {by_entry} "
        f"wall={wall:.2f} s")
    assert counts == {"valid": 8} and len(files) == 8, counts
    assert len(timings) == 2, f"expected 2 dispatches, got {len(timings)}"
    assert all(a.shape == (5, 2048) and a.dtype == np.float32
               and np.isfinite(a).all() for a in arrs), "bad feature files"
    assert launches == 5 * 2, f"NL kernel launches {launches} != 5 x 2"
    routed = {A.kernel_entry(torch.bfloat16, d) for d in (256, 512)}
    assert len(routed) == 1 and by_entry[routed.pop()] == launches, (
        f"launches off the routed entry: {by_entry}")
    # excluding the first dispatch: from its fetch to the second's fetch
    # (the second batch was queued before the first fetch, so the interval
    # is shorter than a whole forward)
    dt = timings[1] - timings[0]
    log(f"[3 main] after the first dispatch: {dt * 1e3:.1f} ms to the "
        f"second fetch (32 clips on the device, 8 real) -> {32 / dt:.1f} "
        f"device clips/s, {8 / dt:.1f} real clips/s")
    return launches, by_entry


def phase_paths_agree(cfg, state_dict, dev):
    from vidsitu_tpu_torch.data.comm import build_comm
    from vidsitu_tpu_torch.data.loader import fold_frame_events, stack_collate
    from vidsitu_tpu_torch.extract import FramesOnlyDS
    from vidsitu_tpu_torch.models.vb_models import build_feat_extractor
    from vidsitu_tpu_torch.models.video_backbone import NonLocalBlock
    from vidsitu_tpu_torch.ops import attention as A

    ds = FramesOnlyDS(cfg, build_comm(cfg), "valid")
    batch = fold_frame_events(stack_collate([ds[i] for i in range(7)]))
    frames = torch.from_numpy(batch["frms_ev_fast_tensor"][:32]).to(dev)
    model = build_feat_extractor(cfg)
    model.load_state_dict(state_dict, strict=True)
    model.to(device=dev, memory_format=torch.channels_last_3d)
    nl = [m for m in model.modules() if isinstance(m, NonLocalBlock)]
    assert len(nl) == 5, len(nl)

    def run(attn):
        for m in nl:
            m.attention = attn
        with torch.inference_mode():
            return model.clip_features({"frms_ev_fast_tensor": frames})

    feats_k = run(A.fused_attention).float()
    feats_p = run(A.attention_reference).float()
    torch.cuda.synchronize()
    scale = feats_p.abs().max().item()
    diff = (feats_k - feats_p).abs().max().item()
    ok = bool(torch.isfinite(feats_k).all()) and diff <= FEATURE_RTOL * scale
    log(f"[4 paths] kernel vs plain features (32, 2048): max_abs_diff="
        f"{diff:.4e}, feature scale {scale:.4e}, ratio {diff / scale:.3e} "
        f"(limit {FEATURE_RTOL:g}) {'ok' if ok else 'FAIL'}")
    assert ok, "kernel path and plain path disagree"
    v1 = functools.partial(A.fused_attention, entry=V1_ENTRY)
    ms_k, ms_v1, ms_p = medians_in_turns(
        [lambda: run(A.fused_attention), lambda: run(v1),
         lambda: run(A.attention_reference)], 5)
    log(f"[4 paths] i3d_r50_nl_8x8 forward, 32 clips bf16: routed kernel "
        f"{ms_k:.2f} ms = {32e3 / ms_k:.1f} clips/s, {V1_ENTRY} forced "
        f"{ms_v1:.2f} ms = {32e3 / ms_v1:.1f} clips/s, plain attention "
        f"{ms_p:.2f} ms = {32e3 / ms_p:.1f} clips/s")
    return {"routed_ms": ms_k, "v1_ms": ms_v1, "plain_ms": ms_p}


def phase_default_cfg(paths, root, dev):
    from vidsitu_tpu_torch.models.vb_models import build_feat_extractor

    cfg = smoke_cfg(paths, root, "slow_fast_nl_r50_8x8")
    model = build_feat_extractor(cfg)
    model.load_state_dict(seeded_state_dict(cfg), strict=True)
    model.to(device=dev, memory_format=torch.channels_last_3d)
    rng = np.random.default_rng(1)
    t = cfg.vid_mdl.num_frames
    inp = {
        "frms_ev_fast_tensor": rng.integers(0, 256, (8, t, 224, 224, 3),
                                            dtype=np.uint8),
        "frms_ev_slow_tensor": rng.integers(
            0, 256, (8, t // cfg.vid_mdl.slowfast.alpha, 224, 224, 3),
            dtype=np.uint8),
    }
    with torch.inference_mode():
        out = model.clip_features(
            {k: torch.from_numpy(v).to(dev) for k, v in inp.items()})
    torch.cuda.synchronize()
    ok = tuple(out.shape) == (8, 2304) and bool(torch.isfinite(out).all())
    log(f"[5 default] slow_fast_nl_r50_8x8 8 clips -> {tuple(out.shape)} "
        f"{out.dtype} finite={bool(torch.isfinite(out).all())} "
        f"{'ok' if ok else 'FAIL'}")
    assert ok
    return model, {k: torch.from_numpy(v).to(dev) for k, v in inp.items()}


def beam_rows(gen, dev):
    """Source rows of one beam-5 reorder: each event's 5 new beams drawn
    from its own 5 old ones (repeated parents included)."""
    beam_idx = torch.randint(0, BEAM, (EVENTS, BEAM), generator=gen,
                             device=dev)
    return (torch.arange(EVENTS, device=dev)[:, None] * BEAM
            + beam_idx).reshape(-1)


def cache_leaves(gen, length, dtype, dev):
    """The reorder-mode cache's 12 float leaves, in cache order: per layer
    self K/V (rows, H, L, Dh) and cross K/V (rows, H, 1, Dh)."""
    rows = EVENTS * BEAM
    shapes = [(rows, HEADS, n, HEAD_DIM) for n in (length, length, 1, 1)]
    return [torch.randn(sh, generator=gen, device=dev).to(dtype)
            for _ in range(LAYERS) for sh in shapes]


def phase_gather_kernel(dev):
    from vidsitu_tpu_torch.ops import beam_gather as B

    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for length in SELF_LENS:
            leaves = cache_leaves(gen, length, dtype, dev)
            idx = beam_rows(gen, dev)
            out = B.beam_gather_rows(leaves, idx)
            ref = B.beam_gather_rows_reference(leaves, idx)
            torch.cuda.synchronize()
            ok = all(torch.equal(o, r) for o, r in zip(out, ref))
            err = max((o.float() - r.float()).abs().max().item()
                      for o, r in zip(out, ref))
            log(f"[7 gather] 12 leaves, 400 rows, L={length} "
                f"{str(dtype)[6:]}: bit-identical={ok} max_abs_err={err:g} "
                f"{'ok' if ok else 'FAIL'}")
            assert ok, "row-gather kernel disagrees with index_select"
            worst = max(worst, err)
            del leaves, out, ref
    times = {}
    for length in SELF_LENS:
        leaves = cache_leaves(gen, length, torch.bfloat16, dev)
        idx = beam_rows(gen, dev)

        def queued(fn, calls):
            def run():
                for _ in range(calls):
                    fn(leaves, idx)
            return run

        moved = 2 * sum(x.numel() * x.element_size() for x in leaves)
        for calls in (QUEUED, 1):
            ms, plain_ms = medians_in_turns(
                [queued(B.beam_gather_rows, calls),
                 queued(B.beam_gather_rows_reference, calls)], 10)
            ms, plain_ms = ms / calls, plain_ms / calls
            times[(length, calls)] = (ms, plain_ms)
            what = ("device time, calls queued" if calls > 1
                    else "one call per event pair, host time included")
            times[(length, calls)] += bound(moved, 0)
            log(f"[7 gather] time 12 leaves L={length} bf16 ({moved / 2e9:.3f}"
                f" GB each way), {what}: kernel {ms:.4f} ms "
                f"({moved / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms "
                f"({moved / plain_ms / 1e6:.1f} GB/s)")
        del leaves
    return worst, times[(SELF_LENS[-1], QUEUED)]


def srl_args(paths, root, feats_dir, *extra):
    return ["chip_smoke_srl", "--task_type=vb_arg",
            "--mdl.mdl_name=sfpret_txe_txd_vbarg", "--train.dtype=bfloat16",
            f"--misc.tmp_path={root / 'tmp'}",
            *[f"--{k}={v}" for k, v in paths.items()],
            f"--ds.vsitu.vsit_frm_feats_dir={feats_dir}",
            "--device=cuda", "--allow_random_weights=True", *extra]


def device_batch(cfg, dev):
    """The valid split's first eval batch, padded like the evaluator's."""
    from vidsitu_tpu_torch.data import get_data
    from vidsitu_tpu_torch.evaluation.evaluators import pad_batch_to

    batch = pad_batch_to(next(iter(get_data(cfg).valid_dl)),
                         int(cfg.train.bsv))
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def phase_srl_main(paths, root, feats_dir):
    from vidsitu_tpu_torch import main as port_main
    from vidsitu_tpu_torch.ops import beam_gather as B

    B.LAUNCHES = 0
    t0 = time.perf_counter()
    res = port_main.main(srl_args(paths, root, feats_dir, "--only_val=True",
                                  "--gen.beam_size=5",
                                  "--tpu.ancestry_beam=False"))
    wall = time.perf_counter() - t0
    launches = B.LAUNCHES
    ev, cfg = res["evaluator"], res["cfg"]
    steps = ev.generate_fn.steps
    _, acc = res["results"]["valid"]
    with open(res["pred_dir"] / "valid_0.pkl", "rb") as f:
        preds = pickle.load(f)
    log(f"[8 srl] entries={len(preds)} batches={len(ev.batch_seconds)} "
        f"steps={steps} gather_launches={launches} metrics={acc} "
        f"wall={wall:.2f} s")
    assert len(preds) == 8 and sorted(p["ann_idx"] for p in preds) == list(
        range(8)), "one pkl entry per real segment"
    assert all(set(p["vb_output"]) == {f"Ev{i}" for i in range(1, 6)}
               for p in preds), "5 events per entry"
    assert set(acc) == set(ev.met_keys) and all(
        np.isfinite(v) for v in acc.values()), acc
    assert launches == sum(steps) > 0, (
        f"row-gather launches {launches} != decode steps {sum(steps)}")
    # the forced verb: every event's text starts with its verb id
    batch = device_batch(cfg, "cpu")
    wvoc = ev.comm.gpt2_hf_tok
    verbs = batch["seq_out_by_ev"][:, :, 0, 0].numpy()
    by_idx = {int(i): row for i, row in zip(batch["vseg_idx"], verbs)}
    for p in preds:
        for ev_ix in range(5):
            want = wvoc.decode([int(by_idx[p["ann_idx"]][ev_ix])])
            got = p["vb_output"][f"Ev{ev_ix + 1}"].get("vb_id", "")
            assert got.startswith(want), (p["ann_idx"], ev_ix, got, want)
    sec = ev.batch_seconds[0]
    log(f"[8 srl] batch of 16 segments (80 events, 400 beam rows), first "
        f"call: {sec:.3f} s, {sec * 1e3 / steps[0]:.3f} ms/step over "
        f"{steps[0]} steps, {80 / sec:.1f} events/s")
    return launches, ev.generate_fn, cfg


def phase_srl_profile(gen, batch):
    """One more decode of the main path's batch under torch.profiler: device
    time by kernel, and the busy share against the same decode unprofiled
    (the profiler slows the host several times over)."""
    from torch.profiler import ProfilerActivity, profile

    _, wall = timed_search(gen, batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, prof_wall = timed_search(gen, batch)
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
    per_step = sum(e.count for e in rows) / out.steps
    log(f"[8 profile] reorder route, {out.steps} steps: device kernels "
        f"{dev_ms:.1f} ms = {dev_ms / out.steps:.3f} ms/step, {per_step:.1f} "
        f"kernels/step; unprofiled "
        f"wall {wall * 1e3:.1f} ms (device busy {100 * dev_ms / wall / 1e3:.1f}"
        f" %); profiled wall {prof_wall * 1e3:.1f} ms")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms "
            f"{100 * e.self_device_time_total / 1e3 / dev_ms:5.1f} % "
            f"{e.count:6d}x  {e.key[:80]}")


def timed_search(gen, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = gen.search(batch)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def generator_for(model, cfg, comm, beam_size=BEAM, ancestry=False):
    """The entry point's generator over ``model``, for cfg with the beam
    size and ``tpu.ancestry_beam`` given."""
    from vidsitu_tpu_torch.models.selector import build_srl_generate_fn

    cfg = cfg.clone().defrost()
    cfg.gen.beam_size = beam_size
    cfg.tpu.ancestry_beam = ancestry
    return build_srl_generate_fn(cfg, comm, model)


def phase_routes(gen, cfg, dev):
    from vidsitu_tpu_torch.data import build_comm
    from vidsitu_tpu_torch.gates import plain_gather
    from vidsitu_tpu_torch.models.selector import build_model

    comm = build_comm(cfg)
    batch = device_batch(cfg, dev)
    model = gen.model
    reorder = generator_for(model, cfg, comm)
    runs = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel") * 2:  # in turns
        if name == "plain":
            with plain_gather():
                runs[name].append(timed_search(reorder, batch))
        else:
            runs[name].append(timed_search(reorder, batch))
    out_k, out_p = runs["kernel"][0][0], runs["plain"][0][0]
    t_k = float(np.median([t for _, t in runs["kernel"]]))
    t_p = float(np.median([t for _, t in runs["plain"]]))
    same = all(torch.equal(o.seqs, out_k.seqs)
               and torch.equal(o.scores, out_k.scores)
               for o, _ in runs["kernel"] + runs["plain"])
    spread = {n: " ".join(f"{t:.3f}" for _, t in r) for n, r in runs.items()}
    log(f"[9 routes] reorder route, kernel vs plain gather: identical tokens "
        f"and scores={same}; {t_k:.3f} s vs {t_p:.3f} s per batch (median "
        f"of 4 each, in turns; {out_k.steps} steps: "
        f"{t_k * 1e3 / out_k.steps:.3f} vs {t_p * 1e3 / out_p.steps:.3f} "
        f"ms/step; runs: kernel {spread['kernel']}, plain {spread['plain']})")
    assert same, "kernel and plain gather routes disagree"
    verbs = batch["seq_out_by_ev"][:, :, 0, 0].reshape(-1)
    assert torch.equal(out_k.seqs[:, 0, 0], verbs), "verb not forced"
    out_a, t_a = timed_search(generator_for(model, cfg, comm, ancestry=True),
                              batch)
    out_g, t_g = timed_search(generator_for(model, cfg, comm, beam_size=1),
                              batch)
    assert torch.equal(out_g.seqs[:, 0, 0], verbs), "greedy: verb not forced"
    log(f"[9 routes] bf16 per batch: ancestry {t_a:.3f} s "
        f"({t_a * 1e3 / out_a.steps:.3f} ms/step, {80 / t_a:.1f} events/s), "
        f"reorder+kernel {t_k:.3f} s ({80 / t_k:.1f} events/s), greedy "
        f"{t_g:.3f} s ({t_g * 1e3 / out_g.steps:.3f} ms/step, "
        f"{80 / t_g:.1f} events/s)")
    # ancestry vs reorder in float32, same weights
    f32_cfg = cfg.clone().defrost()
    f32_cfg.train.dtype = "float32"
    m32 = build_model(f32_cfg, comm)
    m32.load_state_dict(model.state_dict(), strict=True)
    m32.to(dev).eval()
    out_r32, t_r32 = timed_search(generator_for(m32, f32_cfg, comm), batch)
    out_a32, t_a32 = timed_search(
        generator_for(m32, f32_cfg, comm, ancestry=True), batch)
    equal = (out_r32.seqs[:, 0] == out_a32.seqs[:, 0]).all(-1)
    share = equal.float().mean().item()
    log(f"[9 routes] float32 ancestry vs reorder: top-beam tokens equal on "
        f"{int(equal.sum())}/{equal.numel()} events ({100 * share:.2f} %, "
        f"limit {100 * ROUTE_AGREEMENT:g} %); {t_a32:.3f} s vs {t_r32:.3f} s")
    assert share >= ROUTE_AGREEMENT, "ancestry and reorder routes disagree"


def phase_real_vocab(cfg, dev):
    """Phase 10: the generator alone at the real vocabulary size."""
    from vidsitu_tpu_torch.convert.from_flax import (
        flax_to_state_dict,
        seeded_variables,
    )
    from vidsitu_tpu_torch.gen.beam import GenConfig
    from vidsitu_tpu_torch.gen.generate import make_srl_generator
    from vidsitu_tpu_torch.models.srl_models import SRLModel
    from vidsitu_tpu_torch.models.transformer import TxConfig
    from vidsitu_tpu_torch.ops import beam_gather as B

    t0 = time.perf_counter()
    dec = TxConfig.from_cfg(cfg.tx_dec, REAL_VOCAB, REAL_VOCAB - 1,
                            dtype=torch.bfloat16)
    enc = TxConfig.from_cfg(cfg.tx_dec, REAL_VOCAB, REAL_VOCAB - 1,
                            side="encoder", dtype=torch.bfloat16)
    model = SRLModel("sfpret_txe_txd_vbarg", dec, enc, "old", 2048)
    model.load_state_dict(flax_to_state_dict(seeded_variables(model, 7)),
                          strict=True)
    model.to(dev).eval()
    rng = np.random.default_rng(10)
    seq = np.full((16, 5, 3, 60), REAL_VOCAB - 1, np.int64)
    seq[:, :, :, 0] = rng.integers(256, 50256, (16, 5, 1))  # forced
    batch = {
        "seq_out_by_ev": torch.from_numpy(seq).to(dev),
        "frm_feats": torch.from_numpy(
            rng.standard_normal((16, 5, 2048)).astype(np.float32)).to(dev),
    }
    log(f"[10 vocab] model with V={REAL_VOCAB} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    times = {}
    outs = {}
    for name, ancestry in (("reorder+kernel", False), ("ancestry", True)):
        gen = make_srl_generator(
            model, GenConfig(beam_size=BEAM, max_len_b=int(cfg.gen.max_len_b)),
            vocab_size=REAL_VOCAB, pad_id=REAL_VOCAB - 1, bos_id=50256,
            eos_id=50256, ancestry=ancestry, seg_min=64)
        B.LAUNCHES = 0
        out, sec = timed_search(gen, batch)
        launches = B.LAUNCHES
        assert launches == (0 if ancestry else out.steps), launches
        assert out.seqs.shape == (80, BEAM, gen.max_len + 1) and bool(
            torch.isfinite(out.scores).all())
        assert torch.equal(out.seqs[:, 0, 0],
                           batch["seq_out_by_ev"][:, :, 0, 0].reshape(-1))
        times[name], outs[name] = sec, out
        log(f"[10 vocab] {name}: {sec:.3f} s per batch, {out.steps} steps, "
            f"{sec * 1e3 / out.steps:.3f} ms/step, {80 / sec:.1f} events/s, "
            f"gather launches {launches}")
    same = (outs["reorder+kernel"].seqs[:, 0] == outs["ancestry"].seqs[:, 0]
            ).all(-1).float().mean().item()
    log(f"[10 vocab] bf16 routes: top-beam tokens equal on "
        f"{100 * same:.2f} % of events (bf16 rounding differs by route)")


def fb_operands(rng, cin, cmid, cout, proj, dtype, dev):
    """Seeded folded weights (std fan_in**-0.5) and non-zero float32 shifts
    in the fused bottleneck's layouts."""
    def weight(*shape):
        fan_in = int(np.prod(shape[:-1]))
        return torch.from_numpy((rng.standard_normal(shape) * fan_in ** -0.5)
                                .astype(np.float32)).to(dev, dtype)

    def shift(n):
        return torch.from_numpy((0.1 * rng.standard_normal((1, n)))
                                .astype(np.float32)).to(dev)

    ops = [weight(cin, cmid), shift(cmid), weight(3, 3, cmid, cmid),
           shift(cmid), weight(cmid, cout), shift(cout)]
    return ops + ([weight(cin, cout), shift(cout)] if proj else [None, None])


def phase_fused_kernel(dev):
    """Phase 12: both entry points against the plain version, then timed."""
    from vidsitu_tpu_torch import gates
    from vidsitu_tpu_torch.ops import fused_bottleneck as FB

    rng = np.random.default_rng(12)
    worst = {"frames": 0.0, "multi": 0.0}
    for name, (h, w, cin, cmid, cout, proj) in FB_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            ops = fb_operands(rng, cin, cmid, cout, proj, dtype, dev)
            x = torch.from_numpy(rng.standard_normal((8, h, w, cin)).astype(
                np.float32)).to(dev, dtype)
            want = FB.fused_bottleneck_plain(x, *ops).float()
            scale = want.abs().max().item()
            limit = FB_TOL[dtype] * (scale if dtype == torch.bfloat16 else 1.0)
            runs = {"frames": lambda: FB.fused_bottleneck_frames(x, *ops)}
            if not proj:
                for fps in (2, 4):
                    runs[f"multi fps={fps}"] = (
                        lambda fps=fps: FB.fused_bottleneck_multi(
                            x, *ops[:6], frames_per_step=fps))
            for entry, fn in runs.items():
                got = fn()
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                ok = got.shape == want.shape and got.dtype == dtype and (
                    err <= limit)
                staged = (f" staged(wa,wb,wc)={FB.LAST_STAGED}"
                          if entry != "frames" else "")
                log(f"[12 fused] {name} 8x{h}x{w} {cin}->{cmid}->{cout} "
                    f"{str(dtype)[6:]} {entry}: max_abs_err={err:.3e} (limit "
                    f"{limit:.3e}, scale {scale:.3f}){staged} "
                    f"{'ok' if ok else 'FAIL'}")
                assert ok, "fused bottleneck disagrees with the plain version"
                if dtype == torch.bfloat16:
                    key = "frames" if entry == "frames" else "multi"
                    worst[key] = max(worst[key], err)
    timed = gates.gate_fused_bottleneck(dev)
    # the plain version at the gate's 256 frames (float32 convs on the bf16
    # operands: it repeats the kernel's arithmetic, it is no yardstick)
    block = gates.s2_block(dev)
    folded = FB.fold_bottleneck(block, torch.bfloat16)
    x = torch.randn((256, 56, 56, 256), device=dev).to(torch.bfloat16)
    plain_ms = float(np.median(cuda_ms(
        lambda: FB.fused_bottleneck_plain(x, *folded), 3)))
    log(f"[12 fused] plain version, slow-s2 256 frames bf16: {plain_ms:.3f} ms")
    return worst, timed, plain_ms


def phase_fused_in_model(model, inp, dev):
    """Phase 13: the fused block on the six eligible slow-pathway blocks'
    real inputs, captured in one SlowFast forward, against the blocks' own
    outputs."""
    from vidsitu_tpu_torch.ops import fused_bottleneck as FB

    blocks = dict(model.backbone.named_modules())
    captured = {}
    hooks = [blocks[name].register_forward_hook(
        lambda mod, args, out, name=name: captured.__setitem__(
            name, (args[0], out))) for name in FUSED_BLOCKS]
    with torch.inference_mode():
        feats = model.clip_features(inp)
    for h in hooks:
        h.remove()
    assert bool(torch.isfinite(feats).all()) and set(captured) == set(
        FUSED_BLOCKS)
    before = FB.LAUNCHES["fused_bottleneck_frames"]
    worst = 0.0
    for name in FUSED_BLOCKS:
        x, want = captured[name]
        want = want.permute(0, 2, 3, 4, 1).float()
        got = FB.run_fused_block(blocks[name], x.permute(0, 2, 3, 4, 1),
                                 dtype=torch.bfloat16).float()
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        ok = got.shape == want.shape and err <= FEATURE_RTOL * scale
        log(f"[13 model] {name} {tuple(x.shape)} -> {tuple(want.shape)}: "
            f"fused vs the block's output max_abs_diff={err:.4e}, scale "
            f"{scale:.4e}, ratio {err / scale:.3e} (limit {FEATURE_RTOL:g}) "
            f"{'ok' if ok else 'FAIL'}")
        assert ok, f"fused block disagrees with {name}"
        worst = max(worst, err / scale)
    launches = FB.LAUNCHES["fused_bottleneck_frames"] - before
    assert launches == len(FUSED_BLOCKS), launches
    log(f"[13 model] {launches} fused-bottleneck launches for "
        f"{len(FUSED_BLOCKS)} blocks")
    return worst


def phase_copy_probes(dev):
    """Phase 14: every copy probe bit-identical at every block shape (the
    gate asserts it), rates beside clone() and one elementwise op."""
    from vidsitu_tpu_torch import gates

    res = gates.gate_copy_floor(dev)
    assert sorted(map(tuple, res["refused_blocks"])) == sorted(
        gates.REFUSED_BLOCKS), "a VMEM-sized block was not refused"
    log(f"[14 copy] bit-identical at blocks {list(res['staged_gbps'])}, "
        f"pipelined and direct; refused {res['refused_blocks']}")
    return res


def phase_bench(dev):
    """Phase 15: the measuring entry point in process."""
    from vidsitu_tpu_torch import bench

    name = torch.cuda.get_device_name(dev)
    (gates_res,) = bench.main(["gates"])
    assert gates_res["device"] == name
    assert gates_res["beam_gather"]["pass"], gates_res["beam_gather"]
    assert isinstance(gates_res["copy_floor"]["flip"], bool)
    assert all(isinstance(v["flip"], bool)
               for v in gates_res["fused_bottleneck"].values())
    (featext,) = bench.main(["featext", "32"])
    (decode,) = bench.main(["decode5_real"])
    for res, metric in ((featext, "slowfast_r50_8x8_featext"),
                        (decode, "srl_beam5_decode_latency_d1024")):
        assert res["metric"] == metric and res["device"] == name, res
        assert np.isfinite(res["value"]) and res["value"] > 0, res
        assert name in res["roofline_of"] and res["roofline_frac"] > 0, res
    log(f"[15 bench] gates, featext 32 ({featext['value']} clips/s, "
        f"{featext['tflops']} TFLOP/s) and decode5_real "
        f"({decode['value']} ms/video over {decode['steps']} steps) ok")
    return gates_res, featext, decode


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (REPO / "vidsitu_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no vidsitu_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    global cuda_ms, medians_in_turns
    from vidsitu_tpu_torch.timing import cuda_ms, medians_in_turns
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase_build()
    attn_err, times = phase_kernel(dev)
    gather_err, gather_times = phase_gather_kernel(dev)
    fused_err, fused_timed, fused_plain_ms = phase_fused_kernel(dev)
    copy_res = phase_copy_probes(dev)

    from vidsitu_tpu_torch.data.synth import make_synth_dataset

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        paths = make_synth_dataset(root / "data", n_train=2, n_valid=8,
                                   n_test=1, with_frames=True, frame_hw=224)
        log(f"[3 main] synthetic dataset (224 px JPEGs) in "
            f"{time.perf_counter() - t0:.1f} s")
        cfg = smoke_cfg(paths, root, "i3d_r50_nl_8x8")
        state_dict = seeded_state_dict(cfg)
        launches, by_entry = phase_main_path(cfg, state_dict, root / "feats")
        forward_ms = phase_paths_agree(cfg, state_dict, dev)
        sf_model, sf_inp = phase_default_cfg(paths, root, dev)
        # the SRL models read the feature width from the directory's name
        feats_dir = root / "i3d_nl_smoke_feats"
        feats_dir.symlink_to(root / "feats", target_is_directory=True)
        gather_launches, gen, srl_cfg = phase_srl_main(paths, root, feats_dir)
        phase_routes(gen, srl_cfg, dev)
        phase_srl_profile(gen, device_batch(srl_cfg, dev))
        phase_real_vocab(srl_cfg, dev)

    # this slice's main path: the fused block on the model's own blocks,
    # then the measuring entry point; counts set to 0 just before
    from vidsitu_tpu_torch.ops import beam_gather as B
    from vidsitu_tpu_torch.ops import copy_probe as CP
    from vidsitu_tpu_torch.ops import fused_bottleneck as FB

    FB.reset_launches()
    CP.reset_launches()
    B.LAUNCHES = 0
    model_err = phase_fused_in_model(sf_model, sf_inp, dev)
    del sf_model, sf_inp
    torch.cuda.empty_cache()
    gates_res, featext, decode = phase_bench(dev)
    slice_launches = {**FB.LAUNCHES, **CP.LAUNCHES,
                      "beam_gather_rows": B.LAUNCHES}
    log(f"[15 bench] kernel launches on this slice's path: {slice_launches}")
    assert all(n > 0 for n in slice_launches.values()), slice_launches

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    assert not leaked, f"jax was imported: {leaked[:5]}"
    def kernel_row(name, source, replaces, n_launches, err, ms, plain_ms,
                   bound_ms, bound_by, library_ms, **more):
        return {"name": name, "route": "cuda",
                "source": f"vidsitu_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, **more}

    s3, s4 = times["s3"], times["s4"]
    # fused bottleneck at the gate's 256 frames of 56x56, 256/64/256, bf16
    fb256, fb960 = fused_timed["256"], fused_timed["960"]
    fb_ops = 2 * 56 * 56 * (256 * 64 + 9 * 64 * 64 + 64 * 256)
    fb_bound = bound(fb256["least_bytes"], 256 * fb_ops)
    fb_bound960 = bound(fb960["least_bytes"], 960 * fb_ops)
    copy_bytes = 2 * 6144 * 65536 * 2
    copy_ms = {k: copy_bytes / 1e6 / v for k, v in (
        ("staged", max(copy_res["staged_gbps"].values())),
        ("pipelined", copy_res["pipelined_gbps"]),
        ("direct", copy_res["direct_gbps"]),
        ("clone", copy_res["clone_gbps"]))}
    copy_bound = bound(copy_bytes, 0)
    log(json.dumps({"kernels": [
        kernel_row(s3["entry"], "nonlocal_attn.cu",
                   "vidsitu_tpu/ops/attention.py:61", launches,
                   attn_err[s3["entry"]], s3["ms"], s3["plain_ms"],
                   s3["bound_ms"], s3["bound_by"], s3["library_ms"],
                   ms_s4=s4["ms"], plain_ms_s4=s4["plain_ms"],
                   library_ms_s4=s4["library_ms"], bound_ms_s4=s4["bound_ms"],
                   ms_v1=s3["v1_ms"], ms_v1_s4=s4["v1_ms"],
                   max_abs_err_v1=attn_err[V1_ENTRY],
                   dot_product_ms=s3["dot_product_ms"],
                   five_clips_ms=s3["five_clips_ms"],
                   launches_by_entry=by_entry, forward_ms=forward_ms),
        kernel_row("beam_gather_rows", "beam_gather.cu",
                   "benchmarks/probe_beam_gather.py:62", gather_launches,
                   gather_err, gather_times[0], gather_times[1],
                   gather_times[2], gather_times[3], gather_times[1],
                   launches_slice=slice_launches["beam_gather_rows"]),
        kernel_row("fused_bottleneck_frames", "fused_bottleneck.cu",
                   "benchmarks/probe_fused_bottleneck.py:108",
                   slice_launches["fused_bottleneck_frames"],
                   fused_err["frames"], fb256["frames_ms"], fused_plain_ms,
                   *fb_bound, fb256["unfused_ms"], ms_960=fb960["frames_ms"],
                   library_ms_960=fb960["unfused_ms"],
                   bound_ms_960=fb_bound960[0], model_rel_err=model_err),
        kernel_row("fused_bottleneck_multi", "fused_bottleneck.cu",
                   "benchmarks/micro4.py:84",
                   slice_launches["fused_bottleneck_multi"],
                   fused_err["multi"],
                   min(fb256["multi2_ms"], fb256["multi4_ms"]),
                   fused_plain_ms, *fb_bound, fb256["unfused_ms"],
                   ms_960=min(fb960["multi2_ms"], fb960["multi4_ms"]),
                   library_ms_960=fb960["unfused_ms"],
                   bound_ms_960=fb_bound960[0]),
        kernel_row("staged_copy", "copy_probe.cu", "benchmarks/gates.py:86",
                   slice_launches["staged_copy"], 0.0, copy_ms["staged"],
                   copy_ms["clone"], *copy_bound, copy_ms["clone"]),
        kernel_row("pipelined_copy", "copy_probe.cu",
                   "benchmarks/micro3.py:130",
                   slice_launches["pipelined_copy"], 0.0,
                   copy_ms["pipelined"], copy_ms["clone"], *copy_bound,
                   copy_ms["clone"]),
        kernel_row("direct_copy", "copy_probe.cu", "benchmarks/micro3.py:158",
                   slice_launches["direct_copy"], 0.0, copy_ms["direct"],
                   copy_ms["clone"], *copy_bound, copy_ms["clone"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
