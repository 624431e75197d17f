#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vidsitu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases, each of which must pass (any failure raises and exits non-zero):

1. build: the non-local attention kernel from vidsitu_tpu_torch/csrc/;
2. kernel vs plain: the kernel against its plain PyTorch version at the
   I3D-NL 224 px shapes (B=8: stage 3 3136x784x256, stage 4 784x196x512)
   and a ragged one (200x200x128), both kinds, bf16 and float32, with the
   JAX package's tolerances (atol 2e-4 float32, 5e-2 bf16); then both
   timed in bf16 at the main path's batch (32 clips);
3. main path: ``extract_features`` of I3D-NL R50 (full width and depth,
   224 px, 8 frames, bf16, seeded weights with non-zero BatchNorm gammas)
   over a synthetic valid split of 8 segments = 40 clips at clip_batch 32:
   2 dispatches (the second zero-padded), 8 files of (5, 2048), finite, and
   exactly 5 non-local blocks x 2 dispatches kernel launches;
4. kernel path == plain path: one batch of those clips through the model
   once with the kernel and once with the plain attention, features within
   2e-2 of the feature scale (bf16), and both timed;
5. the default configuration (SlowFast R50 8x8) forward on 8 clips.

Prints the GPU's name and power limit first, a JSON line of kernel results
before the last line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
S3, S4, RAGGED = (3136, 784, 256), (784, 196, 512), (200, 200, 128)
ATOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
FEATURE_RTOL = 2e-2  # kernel vs plain path, relative to max |feature|


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> list:
    """Per-call times (ms) of ``fn`` by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def interleaved_medians(fn_a, fn_b, reps: int):
    """Median ms of two functions timed in turns a, b, b, a."""
    times = {fn_a: [], fn_b: []}
    for pair in ((fn_a, fn_b), (fn_b, fn_a)):
        for fn in pair:
            times[fn].extend(cuda_ms(fn, reps))
    return float(np.median(times[fn_a])), float(np.median(times[fn_b]))


def seeded_qkv(rng, b, sq, sk, d, dtype, dev):
    return [torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))
            .to(dev, dtype) for s in (sq, sk, sk)]


def phase_build():
    from vidsitu_tpu_torch.ops import _build

    lib = _build.library_path("nonlocal_attn")
    lib.unlink(missing_ok=True)  # build from the checkout's source
    t0 = time.perf_counter()
    _build.load_nonlocal_attn()
    log(f"[1 build] nonlocal_attn.cu -> {lib.name} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in (_build.BUILD_DIR / "nonlocal_attn.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("    ptxas:", line.strip())


def phase_kernel(dev):
    from vidsitu_tpu_torch.ops import attention as A

    rng = np.random.default_rng(0)
    worst_bf16 = 0.0
    for name, (sq, sk, d) in (("s3", S3), ("s4", S4), ("ragged", RAGGED)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = seeded_qkv(rng, 8, sq, sk, d, dtype, dev)
            for kind in ("softmax", "dot_product"):
                out = A.fused_attention(q, k, v, kind, d ** -0.5)
                ref = A.attention_reference(q, k, v, kind, d ** -0.5)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                ok = out.shape == ref.shape and out.dtype == dtype and (
                    err <= ATOL[dtype])
                log(f"[2 kernel] {name} B=8 Sq={sq} Sk={sk} d={d} "
                    f"{str(dtype)[6:]} {kind}: max_abs_err={err:.3e} "
                    f"(atol {ATOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
                assert ok, "kernel disagrees with the plain version"
                if dtype == torch.bfloat16:
                    worst_bf16 = max(worst_bf16, err)
    times = {}
    for name, (sq, sk, d) in (("s3", S3), ("s4", S4)):
        q, k, v = seeded_qkv(rng, 32, sq, sk, d, torch.bfloat16, dev)
        out = A.fused_attention(q, k, v, "softmax", d ** -0.5)
        ref = A.attention_reference(q, k, v, "softmax", d ** -0.5)
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= ATOL[torch.bfloat16], f"{name} B=32: {err}"
        worst_bf16 = max(worst_bf16, err)
        ms, plain_ms = interleaved_medians(
            lambda: A.fused_attention(q, k, v, "softmax", d ** -0.5),
            lambda: A.attention_reference(q, k, v, "softmax", d ** -0.5), 20)
        flops = 4 * 32 * sq * sk * d
        times[name] = (ms, plain_ms)
        log(f"[2 kernel] time {name} B=32 bf16 softmax: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"max_abs_err={err:.3e}")
    return worst_bf16, times


def smoke_cfg(paths, root, preset):
    from vidsitu_tpu.utils.config import get_cfg_with_overrides

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
    from vidsitu_tpu.data.comm import build_comm
    from vidsitu_tpu_torch.extract import extract_features
    from vidsitu_tpu_torch.ops import attention as A

    comm = build_comm(cfg)
    timings = []
    A.LAUNCHES = 0
    t0 = time.perf_counter()
    counts = extract_features(
        cfg, comm, state_dict=state_dict, splits=["valid"], out_dir=out_dir,
        batch_size=4, num_threads=8, clip_batch=32, device="cuda",
        timings=timings)
    wall = time.perf_counter() - t0
    launches = A.LAUNCHES
    files = sorted(Path(out_dir).glob("*_feats.npy"))
    arrs = [np.load(f) for f in files]
    log(f"[3 main] counts={counts} files={len(files)} dispatches="
        f"{len(timings)} nl_launches={launches} wall={wall:.2f} s")
    assert counts == {"valid": 8} and len(files) == 8, counts
    assert len(timings) == 2, f"expected 2 dispatches, got {len(timings)}"
    assert all(a.shape == (5, 2048) and a.dtype == np.float32
               and np.isfinite(a).all() for a in arrs), "bad feature files"
    assert launches == 5 * 2, f"NL kernel launches {launches} != 5 x 2"
    # excluding the first dispatch: from its fetch to the second's fetch
    # (the second batch was queued before the first fetch, so the interval
    # is shorter than a whole forward)
    dt = timings[1] - timings[0]
    log(f"[3 main] after the first dispatch: {dt * 1e3:.1f} ms to the "
        f"second fetch (32 clips on the device, 8 real) -> {32 / dt:.1f} "
        f"device clips/s, {8 / dt:.1f} real clips/s")
    return launches


def phase_paths_agree(cfg, state_dict, dev):
    from vidsitu_tpu.data.comm import build_comm
    from vidsitu_tpu.data.loader import fold_frame_events, stack_collate
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
    ms_k, ms_p = interleaved_medians(lambda: run(A.fused_attention),
                                     lambda: run(A.attention_reference), 5)
    log(f"[4 paths] i3d_r50_nl_8x8 forward, 32 clips bf16: kernel path "
        f"{ms_k:.2f} ms = {32e3 / ms_k:.1f} clips/s, plain path {ms_p:.2f} ms"
        f" = {32e3 / ms_p:.1f} clips/s")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (REPO / "vidsitu_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no vidsitu_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
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
    worst_bf16, times = phase_kernel(dev)

    from vidsitu_tpu.data.synth import make_synth_dataset

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        paths = make_synth_dataset(root / "data", n_train=2, n_valid=8,
                                   n_test=1, with_frames=True, frame_hw=224)
        log(f"[3 main] synthetic dataset (224 px JPEGs) in "
            f"{time.perf_counter() - t0:.1f} s")
        cfg = smoke_cfg(paths, root, "i3d_r50_nl_8x8")
        state_dict = seeded_state_dict(cfg)
        launches = phase_main_path(cfg, state_dict, root / "feats")
        phase_paths_agree(cfg, state_dict, dev)
        phase_default_cfg(paths, root, dev)

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    assert not leaked, f"jax was imported: {leaked[:5]}"
    log(json.dumps({"kernels": [{
        "name": "nl_attn_fwd",
        "route": "cuda",
        "source": "vidsitu_tpu_torch/csrc/nonlocal_attn.cu",
        "replaces": "vidsitu_tpu/ops/attention.py:61",
        "launches": launches,
        "max_abs_err": worst_bf16,
        "ms": times["s3"][0],
        "plain_ms": times["s3"][1],
        "ms_s4": times["s4"][0],
        "plain_ms_s4": times["s4"][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
