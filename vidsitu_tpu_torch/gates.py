"""Stack gates on the card (counterpart of benchmarks/gates.py): one command
that re-measures the go / no-go decisions and prints explicit FLIP / no-flip
lines.

    python -m vidsitu_tpu_torch.bench gates [--batch]      # one GPU

Gates:
  1.  Copy floor: what the hand-written copy kernels (ops/copy_probe.py:
      staged through shared memory at several block shapes, the two-slot
      ``cp.async`` ring, the direct copy) move on a 768 MB bf16 tensor,
      beside ``clone()`` and one elementwise PyTorch op on the same tensor.
      The fused bottleneck (ops/fused_bottleneck.py) moves fewer bytes than
      the unfused chain but through a hand-written data path; the gate flips
      when the best staged copy reaches 80 % of the elementwise rate
      measured in the same run.
  1b. The fused bottleneck itself against the unfused chain
      (``Bottleneck.forward``, eval mode, bf16, channels-last) at slow-s2
      geometry (56x56, 256/64/256) for 256 frames (32 clips) and 960 frames
      (120 clips), timed in turns. FLIP when a fused kernel is faster: it is
      then worth routing into the backbone and an A/B with ``bench featext``.
  2.  The beam-cache row-gather kernel against ``index_select`` inside a
      beam-5 decode at the reference's decoder dims: PASS is zero token
      mismatches.
  3.  The JAX gate 3 checks XLA's 128-lane batch-minor layouts on a TPU; a
      GPU pads no batch to lanes, so the port prints one line saying so.
  4.  (``--batch``) ``featext`` at 32, 64 and 128 clips.

The gates measure the card: they refuse every other device.
"""

from __future__ import annotations

import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

from .extract import resolve_device
from .timing import cuda_ms, medians_in_turns

COPY_SHAPE = (6144, 65536)  # bf16: 768 MB
# block shapes (rows, columns) of the staged copy that fit a thread block's
# shared memory: the JAX probe's aspect ratios (benchmarks/micro3.py:66-74)
# at 128-192 KB a block, a column-ish one and a small one
STAGED_BLOCKS = ((32, 2048), (16, 4096), (48, 2048), (384, 128), (8, 2048))
# the JAX probe's own VMEM-sized blocks: each needs 0.5-8 MB and is refused
REFUSED_BLOCKS = ((512, 2048), (512, 4096), (1024, 4096), (6144, 512),
                  (128, 2048))
FLIP_SHARE = 0.8  # of the elementwise op's rate, measured in the same run
S2 = dict(hw=56, cin=256, cmid=64, cout=256)  # slow pathway, stage s2
FRAME_COUNTS = (256, 960)  # 32 and 120 clips of 8 slow frames


def require_cuda(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(
            f"the gates measure the card; device {dev} is refused (run them "
            "on a GPU: python -m vidsitu_tpu_torch.bench gates)")
    return dev


def chain_ms(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
             iters: int = 10) -> float:
    """Per-iteration ms of a shape-preserving ``fn`` with the whole tensor
    as the carry (out_k = fn(out_{k-1})), so every iteration reads its
    input and writes its output."""
    def run():
        out = x
        for _ in range(iters):
            out = fn(out)
        return out

    return float(np.median(cuda_ms(run, 3))) / iters


def gate_copy_floor(dev: torch.device) -> Dict:
    from .ops import copy_probe as CP

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(COPY_SHAPE, generator=gen, device=dev,
                    dtype=torch.float32).to(torch.bfloat16)
    gb = 2 * x.numel() * x.element_size() / 1e9  # read + write

    def gbps(fn):
        return gb / chain_ms(fn, x) * 1e3

    staged = {}
    for block in STAGED_BLOCKS:
        out = CP.staged_copy(x, block)
        assert torch.equal(out, x), f"staged copy {block} altered the data"
        del out
        staged[block] = gbps(lambda a, b=block: CP.staged_copy(a, b))
        print(f"[gate 1] staged copy, block {block}: {staged[block]:7.0f} GB/s")
    refused = []
    for block in REFUSED_BLOCKS:
        try:
            CP.check_block(x, block)
        except ValueError:
            refused.append(block)
    print(f"[gate 1] blocks {refused} (the TPU probe's) need more than a "
          f"thread block's {CP.SMEM_LIMIT} bytes of shared memory: refused")
    for fn in (CP.pipelined_copy, CP.direct_copy):
        assert torch.equal(fn(x), x), f"{fn.__name__} altered the data"
    rates = {
        "pipelined_gbps": gbps(CP.pipelined_copy),
        "direct_gbps": gbps(CP.direct_copy),
        "clone_gbps": gbps(torch.clone),
        "elementwise_gbps": gbps(lambda a: torch.mul(a, 1.0000001)),
    }
    best_block = max(staged, key=staged.get)
    best = staged[best_block]
    threshold = FLIP_SHARE * rates["elementwise_gbps"]
    flip = best >= threshold
    print(f"[gate 1] staged copy kernel: {best:6.0f} GB/s (block "
          f"{best_block}) | pipelined: {rates['pipelined_gbps']:6.0f} | "
          f"direct: {rates['direct_gbps']:6.0f} | clone(): "
          f"{rates['clone_gbps']:6.0f} | elementwise op: "
          f"{rates['elementwise_gbps']:6.0f} GB/s | threshold "
          f"{threshold:.0f} ({100 * FLIP_SHARE:g} % of elementwise)")
    print("[gate 1] " + (
        "FLIP: copy floor crossed — consider routing the fused bottleneck "
        "into the model (ops/fused_bottleneck.py) and A/B with bench featext"
        if flip else
        "no-flip: fused bottleneck stays a gate-only probe"))
    return {"staged_gbps": {str(k): round(v, 1) for k, v in staged.items()},
            "refused_blocks": [list(b) for b in refused],
            **{k: round(v, 1) for k, v in rates.items()},
            "threshold_gbps": round(threshold, 1), "flip": bool(flip)}


def s2_block(dev: torch.device):
    """A seeded slow-s2 Bottleneck (256 -> 64 -> 256, temporal kernel 1) in
    eval mode, bf16 conv weights, channels-last."""
    from .convert.from_flax import flax_to_state_dict, seeded_variables
    from .models.video_backbone import Bottleneck, VideoCfg, to_compute_dtype

    block = Bottleneck(S2["cin"], S2["cout"], S2["cmid"], 1, 1, VideoCfg())
    block.load_state_dict(flax_to_state_dict(seeded_variables(block, 0)),
                          strict=True)
    block = to_compute_dtype(block.eval(), torch.bfloat16)
    return block.to(device=dev, memory_format=torch.channels_last_3d)


def gate_fused_bottleneck(dev: torch.device, reps: int = 5) -> Dict:
    from .ops import fused_bottleneck as FB

    block = s2_block(dev)
    folded = FB.fold_bottleneck(block, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)
    res: Dict = {}
    for n_frames in FRAME_COUNTS:
        # (clips, 8, H, W, C) in memory; the model sees it as (N, C, T, H, W)
        frames = torch.randn((n_frames, S2["hw"], S2["hw"], S2["cin"]),
                             generator=gen, device=dev).to(torch.bfloat16)
        ncthw = frames.reshape(n_frames // 8, 8, *frames.shape[1:]).permute(
            0, 4, 1, 2, 3)

        def unfused():
            with torch.inference_mode():
                return block(ncthw)

        want = unfused().permute(0, 2, 3, 4, 1).reshape(frames.shape).float()
        scale = want.abs().max().item()
        kernels = {
            "frames": lambda: FB.fused_bottleneck_frames(frames, *folded),
            "multi2": lambda: FB.fused_bottleneck_multi(frames, *folded[:6],
                                                        frames_per_step=2),
            "multi4": lambda: FB.fused_bottleneck_multi(frames, *folded[:6],
                                                        frames_per_step=4),
        }
        times = {}
        for name, fn in kernels.items():
            err = (fn().float() - want).abs().max().item()
            assert err <= 5e-2 * scale, (name, n_frames, err, scale)
            times[name], times["unfused_vs_" + name] = medians_in_turns(
                [fn, unfused], reps)
        unfused_ms = float(np.median(
            [times.pop("unfused_vs_" + name) for name in kernels]))
        moved = (frames.numel() + want.numel()) * frames.element_size()
        best = min(kernels, key=times.get)
        flip = times[best] < unfused_ms
        print(f"[gate 1b] slow-s2 block, {n_frames} frames bf16 "
              f"({moved / 1e9:.2f} GB least traffic): fused frames "
              f"{times['frames']:.3f} ms | multi2 {times['multi2']:.3f} | "
              f"multi4 {times['multi4']:.3f} | unfused chain "
              f"{unfused_ms:.3f} ms")
        print("[gate 1b] " + (
            f"FLIP: the fused kernel ({best}) beats the unfused chain at "
            f"{n_frames} frames — consider routing it into the model and A/B "
            "with bench featext" if flip else
            f"no-flip at {n_frames} frames: fused bottleneck stays a "
            "gate-only probe"))
        res[str(n_frames)] = {
            **{f"{k}_ms": round(v, 4) for k, v in times.items()},
            "unfused_ms": round(unfused_ms, 4), "least_bytes": moved,
            "flip": bool(flip)}
        del frames, ncthw, want
    return res


@contextmanager
def plain_gather():
    """Route beam search's cache reorder to the plain version (the A/B of
    the row-gather kernel inside the decode)."""
    from .gen import beam
    from .ops import beam_gather as B

    saved = beam.gather_rows
    beam.gather_rows = B.beam_gather_rows_reference
    try:
        yield
    finally:
        beam.gather_rows = saved


def gate_beam_gather(dev: torch.device, bs: int = 16) -> Dict:
    from .bench import REAL_TX, setup_decode
    from .models.selector import build_srl_generate_fn
    from .ops import beam_gather as B

    with tempfile.TemporaryDirectory(prefix="gate_beam_") as tmp:
        cfg, comm, model, batch = setup_decode(
            bs, dev, "bfloat16", Path(tmp), REAL_TX)
    cfg.gen.beam_size = 5
    cfg.tpu.ancestry_beam = False  # the route that reorders the cache
    gen = build_srl_generate_fn(cfg, comm, model)

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen.search(batch)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    gen.search(batch)  # warm-up
    before = B.LAUNCHES
    out_k, t_k = timed()
    launches = B.LAUNCHES - before
    with plain_gather():
        out_p, t_p = timed()
    worst = int((out_k.seqs != out_p.seqs).sum().item())
    ok = worst == 0 and launches == out_k.steps
    print(f"[gate 2] beam-5 decode, {bs} videos, {out_k.steps} steps: "
          f"kernel {t_k * 1e3:.1f} ms ({launches} launches) | index_select "
          f"{t_p * 1e3:.1f} ms | {worst} token mismatches")
    print("[gate 2] " + (
        "PASS: the row-gather kernel and index_select decode the same "
        "tokens — the reorder route keeps the kernel" if ok else
        f"FAIL: beam gather corrupts ({worst} token mismatches, {launches} "
        f"launches over {out_k.steps} steps)"))
    return {"worst_mismatches": worst, "launches": launches,
            "steps": out_k.steps, "kernel_ms": round(t_k * 1e3, 2),
            "index_select_ms": round(t_p * 1e3, 2), "pass": bool(ok)}


def gate_lane_padding() -> Dict:
    print("[gate 3] lane padding: not applicable on a GPU — the JAX gate "
          "counts XLA's batch-minor buffers padded to 128 TPU lanes; "
          "PyTorch keeps the clip batch outermost and pads nothing, so "
          "there is no cliff to re-check (the clip count is swept by "
          "`bench gates --batch`)")
    return {"applicable": False}


def gate_batch_optimum(dev: torch.device, default_clips: int = 32) -> Dict:
    from .bench import bench_slowfast_featext

    rates = {}
    for clips in (32, 64, 128):
        rates[clips] = bench_slowfast_featext(clips, 5, dev)["value"]
        torch.cuda.empty_cache()
        print(f"[gate 4] featext clips={clips}: {rates[clips]:.1f} clips/s")
    best = max(rates, key=rates.get)
    print(f"[gate 4] optimum: {best} clips ({rates[best]:.1f}); the default "
          f"is {default_clips} — " + (
              "no-flip" if best == default_clips
              else "FLIP: retune the extractor's clip_batch"))
    return {"rates": rates, "best_clips": best}


def main(batch: bool = False, device="cuda") -> Dict:
    dev = require_cuda(device)
    res = {
        "device": torch.cuda.get_device_name(dev),
        "copy_floor": gate_copy_floor(dev),
        "fused_bottleneck": gate_fused_bottleneck(dev),
        "beam_gather": gate_beam_gather(dev),
        "lane_padding": gate_lane_padding(),
    }
    if batch:
        res["batch"] = gate_batch_optimum(dev)
    return res
