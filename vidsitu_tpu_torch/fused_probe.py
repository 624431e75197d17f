"""Quick probe of the fused bottleneck's kernels on the card: build, check,
time. The short loop for work on ``csrc/fused_bottleneck.cu``; the whole
picture (every shape and type, the gates, the library yardsticks) is
``chip_smoke.py`` phase 12 and ``bench gates``.

    python -m vidsitu_tpu_torch.fused_probe          # one GPU

It builds the source and prints the compiler's registers and spills; holds
the routed (wgmma) entries of both wrappers and the first kernel's entry
against the plain version at small and real shapes, among them 67 and 261
frames in groups of 1 to 7 (more steps than thread blocks, block runs that
start inside a group and cross into the next one); then times, at slow-s2
(56x56, 256 -> 64 -> 256, bf16) for 256 and 960 frames, the two routed entries
and the first kernel's in turns, one call at a time and ten calls queued back
to back (device time without the wrapper's host time). Exits non-zero on a
disagreement. Seeded inputs; needs a GPU and nvcc.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .ops import _build
from .ops import fused_bottleneck as FB
from .timing import cuda_ms, medians_in_turns

# (frames, H, W, C = Cin = Cout) at Cmid 64, bf16, no projection
CHECKS = ((1, 5, 7, 128), (3, 12, 12, 128), (5, 7, 61, 256), (8, 56, 56, 256),
          (67, 56, 56, 256), (261, 56, 56, 256))
GROUPS = (1, 2, 3, 4, 7)  # frames_per_step of the multi-frame wrapper
TOL = 5e-2                # of the output scale, bf16
QUEUED = 10
FIRST = "fused_bottleneck_frames"  # the first kernel's per-frame entry


def operands(rng, c: int, dev):
    """Folded weights (std fan_in**-0.5) and positive float32 shifts."""
    def weight(*shape):
        fan_in = int(np.prod(shape[:-1]))
        return torch.from_numpy((rng.standard_normal(shape) * fan_in ** -0.5)
                                .astype(np.float32)).to(dev, torch.bfloat16)

    def shift(n):
        return torch.from_numpy((0.3 + 0.1 * rng.standard_normal((1, n)))
                                .astype(np.float32)).to(dev)

    return [weight(c, 64), shift(64), weight(3, 3, 64, 64), shift(64),
            weight(64, c), shift(c)]


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(dev), flush=True)
    _build.build("fused_bottleneck")
    log = (_build.BUILD_DIR / "fused_bottleneck.log").read_text()
    for line in log.splitlines():
        if any(word in line for word in ("Used", "spill", "C75", "arning")):
            print("ptxas:", line.strip()[:200])

    rng = np.random.default_rng(0)
    ok = True
    for b, h, w, c in CHECKS:
        ops = operands(rng, c, dev)
        x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(
            np.float32)).to(dev, torch.bfloat16)
        want = FB.fused_bottleneck_plain(x, *ops).float()
        limit = TOL * want.abs().max().item()
        runs = {"frames": lambda: FB.fused_bottleneck_frames(x, *ops),
                FIRST: lambda: FB.fused_bottleneck_frames(
                    x, *ops, entry=FIRST)}
        for fps in GROUPS:
            runs[f"multi fps={fps}"] = lambda fps=fps: (
                FB.fused_bottleneck_multi(x, *ops, frames_per_step=fps))
        for name, fn in runs.items():
            errs = []
            for _ in range(2):  # a race shows in some launches only
                got = fn().float()
                torch.cuda.synchronize()
                errs.append((got - want).abs().max().item())
            good = max(errs) <= limit
            ok = ok and good
            print(f"{b}x{h}x{w}x{c} {name}: max_abs_err {max(errs):.3e} "
                  f"(limit {limit:.3e}) {'ok' if good else 'FAIL'}", flush=True)
    print("launches by entry:", FB.LAUNCHES_BY_ENTRY)
    if not ok:
        return 1

    ops = operands(rng, 256, dev)
    for b in (256, 960):
        x = torch.randn((b, 56, 56, 256), device=dev).to(torch.bfloat16)
        fns = [lambda: FB.fused_bottleneck_frames(x, *ops),
               lambda: FB.fused_bottleneck_multi(x, *ops, frames_per_step=4),
               lambda: FB.fused_bottleneck_frames(x, *ops, entry=FIRST)]
        call = medians_in_turns(fns, 5)
        queued = [float(np.median(cuda_ms(
            lambda fn=fn: [fn() for _ in range(QUEUED)], 5))) / QUEUED
            for fn in fns]
        print(f"{b} frames, ms a call | queued x{QUEUED}: frames "
              f"{call[0]:.3f} | {queued[0]:.3f}, multi fps=4 {call[1]:.3f} | "
              f"{queued[1]:.3f}, {FIRST} {call[2]:.3f} | {queued[2]:.3f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
