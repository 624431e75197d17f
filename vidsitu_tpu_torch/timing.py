"""Timing helpers for measurements on the card: CUDA events around queued
calls, one warm-up, medians; compared functions are timed in turns."""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import numpy as np
import torch


def cuda_ms(fn: Callable[[], object], reps: int) -> List[float]:
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


def interleaved_medians(fn_a, fn_b, reps: int) -> Tuple[float, float]:
    """Median ms of two functions timed in turns a, b, b, a."""
    times = {fn_a: [], fn_b: []}
    for pair in ((fn_a, fn_b), (fn_b, fn_a)):
        for fn in pair:
            times[fn].extend(cuda_ms(fn, reps))
    return float(np.median(times[fn_a])), float(np.median(times[fn_b]))


def call_ms(fn: Callable[[], object], reps: int, device) -> List[float]:
    """Per-call times (ms) of ``fn`` on ``device`` after one warm-up: CUDA
    events on a GPU; the host clock on the CPU, where ``fn`` returns when
    its work is done."""
    if torch.device(device).type == "cuda":
        return cuda_ms(fn, reps)
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times
