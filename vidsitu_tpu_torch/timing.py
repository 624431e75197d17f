"""Timing helpers for measurements on the card: CUDA events around queued
calls, one warm-up, medians; compared functions are timed in turns."""

from __future__ import annotations

import time
from typing import Callable, List, Sequence

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


def medians_in_turns(fns: Sequence[Callable[[], object]],
                     reps: int) -> List[float]:
    """Median ms of each function, timed in turns: once down the list, then
    once back up (a, b, c, c, b, a)."""
    times: List[List[float]] = [[] for _ in fns]
    order = list(range(len(fns)))
    for i in order + order[::-1]:
        times[i].extend(cuda_ms(fns[i], reps))
    return [float(np.median(t)) for t in times]


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


def kernel_rows(prof) -> list:
    """The device kernels of a ``torch.profiler`` run, by name: its CUDA
    rows without the user annotations (``Optimizer.step#Adam.step`` and the
    like), whose device span covers kernels already counted."""
    return [e for e in prof.key_averages() if e.device_type.name == "CUDA"
            and not getattr(e, "is_user_annotation", False)]
