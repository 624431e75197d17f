"""The traced stretch split by the program's own spans: the Learner's
``vidsitu.input``, ``vidsitu.forward`` and ``vidsitu.backward`` scopes and
torch's ``Optimizer.step#Adam.step`` annotation, one of each a step, on the
host's threads of the Chrome trace (``trace.Trace.host``).

A kernel belongs to the phase whose span holds its launch record's
timestamp (``Trace.launch_ts``, on any thread: autograd launches the
backward's kernels from its own thread while the main thread sits in
``vidsitu.backward``). A kernel with no launch record takes the phase of the
kernel that ran just before it; one launched outside every span is
``other``. The device's idle gaps (no kernel and no copy, as
``Trace.idle_gaps`` has them) are split by the spans that cover them."""

from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict
from typing import Dict, List, Tuple

from .trace import ADAM, Interval, Trace, gaps, union_length

INPUT, FORWARD, BACKWARD = "vidsitu.input", "vidsitu.forward", "vidsitu.backward"
PHASES = (INPUT, FORWARD, BACKWARD, ADAM)
OTHER = "other"


def phase_spans(tr: Trace) -> List[Tuple[float, float, str]]:
    """The spans of the four phases, by start (a step's spans follow one
    another on the main thread and do not overlap)."""
    return sorted(h for h in tr.host if h[2] in PHASES)


def has_spans(tr: Trace) -> bool:
    """Whether the program put its spans in the trace (a program older
    than them has none, and the readers stay silent)."""
    return any(name.startswith("vidsitu.") for _, _, name in tr.host)


def kernel_phases(tr: Trace) -> List[Tuple[float, float, str, str, bool]]:
    """(start, end, name, phase, fell back) of every kernel of the trace, in
    device order; "fell back" marks a kernel with no launch record, which
    took the phase of the kernel before it."""
    spans = phase_spans(tr)
    heads = [a for a, _, _ in spans]
    out, prev = [], OTHER
    for a, b, name, corr in tr.kernels:
        t = tr.launch_ts.get(corr)
        if t is None:
            out.append((a, b, name, prev, True))
            continue
        i = bisect_right(heads, t) - 1
        prev = spans[i][2] if i >= 0 and t <= spans[i][1] else OTHER
        out.append((a, b, name, prev, False))
    return out


def device_s(tr: Trace) -> Dict[str, float]:
    """Seconds of the stretch in which a kernel of each phase runs: the
    union of the phase's kernel intervals, clipped to the stretch."""
    by: Dict[str, List[Interval]] = defaultdict(list)
    for a, b, _, phase, _ in kernel_phases(tr):
        by[phase].append((a, b))
    return {p: union_length(iv, *tr.window) for p, iv in by.items()}


def idle_gaps(tr: Trace) -> List[Interval]:
    """The intervals of the traced stretch in which neither a kernel nor a
    copy runs."""
    ops = [(a, b) for a, b, *_ in tr.kernels] + [(a, b) for a, b, _ in tr.copies]
    return gaps(ops, *tr.window)


def idle_s(tr: Trace) -> Dict[str, float]:
    """Seconds of the stretch in which neither a kernel nor a copy runs,
    by the phase span that covers them; idle time under no span is not
    counted."""
    spans = phase_spans(tr)
    heads = [a for a, _, _ in spans]
    by: Dict[str, float] = defaultdict(float)
    for ga, gb in idle_gaps(tr):
        # back from the last span that starts before the gap ends, while
        # the spans (ordered, disjoint) still reach into the gap
        for i in range(bisect_right(heads, gb) - 1, -1, -1):
            a, b, phase = spans[i]
            if b <= ga:
                break
            by[phase] += min(b, gb) - max(a, ga)
    return dict(by)


def readable(ctx) -> bool:
    """Whether a reader of this module has something to read: a train
    job's stretch of whole steps, with the program's spans in it."""
    return ctx.job == "train" and ctx.trace.steps > 0 and has_spans(ctx.trace)


def per_step_ms(tr: Trace, seconds: float) -> float:
    return 1e3 * seconds / tr.steps


def report(tr: Trace, top: int = 8) -> Dict:
    """How whole the split is, for a trace of the chip: the share of the
    stretch's kernel busy time that the four phases hold, the time of
    kernels that fell back or fell outside every phase, where the
    attention kernels (``nl_attn*``) landed, each phase's device and idle
    time a step beside the stretch's whole idle time, and each phase's
    ``top`` kernels by time."""
    lo, hi = tr.window
    kp = [k for k in kernel_phases(tr) if k[1] > lo and k[0] < hi]
    busy = tr.kernel_busy_s()
    in_phases = union_length([(a, b) for a, b, _, p, _ in kp if p != OTHER], lo, hi)
    fell_back: Dict[str, float] = defaultdict(float)
    attn: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for a, b, name, phase, fb in kp:
        t = min(b, hi) - max(a, lo)
        by_name[phase][name[:120]] += t
        if fb:
            fell_back[phase] += t
        if "nl_attn" in name:
            attn[phase + (" (fell back)" if fb else "")] += t
    idle = sum(b - a for a, b in idle_gaps(tr))
    return {
        "steps": tr.steps, "stretch_s": hi - lo, "kernel_busy_s": busy,
        "phases_share_of_kernel_busy": in_phases / busy if busy else None,
        "device_ms_per_step": {p: per_step_ms(tr, s) for p, s in device_s(tr).items()},
        "idle_ms_per_step": {p: per_step_ms(tr, s) for p, s in idle_s(tr).items()},
        "stretch_idle_ms_per_step": per_step_ms(tr, idle),
        "fell_back_s": dict(fell_back), "nl_attn_s": dict(attn),
        "spans": {p: sum(1 for *_, n in phase_spans(tr) if n == p) for p in PHASES},
        "top_kernels_ms_per_step": {
            p: [[k, per_step_ms(tr, v)] for k, v in sorted(
                names.items(), key=lambda kv: -kv[1])[:top]]
            for p, names in by_name.items()},
    }


def main(argv=None) -> int:
    """``python -m port_bench.spans <chrome trace>...``: one JSON line of
    :func:`report` a trace (the traced runs leave theirs under
    ``.port_bench_runs/``)."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description="the traced stretch split by the spans")
    ap.add_argument("traces", nargs="+")
    for path in ap.parse_args(argv).traces:
        with open(path) as f:
            tr = Trace(json.load(f)["traceEvents"])
        out = report(tr) if tr.window is not None else None
        print(json.dumps({"trace": path, "report": out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
