"""Device time of the kernels launched inside the stems' ``vidsitu.stem``
spans (``Stem.forward`` in the port's ``models/video_backbone.py``, nested
in ``vidsitu.forward``; one a stem and forward): the union of their
intervals in the traced stretch, per step. A kernel counts where its launch
record, on any thread, lies inside a stem span. Silent where the program
has no such span. Moves ``train_videos_per_s``."""

from bisect import bisect_right

from port_bench import spans as S
from port_bench.trace import union_length

UNIT = "ms/step"
STEM = "vidsitu.stem"


def read(ctx):
    if not S.readable(ctx):
        return None
    tr = ctx.trace
    stems = sorted((a, b) for a, b, name in tr.host if name == STEM)
    if not stems:
        return None
    heads = [a for a, _ in stems]
    hit = []
    for a, b, _, corr in tr.kernels:
        t = tr.launch_ts.get(corr)
        if t is None:
            continue
        i = bisect_right(heads, t) - 1
        if i >= 0 and t <= stems[i][1]:
            hit.append((a, b))
    return S.per_step_ms(tr, union_length(hit, *tr.window))
