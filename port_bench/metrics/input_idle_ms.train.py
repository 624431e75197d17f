"""Device-idle time of the traced stretch (no kernel and no copy runs)
while the host is inside the Learner's ``vidsitu.input`` spans: the next
batch fetched, folded, pinned and sent (``port_bench/spans.py``), per step.
Silent where the program has no such span. Moves ``train_videos_per_s``."""

from port_bench import spans as S

UNIT = "ms/step"


def read(ctx):
    if not S.readable(ctx):
        return None
    return S.per_step_ms(ctx.trace, S.idle_s(ctx.trace).get(S.INPUT, 0.0))
