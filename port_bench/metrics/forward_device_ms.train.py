"""Device time of the kernels launched inside the Learner's
``vidsitu.forward`` spans (``port_bench/spans.py``): the union of their
intervals in the traced stretch, per step. Silent where the program has no
such span. Moves ``train_videos_per_s``."""

from port_bench import spans as S

UNIT = "ms/step"


def read(ctx):
    if not S.readable(ctx):
        return None
    return S.per_step_ms(ctx.trace, S.device_s(ctx.trace).get(S.FORWARD, 0.0))
