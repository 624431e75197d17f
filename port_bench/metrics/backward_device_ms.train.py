"""Device time of the kernels launched inside the Learner's
``vidsitu.backward`` spans (``port_bench/spans.py``; autograd's thread
launches them while the main thread is in the span): the union of their
intervals in the traced stretch, per step. Silent where the program has no
such span. Moves ``train_videos_per_s``."""

from port_bench import spans as S

UNIT = "ms/step"


def read(ctx):
    if not S.readable(ctx):
        return None
    return S.per_step_ms(ctx.trace, S.device_s(ctx.trace).get(S.BACKWARD, 0.0))
