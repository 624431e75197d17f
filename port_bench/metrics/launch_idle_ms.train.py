"""Device-idle time of the traced stretch (no kernel and no copy runs)
while the host is inside the Learner's ``vidsitu.forward`` or
``vidsitu.backward`` spans or the optimizer's ``Optimizer.step#Adam.step``
annotation, launching the step's work (``port_bench/spans.py``), per step.
Silent where the program has no such span. Moves ``train_videos_per_s``."""

from port_bench import spans as S

UNIT = "ms/step"


def read(ctx):
    if not S.readable(ctx):
        return None
    idle = S.idle_s(ctx.trace)
    return S.per_step_ms(ctx.trace, sum(idle.get(p, 0.0) for p in
                                        (S.FORWARD, S.BACKWARD, S.ADAM)))
