"""The stretch split by the program's spans (``port_bench/spans.py``) and
its four readers, on made-up events: kernels put in the phase whose span
holds their launch record, on any thread; a kernel without one after the
kernel before it; idle gaps split by the spans over them; everything
clipped to the stretch; silence on a trace without the spans."""

import pytest

from port_bench import spans as S
from port_bench import trace as T
from port_bench.harness import read_metrics

MAIN, AUTOGRAD = 1, 2
NEW = ("forward_device_ms.train", "backward_device_ms.train",
       "input_idle_ms.train", "launch_idle_ms.train")


def _x(name, cat, ts_us, dur_us, tid=MAIN, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts_us, "dur": dur_us,
            "tid": tid, "args": args}


def _span(name, a, b):
    return _x(name, "user_annotation", a, b - a)


def _kernel(name, a, b, corr, launched=None, tid=MAIN):
    """A kernel on the device over [a, b] us and, at ``launched``, its
    launch record on thread ``tid`` (none where ``launched`` is None)."""
    out = [_x(name, "kernel", a, b - a, correlation=corr)]
    if launched is not None:
        out.append(_x("cudaLaunchKernel", "cuda_runtime", launched, 1, tid=tid,
                      correlation=corr))
    return out


def _events():
    """Two steps between step-end copies at 100, 200 and 300 us.

    Before the stretch: a forward span 85-95 whose kernel runs 96-104, 4 us
    of it inside. Step 1: input 102-125 (host-to-device copy 110-118),
    forward 125-150 (a kernel 128-140, one 140-145 with no launch record),
    backward 150-175 (autograd's thread launches a kernel 160-185 and the
    attention backward 185-190), Adam 176-180 (a kernel 190-195). Step 2:
    input 205-230, forward 230-250 (a kernel 240-260), a kernel launched at
    255 under no span (260-270), backward 256-280 (270-290), Adam 281-285
    (290-295). After the stretch: a forward kernel 310-320."""
    ev = [_x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", a, 5)
          for a in (95, 195, 295)]
    ev.append(_x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 110, 8))
    ev += [_span(S.FORWARD, 85, 95), _span(S.INPUT, 102, 125),
           _span(S.FORWARD, 125, 150), _span(S.BACKWARD, 150, 175),
           _span(T.ADAM, 176, 180), _span(S.INPUT, 205, 230),
           _span(S.FORWARD, 230, 250), _span(S.BACKWARD, 256, 280),
           _span(T.ADAM, 281, 285), _span(S.FORWARD, 305, 315)]
    ev += _kernel("conv_fwd", 96, 104, 1, launched=90)
    ev += _kernel("conv_fwd", 128, 140, 2, launched=126)
    ev += _kernel("bn_fwd", 140, 145, 3)
    ev += _kernel("conv_wgrad", 160, 185, 4, launched=152, tid=AUTOGRAD)
    ev += _kernel("nl_attn_bwd_wgmma_kernel", 185, 190, 5, launched=170, tid=AUTOGRAD)
    ev += _kernel("multi_tensor_apply_kernel", 190, 195, 6, launched=177)
    ev += _kernel("conv_fwd", 240, 260, 7, launched=232)
    ev += _kernel("fill", 260, 270, 8, launched=255)
    ev += _kernel("conv_dgrad", 270, 290, 9, launched=258, tid=AUTOGRAD)
    ev += _kernel("multi_tensor_apply_kernel", 290, 295, 10, launched=282)
    ev += _kernel("conv_fwd", 310, 320, 11, launched=306)
    return ev


def _trace(drop=()):
    return T.Trace([e for e in _events() if e["name"] not in drop])


def _phases(tr):
    """{(start in us, kernel name): (phase, fell back)}."""
    return {(round(a * 1e6), name): (phase, fb)
            for a, _, name, phase, fb in S.kernel_phases(tr)}


def test_kernels_take_the_phase_of_their_launch_on_any_thread():
    by = _phases(_trace())
    assert by[(128, "conv_fwd")] == (S.FORWARD, False)
    # launched from autograd's thread while the main thread is in backward
    assert by[(160, "conv_wgrad")] == (S.BACKWARD, False)
    assert by[(185, "nl_attn_bwd_wgmma_kernel")] == (S.BACKWARD, False)
    assert by[(190, "multi_tensor_apply_kernel")] == (T.ADAM, False)
    assert by[(260, "fill")] == (S.OTHER, False)


def test_a_kernel_without_a_launch_record_takes_the_phase_before_it():
    by = _phases(_trace())
    assert by[(140, "bn_fwd")] == (S.FORWARD, True)
    # the first kernel of a trace has no kernel before it
    first = [e for e in _events() if not (e["cat"] == "cuda_runtime"
                                          and e["args"]["correlation"] == 1)]
    assert S.kernel_phases(T.Trace(first))[0][3:] == (S.OTHER, True)


def test_device_time_by_phase_is_clipped_to_the_stretch():
    tr = _trace()
    dev = S.device_s(tr)
    # 100-104 of the kernel that began before the stretch, 128-145, 240-260;
    # not the kernel at 310 after it
    assert dev[S.FORWARD] == pytest.approx(41e-6)
    assert dev[S.BACKWARD] == pytest.approx(50e-6)
    assert dev[T.ADAM] == pytest.approx(10e-6)
    assert dev[S.OTHER] == pytest.approx(10e-6)
    assert sum(dev.values()) == pytest.approx(tr.kernel_busy_s())


def test_idle_gaps_are_split_by_the_spans_over_them():
    tr = _trace()
    idle = S.idle_s(tr)
    # gaps (no kernel, no copy): 104-110, 118-128, 145-160, 200-240
    assert idle[S.INPUT] == pytest.approx((6 + 7 + 25) * 1e-6)
    assert idle[S.FORWARD] == pytest.approx((3 + 5 + 10) * 1e-6)
    assert idle[S.BACKWARD] == pytest.approx(10e-6)
    assert T.ADAM not in idle
    # 200-205 lies under no span: in neither idle metric
    assert sum(b - a for a, b in S.idle_gaps(tr)) == pytest.approx(71e-6)
    assert sum(idle.values()) == pytest.approx(66e-6)


def test_the_four_readers_per_step():
    m = {k: v for k, (v, _) in read_metrics("train", _trace(), {
        "flops_per_step": 1.0, "attn_least_s_per_step": 1e-6}).items()}
    assert m["forward_device_ms.train"] == pytest.approx(41e-3 / 2)
    assert m["backward_device_ms.train"] == pytest.approx(50e-3 / 2)
    assert m["input_idle_ms.train"] == pytest.approx(38e-3 / 2)
    assert m["launch_idle_ms.train"] == pytest.approx(28e-3 / 2)
    assert not set(NEW) & set(read_metrics("another_job", _trace(), {}))


def test_a_trace_without_the_programs_spans_leaves_the_readers_silent():
    """The parent commit's program: torch's Adam annotation, no spans of
    its own; the accepted readers still read."""
    tr = _trace(drop=(S.INPUT, S.FORWARD, S.BACKWARD))
    assert not S.has_spans(tr)
    m = read_metrics("train", tr, {"flops_per_step": 1.0, "attn_least_s_per_step": 1e-6})
    assert not set(NEW) & set(m)
    assert {"device_idle_share.train", "mfu.train", "adam_device_ms.train"} <= set(m)


def test_the_report_says_how_whole_the_split_is():
    r = S.report(_trace())
    assert r["steps"] == 2
    # 111 us of kernels in the stretch, 10 of them launched under no span
    assert r["kernel_busy_s"] == pytest.approx(111e-6)
    assert r["phases_share_of_kernel_busy"] == pytest.approx(101 / 111)
    assert r["fell_back_s"] == {S.FORWARD: pytest.approx(5e-6)}
    assert r["nl_attn_s"] == {S.BACKWARD: pytest.approx(5e-6)}
    assert r["stretch_idle_ms_per_step"] == pytest.approx(71e-3 / 2)
    assert r["spans"] == {S.INPUT: 2, S.FORWARD: 4, S.BACKWARD: 2, T.ADAM: 2}
    assert r["top_kernels_ms_per_step"][S.FORWARD] == [
        ["conv_fwd", pytest.approx(36e-3 / 2)], ["bn_fwd", pytest.approx(5e-3 / 2)]]
