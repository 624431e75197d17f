"""The stems' 2D form (vidsitu_tpu_torch/models/video_backbone.py): on CUDA
in bf16 / f16 a conv whose input channels are not a multiple of 8 (the
3-channel stems) runs as a 2D conv over the output frames, its temporal
taps side by side as channels, zero-padded (``folded_conv3d``); every other
conv, and every float32, float64 or CPU input, keeps ``F.conv3d``.

On the CPU, in float64 and float32: the folded conv against the plain one
at the three stem shapes of the benchmark's models, output and the
3-channel weight's gradient; the predicate as a pure function; whole tiny
backbones with the predicate made to hold on the CPU, against the same
backbones without it; the parameters, ``state_dict()`` and the no-grad
cache of the folded weight.
"""

import pytest
import torch
from torch.nn import functional as F

from vidsitu_tpu_torch.models import video_backbone as VB

torch.set_num_threads(1)

# (Cout, temporal kernel, frames, folded channels): I3D-NL's stem, SlowFast's
# slow and fast stems
STEMS = {"i3d": (64, 5, 8, 16), "slowfast_slow": (64, 1, 4, 4),
         "slowfast_fast": (8, 5, 8, 16)}
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _stem_conv(cout, kt, frames, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, frames, 18, 22, 3), generator=g, dtype=dtype)
    w = torch.randn((cout, 3, kt, 7, 7), generator=g, dtype=dtype)
    return x.permute(0, 4, 1, 2, 3), w.requires_grad_()


def _close(a, b, dtype):
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max()) <= RTOL[dtype] * float(b.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("stem", list(STEMS))
def test_the_folded_conv_is_the_plain_conv(stem, dtype):
    cout, kt, frames, channels = STEMS[stem]
    x, w = _stem_conv(cout, kt, frames, dtype)
    stride, padding = (1, 2, 2), (kt // 2, 3, 3)
    plain = F.conv3d(x, w, None, stride, padding)
    assert VB.folded_channels(3, kt) == channels
    folded = VB.folded_conv3d(x, VB.fold_weight(w, channels), None, kt,
                              stride, padding, (1, 1, 1))
    assert folded.shape == plain.shape
    assert folded.is_contiguous(memory_format=torch.channels_last_3d)
    assert _close(folded, plain, dtype)
    gy = torch.randn(plain.shape, generator=torch.Generator().manual_seed(1),
                     dtype=dtype)
    g_plain, = torch.autograd.grad(plain, w, gy)
    g_folded, = torch.autograd.grad(folded, w, gy)
    assert g_folded.shape == w.shape
    assert _close(g_folded, g_plain, dtype)


@pytest.mark.parametrize("stride,padding,dilation",
                         [((2, 1, 2), (1, 1, 1), (1, 1, 1)),
                          ((1, 1, 1), (2, 0, 1), (2, 1, 1)),
                          ((3, 2, 1), (0, 1, 0), (2, 2, 1))])
def test_the_fold_takes_the_conv3d_arguments(stride, padding, dilation):
    """A 5-channel, 3-tap conv at temporal strides, paddings and dilations
    that the stems do not use: the fold is the conv all the same."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, 9, 12, 13, 5), generator=g,
                    dtype=torch.float64).permute(0, 4, 1, 2, 3)
    w = torch.randn((4, 5, 3, 3, 3), generator=g, dtype=torch.float64)
    b = torch.randn(4, generator=g, dtype=torch.float64)
    plain = F.conv3d(x, w, b, stride, padding, dilation)
    folded = VB.folded_conv3d(x, VB.fold_weight(w, VB.folded_channels(5, 3)),
                              b, 3, stride, padding, dilation)
    assert VB.folded_channels(5, 3) == 16
    assert _close(folded, plain, torch.float64)


@pytest.mark.parametrize("device,dtype,channels,folds", [
    ("cuda", torch.bfloat16, 3, True),
    ("cuda", torch.float16, 3, True),
    ("cuda", torch.bfloat16, 5, True),
    ("cuda", torch.bfloat16, 8, False),
    ("cuda", torch.bfloat16, 64, False),
    ("cuda", torch.float16, 2048, False),
    ("cuda", torch.float32, 3, False),
    ("cuda", torch.float64, 3, False),
    ("cpu", torch.bfloat16, 3, False),
    ("cpu", torch.float32, 3, False),
])
def test_the_predicate(device, dtype, channels, folds):
    assert VB.folds_conv(device, dtype, channels) is folds


def _backbone(arch):
    cfg = VB.VideoCfg(arch=arch, depth_blocks=(1, 1, 1, 1))
    model = (VB.SlowFastBackbone(cfg) if arch == "slowfast"
             else VB.ResNet3DBackbone(cfg))
    torch.manual_seed(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bn.weight"):  # zero-initialised gammas
                p.uniform_(0.5, 1.0)
    return model.double().train()


def _inputs(arch):
    g = torch.Generator().manual_seed(4)
    fast = torch.randn((2, 8, 32, 32, 3), generator=g, dtype=torch.float64)
    if arch != "slowfast":
        return (fast.permute(0, 4, 1, 2, 3),)
    return (fast[:, ::4].permute(0, 4, 1, 2, 3), fast.permute(0, 4, 1, 2, 3))


def _as_on_cuda(monkeypatch):
    """The predicate as on a CUDA device in 16 bits, for CPU inputs."""
    monkeypatch.setattr(VB, "folds_conv",
                        lambda device, dtype, channels: channels % VB.TC_CHANNELS != 0)


@pytest.mark.parametrize("arch,stems", [("i3d", 1), ("slowfast", 2)])
def test_a_backbone_folds_its_stems_and_nothing_else(monkeypatch, arch, stems):
    plain_model = _backbone(arch)
    folded_model = _backbone(arch)
    folded_model.load_state_dict(plain_model.state_dict())
    shapes = {n: t.shape for n, t in plain_model.state_dict().items()}
    xs = _inputs(arch)

    def run(model):
        out = model(*xs)
        out = out if isinstance(out, torch.Tensor) else torch.cat(
            [o.flatten() for o in out])
        loss = (out * torch.linspace(-1, 1, out.numel(), dtype=out.dtype
                                     ).reshape(out.shape)).sum()
        loss.backward()
        return out

    VB.Conv3d.padded_calls = 0
    plain = run(plain_model)
    assert VB.Conv3d.padded_calls == 0
    _as_on_cuda(monkeypatch)
    folded = run(folded_model)
    assert VB.Conv3d.padded_calls == stems
    assert _close(folded, plain, torch.float64)
    stem_weights = [f"{n}.conv.conv.weight" for n, m in plain_model.named_modules()
                    if isinstance(m, VB.Stem)]
    assert len(stem_weights) == stems
    assert all(shapes[n][1] == 3 for n in stem_weights)
    grads = dict(folded_model.named_parameters())
    for n, p in plain_model.named_parameters():
        assert _close(grads[n].grad, p.grad, torch.float64), n
    # no parameter, buffer or state_dict() name is added, none changes shape
    assert {n: t.shape for n, t in folded_model.state_dict().items()} == shapes


def test_no_grad_keeps_the_folded_weight_until_the_parameter_changes(monkeypatch):
    _as_on_cuda(monkeypatch)
    conv = VB.Conv3d(3, 8, (5, 7, 7), stride=(1, 2, 2), padding=(2, 3, 3),
                     bias=False).double()
    x, _ = _stem_conv(8, 5, 6, torch.float64)
    with torch.no_grad():
        first = conv(x)
        kept = conv._cast_copy[0]
        assert kept.shape == (8, 16, 7, 7)
        assert torch.equal(conv(x), first)
        assert conv._cast_copy[0] is kept
        conv.weight.mul_(2)
        second = conv(x)
        assert conv._cast_copy[0] is not kept
        assert _close(second, F.conv3d(x, conv.weight, None, (1, 2, 2), (2, 3, 3)),
                      torch.float64)
    assert _close(second, 2 * first, torch.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_cpu_inputs_keep_the_plain_conv(dtype):
    conv = VB.Conv3d(3, 8, (1, 7, 7), stride=(1, 2, 2), padding=(0, 3, 3),
                     bias=False)
    x, _ = _stem_conv(8, 1, 2, torch.float32)
    VB.Conv3d.padded_calls = 0
    y = conv(x.to(dtype))
    assert VB.Conv3d.padded_calls == 0
    assert torch.equal(y, F.conv3d(x.to(dtype), conv.weight.to(dtype), None,
                                   (1, 2, 2), (0, 3, 3)))
