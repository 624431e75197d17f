"""3D-CNN video backbones in PyTorch: ResNet3D (c2d / i3d / slow) and
SlowFast.

Port of vidsitu_tpu/models/video_backbone.py, which re-implements the
SlowFast-package backbones the reference wraps (mdl_sf_base.py:20-62).

  * Both modes, as flax's ``train`` flag: ``eval()`` normalizes with the
    running statistics; ``train()`` with the batch statistics (biased
    variance, reduced in float32 unless ``bn_f32_stats`` is off) and updates
    the running ones as flax does, ``ra <- 0.9 ra + 0.1 batch``, the biased
    variance included (:class:`BatchNorm3d`). Under a process group of
    several ranks the batch statistics are the global batch's, as in the JAX
    package's one program over the global batch.
  * Parameters stay in their own dtype (``train.param_dtype``, applied by
    ``common.cast_params``) and products run in the compute dtype: each
    conv casts its weight to its input's dtype, as flax's ``dtype`` /
    ``param_dtype`` split does; BatchNorm takes its scale and bias in
    float32 (flax promotes them to its float32 statistics) and keeps its
    running statistics in float32.
  * ``remat`` / ``remat_stages`` checkpoint the bottlenecks (and, for
    ``stem``, the stems) with ``torch.utils.checkpoint``; the recomputation
    in the backward does not update the running statistics a second time.
  * Public tensors keep the JAX layout, (B, T, H, W, C) frames, and the
    non-local token order (t, h, w). Inside, activations are (B, C, T, H, W)
    tensors; the entry points hand them over as channels-last views, so a
    model moved with ``memory_format=torch.channels_last_3d`` runs NDHWC
    end to end.
  * Submodule names follow the flax tree (``s3.block_1.a.conv``,
    ``s3.nl_1.theta``, ...), so flax variables map onto ``state_dict()`` by
    a rename and a transpose (convert/from_flax.py).
  * The JAX package's packed stem conv and packed stem epilogue fill TPU
    lanes; here the stem is a plain Conv3d on the same canonical weight.
    On CUDA in bf16 / f16 it runs as a 2D conv with its temporal taps
    folded into zero-padded channels (:func:`folded_conv3d`): cuDNN runs a
    3-channel 3D conv in float32, off the tensor cores.
  * Under ``torch.use_deterministic_algorithms`` a CUDA training step
    repeats bit for bit: the stem's max pool, whose CUDA backward PyTorch
    names nondeterministic, then runs as two one-axis pools
    (:func:`repeatable_stem_pool`). They cost the I3D-NL R50 update at 80
    clips 3.6 % and 2.4 GiB on an H100 (``release_probe stem``), so the
    one-pass pool stays the default.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..ops.attention import nonlocal_attention
from ..parallel.collectives import data_group, data_world_size

# Per-stage temporal-kernel PATTERNS (PySlowFast _TEMPORAL_KERNEL_BASIS):
# stem + res2..res5; a stage's pattern is tiled across its blocks.
TEMPORAL_KERNELS = {
    "c2d": {"fast": [(1,), (1,), (1,), (1,), (1,)]},
    "i3d": {"fast": [(5,), (3,), (3, 1), (3, 1), (1, 3)]},
    "slow": {"fast": [(1,), (1,), (1,), (3,), (3,)]},
    "slowfast": {
        "slow": [(1,), (1,), (1,), (3,), (3,)],
        "fast": [(5,), (3,), (3,), (3,), (3,)],
    },
}

# temporal pool after s2 (SlowFast _POOL1): i3d/c2d pool T by 2
TEMPORAL_POOL = {"c2d": 2, "i3d": 2, "slow": 1, "slowfast": 1}

BN_EPS = 1e-5  # flax BatchNorm's epsilon in the JAX package
BN_MOMENTUM = 0.9  # flax's: running <- 0.9 running + 0.1 batch

_STAGE_OUT = [256, 512, 1024, 2048]
_STAGE_INNER = [64, 128, 256, 512]


@dataclass(frozen=True)
class VideoCfg:
    arch: str = "slowfast"
    depth_blocks: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    alpha: int = 4
    beta_inv: int = 8
    fusion_ratio: int = 2
    fusion_kernel: int = 7
    spatial_strides: Tuple[int, ...] = (1, 2, 2, 2)
    nl_location: Tuple[Tuple[Tuple[int, ...], ...], ...] = ((), (), (), ())
    nl_instantiation: str = "softmax"
    mean: tuple = (0.45, 0.45, 0.45)
    std: tuple = (0.225, 0.225, 0.225)
    # frames arriving on device are already channel-reversed host-side
    # (pack_pathways); the reference normalizes BEFORE reversing
    # (dat_loader.py:478-484), so normalizing reversed uint8 frames must
    # use reversed mean/std
    reverse_input_channel: bool = False
    dtype: torch.dtype = torch.float32
    zero_init_final_bn: bool = True
    remat: bool = False  # checkpoint every bottleneck
    # stage indices (0..3 = s2..s5, -1 = the stems) whose blocks checkpoint
    remat_stages: Tuple[int, ...] = ()
    # False: BatchNorm's batch statistics reduce in the compute dtype
    bn_f32_stats: bool = True

    @classmethod
    def from_cfg(cls, vid_mdl, dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_stages: str = "",
                 bn_f32_stats: bool = True):
        # remat_stages: "s2,s3" / "0,1" -> stage indices 0..3; "stem" / "s1"
        # -> -1 (the JAX package's VideoCfg.from_cfg)
        stages = []
        for tok in str(remat_stages or "").replace(" ", "").split(","):
            if tok in ("stem", "s1"):
                stages.append(-1)
            elif tok:
                stages.append(int(tok[1:]) - 2 if tok.startswith("s")
                              else int(tok))
        # 26 is a 1-block-per-stage bottleneck variant for fast tests
        depth_map = {26: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
        return cls(
            arch=vid_mdl.arch,
            depth_blocks=depth_map[vid_mdl.resnet.depth],
            width=vid_mdl.resnet.width_per_group,
            alpha=vid_mdl.slowfast.alpha,
            beta_inv=vid_mdl.slowfast.beta_inv,
            fusion_ratio=vid_mdl.slowfast.fusion_conv_channel_ratio,
            fusion_kernel=vid_mdl.slowfast.fusion_kernel_sz,
            spatial_strides=tuple(s[0] for s in vid_mdl.resnet.spatial_strides),
            nl_location=tuple(
                tuple(tuple(p) for p in stage_loc)
                for stage_loc in vid_mdl.nl.location
            ),
            nl_instantiation=vid_mdl.nl.instantiation,
            mean=tuple(vid_mdl.mean),
            std=tuple(vid_mdl.std),
            reverse_input_channel=bool(vid_mdl.reverse_input_channel),
            dtype=dtype,
            zero_init_final_bn=bool(vid_mdl.resnet.zero_init_final_bn),
            remat=bool(remat),
            remat_stages=tuple(stages),
            bn_f32_stats=bool(bn_f32_stats),
        )


# cuDNN runs a 16-bit channels-last 3D conv with 3 input channels (the
# stems) on a float32 NCHW kernel, off the tensor cores, and zero-padding the
# channels to 4 or 8 keeps it there (an H100, cuDNN 9.2); its 2D convs take
# such inputs on the tensor cores. So the stems run as 2D convs over the
# output frames: the temporal taps side by side as channels, zero-padded to a
# multiple of FOLD_CHANNELS (4: the 1x7x7 stem's 2D conv is as fast at 3 and
# 4 channels and slower at 8; the 5x7x7 stems' 15 go to 16). Each added
# product is zero times zero.
# TC_CHANNELS: the channel multiple cuDNN's 16-bit 3D convs take on the
# tensor cores; every conv but the stems' has it.
TC_CHANNELS = 8
FOLD_CHANNELS = 4


def folds_conv(device_type: str, dtype: torch.dtype, channels: int) -> bool:
    """Whether :class:`Conv3d` runs a conv of ``channels`` input channels in
    ``dtype`` on a ``device_type`` device as :func:`folded_conv3d`."""
    return (device_type == "cuda" and dtype in (torch.bfloat16, torch.float16)
            and channels % TC_CHANNELS != 0)


def folded_channels(in_channels: int, kt: int) -> int:
    """Channels of a folded frame: ``kt`` taps of ``in_channels``, rounded
    up to a multiple of ``FOLD_CHANNELS``."""
    return -(-in_channels * kt // FOLD_CHANNELS) * FOLD_CHANNELS


def fold_weight(w: torch.Tensor, channels: int) -> torch.Tensor:
    """(Cout, C, kt, kh, kw) -> (Cout, ``channels``, kh, kw), channels-last:
    input channel ``i * C + c`` is tap ``i`` of channel ``c``, zeros past
    ``kt * C``."""
    co, c, kt, kh, kw = w.shape
    w2 = w.permute(0, 3, 4, 2, 1).reshape(co, kh, kw, kt * c)
    return F.pad(w2, (0, channels - kt * c)).permute(0, 3, 1, 2)


def fold_frames(x: torch.Tensor, kt: int, stride: int, padding: int,
                dilation: int, channels: int) -> torch.Tensor:
    """(N, C, T, H, W) -> (N * To, ``channels``, H, W), channels-last: output
    frame ``t`` holds input frames ``t * stride - padding + i * dilation``
    (``i`` < ``kt``; zeros outside T) side by side in :func:`fold_weight`'s
    channel order, zeros past ``kt * C``."""
    n, c, _, h, w = x.shape
    v = x.permute(0, 2, 3, 4, 1)
    if padding:
        v = F.pad(v, (0, 0, 0, 0, 0, 0, padding, padding))
    taps = v.unfold(1, (kt - 1) * dilation + 1, stride)[..., ::dilation]
    to = taps.shape[1]
    out = v.new_zeros((n, to, h, w, channels))
    out[..., :kt * c].unflatten(-1, (kt, c)).copy_(taps.transpose(-1, -2))
    return out.view(n * to, h, w, channels).permute(0, 3, 1, 2)


def folded_conv3d(x: torch.Tensor, weight: torch.Tensor, bias, kt: int,
                  stride, padding, dilation) -> torch.Tensor:
    """``F.conv3d(x, w, bias, stride, padding, dilation)`` (one group) as a
    2D conv of :func:`fold_frames` and ``weight = fold_weight(w, ...)``;
    the output is a channels-last (N, Cout, To, Ho, Wo) view."""
    n = x.shape[0]
    frames = fold_frames(x, kt, stride[0], padding[0], dilation[0],
                         weight.shape[1])
    y = F.conv2d(frames, weight, bias, stride[1:], padding[1:], dilation[1:])
    _, co, ho, wo = y.shape
    return y.permute(0, 2, 3, 1).reshape(n, -1, ho, wo, co).permute(0, 4, 1, 2, 3)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` whose weight and bias are cast to the input's dtype:
    parameters keep their own dtype, products run in the compute dtype
    (flax ``param_dtype`` / ``dtype``). Under autograd the cast is part of
    the graph at each call; without it (inference) the cast copy is kept
    until the parameter changes, so that a forward costs no casts.

    Where :func:`folds_conv` holds the conv runs as
    :func:`folded_conv3d` (the folded weight cast and kept as the cast copy
    is); ``padded_calls`` counts those calls, whose folded frames are the
    input with its channels zero-padded."""

    _cast_key = None
    padded_calls = 0

    def _cast(self, dtype: torch.dtype, channels=None):
        """Weight and bias in ``dtype``, the weight folded to ``channels``
        (:func:`fold_weight`) where given."""
        w, b = self.weight, self.bias
        if w.dtype == dtype and channels is None:
            return w, b
        fold = (lambda t: t) if channels is None else (
            lambda t: fold_weight(t, channels))
        if torch.is_grad_enabled():
            return fold(w.to(dtype)), None if b is None else b.to(dtype)
        key = (dtype, channels, w.device, w._version, w.data_ptr(),
               None if b is None else (b._version, b.data_ptr()),
               torch.is_inference_mode_enabled())
        if self._cast_key != key:
            self._cast_copy = (fold(w.detach().to(dtype)),
                               None if b is None else b.detach().to(dtype))
            self._cast_key = key
        return self._cast_copy

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (self.groups == 1 and self.padding_mode == "zeros"
                and folds_conv(x.device.type, x.dtype, x.shape[1])):
            Conv3d.padded_calls += 1
            kt = self.kernel_size[0]
            weight, bias = self._cast(x.dtype, folded_channels(x.shape[1], kt))
            return folded_conv3d(x, weight, bias, kt, self.stride,
                                 self.padding, self.dilation)
        weight, bias = self._cast(x.dtype)
        return self._conv_forward(x, weight, bias)


# set while torch.utils.checkpoint recomputes a block in the backward
_REMAT = threading.local()


@contextlib.contextmanager
def _recomputing():
    prev = getattr(_REMAT, "active", False)
    _REMAT.active = True
    try:
        yield
    finally:
        _REMAT.active = prev


def _remat_contexts():
    return contextlib.nullcontext(), _recomputing()


def run_remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward instead of kept, and the
    BatchNorms of the recomputation leave the running statistics alone
    (flax's ``nn.remat`` is functional: one update a step)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=_remat_contexts)


class BatchNorm3d(nn.BatchNorm3d):
    """flax ``nn.BatchNorm`` over (B, C, T, H, W), momentum 0.9.

    eval: the running statistics. train: the batch mean and the biased batch
    variance, reduced in float32 (``f32_stats``) or in the input's dtype;
    the output is in the input's dtype; the running statistics take
    ``0.9 ra + 0.1 batch`` with the biased variance (``nn.BatchNorm3d``
    alone would take the unbiased one), except while a remat block is
    recomputed. ``zero_init``: flax's ``scale_init`` is zeros here.

    Under a process group of several ranks (``torch.distributed``), the
    batch statistics are those of the data group's batches together (every
    rank's; under a ``model`` axis, the ranks that split the batch)
    (:meth:`_global_stats`); one rank computes what one process does."""

    def __init__(self, features: int, zero_init: bool = False,
                 f32_stats: bool = True):
        super().__init__(features, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)
        self.zero_init = zero_init
        self.f32_stats = f32_stats

    def _affine(self):
        """Scale and bias promoted to at least float32, as flax's
        ``_normalize`` promotes a ``param_dtype`` scale to its statistics'
        dtype (no copy for float32 or float64 parameters)."""
        acc = torch.promote_types(self.weight.dtype, torch.float32)
        return self.weight.to(acc), self.bias.to(acc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                *self._affine(), False, 0.0, self.eps)
        update = not getattr(_REMAT, "active", False)
        if data_world_size() > 1:
            return self._global_stats(x, update)
        if not self.f32_stats:
            return self._low_precision_stats(x, update)
        # the op updates copies (autograd keeps them, and a recomputation
        # saves the same tensors); the buffers take the result, the
        # variance's part rescaled from unbiased to biased
        n = x.numel() // x.shape[1]
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, *self._affine(), True,
                         self.momentum, self.eps)
        if update:
            with torch.no_grad():
                fresh = var - BN_MOMENTUM * self.running_var
                self.running_var.mul_(BN_MOMENTUM).add_(fresh * ((n - 1) / n))
                self.running_mean.copy_(mean)
        return y

    def _global_stats(self, x: torch.Tensor, update: bool):
        """flax's statistics over the global batch: each rank's per-channel
        sums of x and x^2 and its count, all-reduced with autograd (whose
        backward sums the ranks' gradients, so the gradient through the
        statistics is the global batch's), then the mean and the biased
        E[x^2] - mean^2 in float32 (float64 for a float64 input), or,
        without ``f32_stats``, from each rank's means in the input's dtype
        (flax's ``force_float32_reductions=False``)."""
        from torch.distributed.nn.functional import all_reduce

        dims = (0, 2, 3, 4)
        n = x.numel() // x.shape[1]
        acc = torch.promote_types(x.dtype, torch.float32)
        if self.f32_stats:
            xs = x.to(acc)
            s1, s2 = xs.sum(dim=dims), (xs * xs).sum(dim=dims)
        else:
            s1 = x.mean(dim=dims).to(acc) * n
            s2 = (x * x).mean(dim=dims).to(acc) * n
        tot = all_reduce(torch.cat([s1, s2, s1.new_full((1,), float(n))]),
                         group=data_group())
        c = x.shape[1]
        mean, mean2 = tot[:c] / tot[-1], tot[c:2 * c] / tot[-1]
        if not self.f32_stats:
            mean, mean2 = mean.to(x.dtype), mean2.to(x.dtype)
        var = (mean2 - mean * mean).clamp(min=0)
        shape = (1, -1, 1, 1, 1)
        mul = torch.rsqrt(var.to(acc) + self.eps) * self.weight
        centered = (x.to(acc) - mean.to(acc).view(shape) if self.f32_stats
                    else (x - mean.view(shape)).to(acc))
        y = centered * mul.view(shape) + self.bias.view(shape)
        if update:
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    mean.to(self.running_mean.dtype), alpha=1.0 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    var.to(self.running_var.dtype), alpha=1.0 - BN_MOMENTUM)
        return y.to(x.dtype)

    def _low_precision_stats(self, x: torch.Tensor, update: bool):
        """flax with ``force_float32_reductions=False``: mean and
        E[x^2] - mean^2 in the input's dtype, the affine in float32."""
        dims = (0, 2, 3, 4)
        mean = x.mean(dim=dims, keepdim=True)
        var = ((x * x).mean(dim=dims, keepdim=True) - mean * mean).clamp(min=0)
        shape = (1, -1, 1, 1, 1)
        mul = torch.rsqrt(var.float() + self.eps) * self.weight.view(shape)
        y = (x - mean).float() * mul + self.bias.view(shape)
        if update:
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    mean.reshape(-1).float(), alpha=1.0 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    var.reshape(-1).float(), alpha=1.0 - BN_MOMENTUM)
        return y.to(x.dtype)


class ConvBN(nn.Module):
    """Conv3d (no bias, symmetric k//2 padding) + BatchNorm + optional ReLU."""

    def __init__(self, dim_in: int, features: int, kernel: Tuple[int, int, int],
                 strides: Tuple[int, int, int] = (1, 1, 1), relu: bool = True,
                 zero_init_gamma: bool = False, f32_stats: bool = True):
        super().__init__()
        self.conv = Conv3d(dim_in, features, kernel, stride=strides,
                           padding=tuple(k // 2 for k in kernel), bias=False)
        self.bn = BatchNorm3d(features, zero_init=zero_init_gamma,
                              f32_stats=f32_stats)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> contiguous (B, T*H*W, C), tokens in (t, h, w)
    order as the JAX package flattens (B, T, H, W, C); no copy for a
    channels-last input."""
    b, c = x.shape[:2]
    return x.permute(0, 2, 3, 4, 1).reshape(b, -1, c).contiguous()


class NonLocalBlock(nn.Module):
    """Non-local block (dot_product or softmax instantiation) with (1,2,2)
    max-pool subsampling on phi/g, as in the SlowFast package.

    ``attention`` is the attention function, the device dispatcher by
    default; a caller may set it to the kernel or to the plain version to
    run one of them without dispatch."""

    def __init__(self, dim: int, instantiation: str, f32_stats: bool = True):
        super().__init__()
        inner = dim // 2
        # biased 1x1x1 convs, as in PySlowFast's Nonlocal
        self.theta = Conv3d(dim, inner, 1)
        self.phi = Conv3d(dim, inner, 1)
        self.g = Conv3d(dim, inner, 1)
        self.out = Conv3d(inner, dim, 1)
        self.bn = BatchNorm3d(dim, zero_init=True, f32_stats=f32_stats)
        self.pool = nn.MaxPool3d((1, 2, 2), stride=(1, 2, 2))
        self.kind = instantiation
        self.scale = float(inner) ** -0.5
        self.attention = nonlocal_attention

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, ch, t, h, w = x.shape
        inner = ch // 2
        pooled = self.pool(x)
        q = _tokens(self.theta(x))
        k = _tokens(self.phi(pooled))
        v = _tokens(self.g(pooled))
        out = self.attention(q, k, v, self.kind, self.scale).to(x.dtype)
        # (B, THW, inner) -> (B, inner, T, H, W), a channels-last view
        out = out.reshape(b, t, h, w, inner).permute(0, 4, 1, 2, 3)
        return x + self.bn(self.out(out))


class Bottleneck(nn.Module):
    """1x1x1(temp) -> 1x3x3(stride) -> 1x1x1 with residual (projected when
    the width or the stride changes)."""

    def __init__(self, dim_in: int, dim_out: int, dim_inner: int,
                 temp_kernel: int, spatial_stride: int, cfg: VideoCfg,
                 remat: bool = False):
        super().__init__()
        s = spatial_stride
        f32 = cfg.bn_f32_stats
        self.a = ConvBN(dim_in, dim_inner, (temp_kernel, 1, 1), f32_stats=f32)
        self.b = ConvBN(dim_inner, dim_inner, (1, 3, 3), strides=(1, s, s),
                        f32_stats=f32)
        self.c = ConvBN(dim_inner, dim_out, (1, 1, 1), relu=False,
                        zero_init_gamma=cfg.zero_init_final_bn, f32_stats=f32)
        self.proj = None
        if dim_in != dim_out or s != 1:
            self.proj = ConvBN(dim_in, dim_out, (1, 1, 1), strides=(1, s, s),
                               relu=False, f32_stats=f32)
        self.remat = remat

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            return run_remat(self._forward, x)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.proj is None else self.proj(x)
        return F.relu(residual + self.c(self.b(self.a(x))))


class ResStage(nn.Sequential):
    """``block_{i}`` bottlenecks, each followed by ``nl_{i}`` when i is in
    ``nl_blocks`` (PySlowFast names non-local modules by block index)."""

    def __init__(self, dim_in: int, n_blocks: int, dim_out: int, dim_inner: int,
                 temp_kernels: Sequence[int], spatial_stride: int,
                 nl_blocks: Sequence[int], cfg: VideoCfg, stage_idx: int = -1):
        mods = OrderedDict()
        remat = cfg.remat or stage_idx in cfg.remat_stages
        for i in range(n_blocks):
            mods[f"block_{i}"] = Bottleneck(
                dim_in if i == 0 else dim_out, dim_out, dim_inner,
                temp_kernels[i % len(temp_kernels)],
                spatial_stride if i == 0 else 1, cfg, remat=remat,
            )
            if i in nl_blocks:
                mods[f"nl_{i}"] = NonLocalBlock(dim_out, cfg.nl_instantiation,
                                                f32_stats=cfg.bn_f32_stats)
        super().__init__(mods)


def repeatable_stem_pool(x: torch.Tensor) -> torch.Tensor:
    """The stem's (1, 3, 3) stride (1, 2, 2) max pool (pad (0, 1, 1)) as a
    pool along W, then one along H: the same values. The backward of
    PyTorch's CUDA max pool adds the gradients of overlapping windows with
    atomics, up to four into an element here, in an order that changes from
    run to run; one-axis windows of 3 at stride 2 overlap in one element,
    and two additions to zero give the same sum in either order, so this
    backward repeats bit for bit. Where several elements of a window hold
    the maximum, the two pools may pass its gradient to another of them."""
    x = F.max_pool3d(x, (1, 1, 3), stride=(1, 1, 2), padding=(0, 0, 1))
    return F.max_pool3d(x, (1, 3, 1), stride=(1, 2, 1), padding=(0, 1, 0))


class Stem(nn.Module):
    """Stem conv + BN + relu + (1,3,3) s(1,2,2) max pool (pad (0,1,1))."""

    def __init__(self, dim_in: int, width: int, temp_kernel: int,
                 cfg: VideoCfg):
        super().__init__()
        self.conv = ConvBN(dim_in, width, (temp_kernel, 7, 7), strides=(1, 2, 2),
                           f32_stats=cfg.bn_f32_stats)
        self.pool = nn.MaxPool3d((1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))
        self.remat = -1 in cfg.remat_stages

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with record_function("vidsitu.stem"):
            if self.remat and self.training and torch.is_grad_enabled():
                return run_remat(self._forward, x)
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if (x.is_cuda and torch.is_grad_enabled()
                and torch.are_deterministic_algorithms_enabled()):
            return repeatable_stem_pool(x)
        return self.pool(x)


class FuseFastToSlow(nn.Module):
    """Lateral connection: time-strided conv on fast, concat to slow."""

    def __init__(self, fast_channels: int, cfg: VideoCfg):
        super().__init__()
        self.conv_f2s = ConvBN(
            fast_channels, fast_channels * cfg.fusion_ratio,
            (cfg.fusion_kernel, 1, 1), strides=(cfg.alpha, 1, 1),
            f32_stats=cfg.bn_f32_stats,
        )

    def forward(self, slow: torch.Tensor, fast: torch.Tensor):
        return torch.cat([slow, self.conv_f2s(fast)], dim=1), fast


def _nl_for(cfg: VideoCfg, stage: int, pathway: int) -> Tuple[int, ...]:
    loc = cfg.nl_location
    if stage < len(loc) and pathway < len(loc[stage]):
        return tuple(loc[stage][pathway])
    return ()


class SlowFastBackbone(nn.Module):
    """Dual-pathway backbone. forward mirrors
    SlowFast_FeatModel.forward_features (mdl_sf_base.py:21-34); inputs and
    outputs are (B, C, T, H, W)."""

    def __init__(self, cfg: VideoCfg):
        super().__init__()
        c = cfg
        w = c.width
        wf = w // c.beta_inv
        tk_s = TEMPORAL_KERNELS["slowfast"]["slow"]
        tk_f = TEMPORAL_KERNELS["slowfast"]["fast"]
        self.s1_slow = Stem(3, w, tk_s[0][0], c)
        self.s1_fast = Stem(3, wf, tk_f[0][0], c)
        self.s1_fuse = FuseFastToSlow(wf, c)
        slow_in, fast_in = w + wf * c.fusion_ratio, wf
        for i in range(4):
            out_f = _STAGE_OUT[i] // c.beta_inv
            self.add_module(f"s{i + 2}_slow", ResStage(
                slow_in, c.depth_blocks[i], _STAGE_OUT[i], _STAGE_INNER[i],
                tk_s[i + 1], c.spatial_strides[i], _nl_for(c, i, 0), c, i))
            self.add_module(f"s{i + 2}_fast", ResStage(
                fast_in, c.depth_blocks[i], out_f,
                _STAGE_INNER[i] // c.beta_inv, tk_f[i + 1],
                c.spatial_strides[i], _nl_for(c, i, 1), c, i))
            slow_in, fast_in = _STAGE_OUT[i], out_f
            if i < 3:  # fuse after s2, s3, s4
                self.add_module(f"s{i + 2}_fuse", FuseFastToSlow(out_f, c))
                slow_in += out_f * c.fusion_ratio

    def forward(self, slow: torch.Tensor, fast: torch.Tensor):
        slow = self.s1_slow(slow)
        fast = self.s1_fast(fast)
        slow, fast = self.s1_fuse(slow, fast)
        for i in range(4):
            slow = self._modules[f"s{i + 2}_slow"](slow)
            fast = self._modules[f"s{i + 2}_fast"](fast)
            if i < 3:
                slow, fast = self._modules[f"s{i + 2}_fuse"](slow, fast)
        return slow, fast


class ResNet3DBackbone(nn.Module):
    """Single-pathway backbone (c2d / i3d / slow variants); (B, C, T, H, W)
    in and out."""

    def __init__(self, cfg: VideoCfg):
        super().__init__()
        c = cfg
        tk = TEMPORAL_KERNELS[c.arch]["fast"]
        self.s1 = Stem(3, c.width, tk[0][0], c)
        dim_in = c.width
        for i in range(4):
            self.add_module(f"s{i + 2}", ResStage(
                dim_in, c.depth_blocks[i], _STAGE_OUT[i], _STAGE_INNER[i],
                tk[i + 1], c.spatial_strides[i], _nl_for(c, i, 0), c, i))
            dim_in = _STAGE_OUT[i]
        tpool = TEMPORAL_POOL[c.arch]
        self.tpool = (nn.MaxPool3d((tpool, 1, 1), stride=(tpool, 1, 1))
                      if tpool > 1 else nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.s2(self.s1(x))
        x = self.tpool(x)
        return self.s5(self.s4(self.s3(x)))


def trimmed_head(feats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-pathway global average pool + channel concat
    (ResNetBasicHead_Trimmed, mdl_sf_base.py:65-113). (B,C,T,H,W)->(B,C)."""
    return torch.cat([f.mean(dim=(2, 3, 4)) for f in feats], dim=-1)


def backbone_out_dim(c: VideoCfg) -> int:
    """Channel dim of trimmed_head's output for a VideoCfg (2304 for
    slowfast-R50, 2048 single-pathway)."""
    w = c.width * 32
    if c.arch == "slowfast":
        return w + w // c.beta_inv
    return w


def to_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast conv and linear weights to the compute dtype; BatchNorm
    parameters and statistics stay float32, as flax computes BN in float32
    and casts its output (cuDNN's BN takes bf16 input with float32
    parameters)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv3d, nn.Linear)):
            m.to(dtype)
    return model
