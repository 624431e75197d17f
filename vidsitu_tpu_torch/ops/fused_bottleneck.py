"""Fused inference bottleneck: hand-written CUDA kernels and their plain
version.

Ports of the TPU kernels ``fused_bottleneck_frames``
(benchmarks/probe_fused_bottleneck.py:108) and ``fused_multi``
(benchmarks/micro4.py:84). One pass per frame computes
``relu(res(x) + c(relu(b(relu(a(x))))))`` for a ResNet bottleneck whose convs
are 1x1x1 -> 1x3x3 (stride 1) -> 1x1x1 with inference BatchNorm folded into
the weights; ``res`` is the identity, or a folded 1x1 projection when the
width changes. The temporal kernel is 1 (SlowFast slow pathway, stages s2 and
s3), so frames are independent.

As in the JAX package, the fused block is a probe beside the model: no
configuration routes the backbone to it. ``vidsitu_tpu_torch.gates`` times
it against the unfused chain; :func:`run_fused_block` drives it from a
``Bottleneck``'s weights.

The contract is the TPU kernel's: ``x`` (B, H, W, Cin) channels-last frames,
``wa`` (Cin, Cmid), ``wb`` (3, 3, Cmid, Cmid), ``wc`` (Cmid, Cout), ``wp``
(Cin, Cout) or None, all in the type of ``x`` with the BatchNorm scale folded
in; ``ba``, ``bb``, ``bc``, ``bp`` the float32 shifts, shape (1, C) or (C,).
Sums are float32; the two intermediates are rounded to the type of ``x``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.nn import functional as F

from . import _build

# kernel launches by entry point since the counts were last reset
LAUNCHES = {"fused_bottleneck_frames": 0, "fused_bottleneck_multi": 0}

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_FRAMES = 65535  # one grid row per frame


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fold_conv_bn(kernel, scale, bias, mean, var, eps: float):
    """Fold inference BatchNorm into a conv whose last axis is the output
    channel: returns (W', b') with W'[..., o] = W[..., o] * s[o],
    b' = bias - mean * s, s = scale / sqrt(var + eps)."""
    s = scale * torch.rsqrt(var + eps)
    return kernel * s, bias - mean * s


def _check_block(block) -> None:
    if block.a.conv.kernel_size[0] != 1:
        raise ValueError(
            "the fused block needs a temporal kernel of 1, got "
            f"{block.a.conv.kernel_size[0]}")
    if tuple(block.b.conv.stride) != (1, 1, 1):
        raise ValueError(
            f"the fused block needs spatial stride 1, got {block.b.conv.stride}")


def fold_bottleneck(block, dtype: torch.dtype = torch.float32
                    ) -> Tuple[Optional[torch.Tensor], ...]:
    """``(wa, ba, wb, bb, wc, bc, wp, bp)`` of a ``Bottleneck`` (models/
    video_backbone.py) in the TPU probe's layouts: BatchNorm's running
    statistics folded into the conv weights in float32, weights then cast to
    ``dtype``, shifts float32 of shape (1, C); ``wp`` and ``bp`` are None
    without a projection. Raises on a block outside the kernel's contract
    (temporal kernel 3, spatial stride 2)."""
    _check_block(block)

    def folded(convbn):
        # torch (O, I, T, H, W) -> flax (T, H, W, I, O)
        k = convbn.conv.weight.detach().float().permute(2, 3, 4, 1, 0)
        bn = convbn.bn
        w, b = fold_conv_bn(k, bn.weight.detach().float(),
                            bn.bias.detach().float(), bn.running_mean.float(),
                            bn.running_var.float(), bn.eps)
        return w, b.reshape(1, -1).contiguous()

    wa, ba = folded(block.a)
    wb, bb = folded(block.b)
    wc, bc = folded(block.c)
    cin, cmid, cout = wa.shape[3], wa.shape[4], wc.shape[4]
    wp = bp = None
    if block.proj is not None:
        wp, bp = folded(block.proj)
        wp = wp.reshape(cin, cout).to(dtype).contiguous()
    return (wa.reshape(cin, cmid).to(dtype).contiguous(), ba,
            wb.reshape(3, 3, cmid, cmid).to(dtype).contiguous(), bb,
            wc.reshape(cmid, cout).to(dtype).contiguous(), bc, wp, bp)


def fused_bottleneck_plain(x, wa, ba, wb, bb, wc, bc, wp=None, bp=None):
    """Plain PyTorch version: three ``F.conv2d`` on the folded weights with
    the kernel's casts (float32 sums, intermediates rounded to ``x.dtype``,
    float32 shifts added before each relu)."""
    _check_shapes(x, wa, ba, wb, bb, wc, bc, wp, bp)
    dt = x.dtype
    xf = x.permute(0, 3, 1, 2).float()

    def conv(inp, w_hwio, shift, pad=0):
        w = w_hwio.float().permute(3, 2, 0, 1)  # HWIO -> OIHW
        return F.conv2d(inp, w, padding=pad) + shift.float().reshape(1, -1, 1, 1)

    h1 = F.relu(conv(xf, wa[None, None], ba)).to(dt).float()
    h2 = F.relu(conv(h1, wb, bb, pad=1)).to(dt).float()
    y = conv(h2, wc[None, None], bc)
    res = xf if wp is None else conv(xf, wp[None, None], bp)
    return F.relu(y + res).to(dt).permute(0, 2, 3, 1).contiguous()


def _check_shapes(x, wa, ba, wb, bb, wc, bc, wp, bp) -> Tuple[int, int, int]:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got {tuple(x.shape)}")
    cin = x.shape[3]
    cmid, cout = wa.shape[1], wc.shape[1]
    want = {"wa": (wa, (cin, cmid)), "wb": (wb, (3, 3, cmid, cmid)),
            "wc": (wc, (cmid, cout))}
    if wp is not None:
        want["wp"] = (wp, (cin, cout))
    for name, (w, shape) in want.items():
        if tuple(w.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(w.shape)}")
    shifts = {"ba": (ba, cmid), "bb": (bb, cmid), "bc": (bc, cout)}
    if wp is not None:
        if bp is None:
            raise ValueError("wp without bp")
        shifts["bp"] = (bp, cout)
    elif cin != cout:
        raise ValueError(
            f"Cin {cin} != Cout {cout} needs the projection (wp, bp)")
    for name, (b, n) in shifts.items():
        if b.numel() != n:
            raise ValueError(f"{name} must hold {n} values, got {tuple(b.shape)}")
    return cin, cmid, cout


def _prepare(name, x, wa, ba, wb, bb, wc, bc, wp, bp):
    """Checks for the CUDA route and the kernel's operands: weights in the
    type of ``x``, float32 shifts. The bf16 kernel takes the weights
    output-channel major (each matrix transposed), the input channels of wa
    and wp zero-padded to the MMA depth."""
    cin, cmid, cout = _check_shapes(x, wa, ba, wb, bb, wc, bc, wp, bp)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x is on {x.device}, not CUDA")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: x must be bfloat16 or float32, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous and 16-byte aligned")
    if not 0 < x.shape[0] <= MAX_FRAMES or 0 in x.shape:
        raise ValueError(f"{name}: {tuple(x.shape)} frames, at most {MAX_FRAMES}")
    bf16 = x.dtype == torch.bfloat16
    if bf16 and (cin % 8 or cmid % 16 or cout % 16):
        raise ValueError(
            f"{name}: bf16 needs Cin % 8 == 0, Cmid % 16 == 0 and "
            f"Cout % 16 == 0, got {cin}/{cmid}/{cout}")
    if not bf16 and cin % 4:
        raise ValueError(f"{name}: float32 needs Cin % 4 == 0, got {cin}")
    cin_p = -(-cin // 16) * 16 if bf16 else cin

    def weight(w, pad_rows=False):
        if w.device != x.device:
            raise ValueError(f"{name}: weights on {w.device}, x on {x.device}")
        w = w.to(x.dtype)
        if pad_rows and cin_p != cin:
            w = F.pad(w, (0, 0, 0, cin_p - cin))
        if bf16:
            w = w.transpose(-1, -2)
        return w.contiguous()

    def shift(b):
        return b.to(device=x.device, dtype=torch.float32).reshape(-1).contiguous()

    ops = dict(wa=weight(wa, True), ba=shift(ba), wb=weight(wb), bb=shift(bb),
               wc=weight(wc), bc=shift(bc),
               wp=None if wp is None else weight(wp, True),
               bp=None if wp is None else shift(bp))
    return ops, (cin, cin_p, cmid, cout), int(bf16)


def _raise_on(name: str, err: int, x) -> None:
    if err == -2:
        raise ValueError(
            f"{name}: the tiles for {tuple(x.shape)} {x.dtype} do not fit a "
            "thread block's shared memory")
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def fused_bottleneck_frames(x, wa, ba, wb, bb, wc, bc, wp=None, bp=None):
    """The CUDA kernel, one thread block per (tile, frame); same contract as
    :func:`fused_bottleneck_plain`. Raises on anything the kernel does not
    take (a CPU tensor, another dtype, channel counts off the MMA shapes)."""
    name = "fused_bottleneck_frames"
    ops, (cin, cin_p, cmid, cout), bf16 = _prepare(
        name, x, wa, ba, wb, bb, wc, bc, wp, bp)
    b, h, w, _ = x.shape
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    ptr = {k: (None if v is None else v.data_ptr()) for k, v in ops.items()}
    with torch.cuda.device(x.device):
        err = _build.load_fused_bottleneck().fused_bottleneck_frames(
            x.data_ptr(), ptr["wa"], ptr["ba"], ptr["wb"], ptr["bb"],
            ptr["wc"], ptr["bc"], ptr["wp"], ptr["bp"], out.data_ptr(),
            b, h, w, cin, cin_p, cmid, cout, bf16,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(name, err, x)
    return out


# which of (wa, wb, wc) the last fused_bottleneck_multi launch kept in shared
# memory (decided by the launcher from the shapes)
LAST_STAGED = (False, False, False)


def fused_bottleneck_multi(x, wa, ba, wb, bb, wc, bc, frames_per_step: int = 4):
    """The CUDA kernel's multi-frame entry: the block without projection,
    ``frames_per_step`` frames per thread block, the folded weights kept in
    shared memory where they fit beside the tiles."""
    global LAST_STAGED
    name = "fused_bottleneck_multi"
    if frames_per_step < 1:
        raise ValueError(f"frames_per_step must be >= 1, got {frames_per_step}")
    ops, (cin, cin_p, cmid, cout), bf16 = _prepare(
        name, x, wa, ba, wb, bb, wc, bc, None, None)
    b, h, w, _ = x.shape
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    staged = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        err = _build.load_fused_bottleneck().fused_bottleneck_multi(
            x.data_ptr(), ops["wa"].data_ptr(), ops["ba"].data_ptr(),
            ops["wb"].data_ptr(), ops["bb"].data_ptr(), ops["wc"].data_ptr(),
            ops["bc"].data_ptr(), out.data_ptr(), b, h, w, cin, cin_p, cmid,
            cout, int(frames_per_step), bf16, ctypes.byref(staged),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(name, err, x)
    LAST_STAGED = tuple(bool(staged.value >> i & 1) for i in range(3))
    return out


def fused_bottleneck(x, wa, ba, wb, bb, wc, bc, wp=None, bp=None,
                     frames_per_step: Optional[int] = None):
    """Dispatch by device: a CPU tensor takes the plain version, a CUDA
    tensor a kernel (the multi-frame entry when ``frames_per_step`` is
    given, which excludes a projection); the kernels raise on what they do
    not take."""
    if frames_per_step is not None and wp is not None:
        raise ValueError("the multi-frame entry takes no projection")
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, wa, ba, wb, bb, wc, bc, wp, bp)
    if frames_per_step is not None:
        return fused_bottleneck_multi(x, wa, ba, wb, bb, wc, bc,
                                      frames_per_step)
    return fused_bottleneck_frames(x, wa, ba, wb, bb, wc, bc, wp, bp)


def run_fused_block(block, x, dtype: torch.dtype = torch.float32,
                    frames_per_step: Optional[int] = None):
    """Drive the fused block from a ``Bottleneck``'s weights and running
    statistics (the counterpart of the TPU probe's ``run_fused_block``).
    ``x``: (N, T, H, W, Cin), the JAX package's frame layout; returns
    (N, T, H, W, Cout) in ``dtype``. The temporal kernel must be 1 and the
    spatial stride 1."""
    folded = fold_bottleneck(block, dtype)
    n, t, h, w, cin = x.shape
    frames = x.reshape(n * t, h, w, cin).to(dtype).contiguous()
    y = fused_bottleneck(frames, *folded, frames_per_step=frames_per_step)
    return y.reshape(n, t, h, w, -1)
