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

# kernel launches by wrapper since the counts were last reset, and the same
# launches by C entry. Each wrapper has two entries: the kernel designed for
# Hopper (``*_wgmma``: bf16, Cmid 64, no projection) and the first kernel
# (wmma for bf16, scalar float32), which takes everything else.
LAUNCHES = {"fused_bottleneck_frames": 0, "fused_bottleneck_multi": 0}
ENTRIES = {
    "fused_bottleneck_frames": ("fused_bottleneck_frames_wgmma",
                                "fused_bottleneck_frames"),
    "fused_bottleneck_multi": ("fused_bottleneck_multi_wgmma",
                               "fused_bottleneck_multi"),
}
LAUNCHES_BY_ENTRY = {name: 0 for pair in ENTRIES.values() for name in pair}

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# the fused_bottleneck_frames entry launches one grid row per frame; the
# other three entries take any number of frames
MAX_FRAMES = 65535

# The wgmma kernel's walk and shared-memory budget, mirrored from
# csrc/fused_bottleneck.cu (namespace wg; a test holds the two equal): bytes
# a block may use, tile alignment, warpgroups a block, the bottleneck width
# taken, positions of one warpgroup's tile, positions by which the outputs
# trail conv a, positions of the h1 ring, input channels of one x chunk,
# slots of each warpgroup's x ring, output channels of one conv c pass,
# output channels of the 8-row tile through which a warp stages the residual
# and the result.
WGMMA_SMEM_LIMIT = 232448
WGMMA_SMEM_ALIGN = 1024
WGMMA_GROUPS = 2
WGMMA_CMID = 64
WGMMA_TILE_M = 64
WGMMA_LAG = 64
WGMMA_RING = 256
WGMMA_CHUNK_K = 64
WGMMA_X_STAGES = 3
WGMMA_NC = 128
WGMMA_STAGE_COLS = 64
WGMMA_STEP_M = WGMMA_GROUPS * WGMMA_TILE_M
WGMMA_MAX_W = WGMMA_LAG - 3  # a 3x3 tap reaches W + 3 flat positions
WGMMA_WIDTHS = (128, 256)    # Cin == Cout instantiated in the source


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BY_ENTRY):
        for name in counts:
            counts[name] = 0


def wgmma_budget(cin: int, cmid: int, cout: int, has_proj: bool) -> dict:
    """Shared memory one block of the wgmma kernel needs with every folded
    weight resident, part by part, as ``Layout`` in the source computes it
    (input channels in chunks of 64): ``bytes`` in all, ``fits`` whether a
    block can have that much. The projection's weights and Cmid = 128 are
    what does not fit: such blocks stay on the first kernel."""
    cin_p = -(-cin // WGMMA_CHUNK_K) * WGMMA_CHUNK_K
    row = cmid * 2  # one position of h1, bytes
    parts = {
        "wa": cin_p * cmid * 2,
        "wb": 9 * cmid * cmid * 2,
        "wc": cmid * cout * 2,
        "wp": cin_p * cout * 2 if has_proj else 0,
        "h1_ring": WGMMA_RING * row,
        "x_ring": (WGMMA_GROUPS * WGMMA_X_STAGES * WGMMA_TILE_M
                   * WGMMA_CHUNK_K * 2),
        "shifts": (2 * cmid + cout * (2 if has_proj else 1)) * 4,
        "stage": WGMMA_GROUPS * 4 * 8 * WGMMA_STAGE_COLS * 2,
        "align": WGMMA_SMEM_ALIGN,
    }
    total = sum(parts.values())
    return {**parts, "bytes": total, "fits": total <= WGMMA_SMEM_LIMIT,
            "resident": ("wa", "wb", "wc") + (("wp",) if has_proj else ())}


def wgmma_refusal(dtype, cin: int, cmid: int, cout: int, has_proj: bool,
                  width: Optional[int] = None) -> Optional[str]:
    """Why the wgmma kernel does not take these operands, or None if it does."""
    if dtype != torch.bfloat16:
        return f"{dtype}, not bfloat16"
    if has_proj:
        return "a projection (its weights do not fit beside the others)"
    if cmid != WGMMA_CMID:
        return f"Cmid {cmid}, not {WGMMA_CMID}"
    if cin != cout or cin not in WGMMA_WIDTHS:
        return f"Cin {cin} / Cout {cout}, not equal and in {WGMMA_WIDTHS}"
    if width is not None and width > WGMMA_MAX_W:
        return f"W {width} > {WGMMA_MAX_W}"
    assert wgmma_budget(cin, cmid, cout, has_proj)["fits"]
    return None


def kernel_entry(dtype, cin: int, cmid: int, cout: int, has_proj: bool,
                 width: Optional[int] = None, multi: bool = False) -> str:
    """The C entry a wrapper routes these operands to (``multi``: of
    :func:`fused_bottleneck_multi`, else of :func:`fused_bottleneck_frames`):
    a pure function of its arguments, decided before any launch."""
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused bottleneck: {dtype}; bfloat16 or float32 only")
    if multi and has_proj:
        raise ValueError("the multi-frame entry takes no projection")
    wgmma, first = ENTRIES[
        "fused_bottleneck_multi" if multi else "fused_bottleneck_frames"]
    refused = wgmma_refusal(dtype, cin, cmid, cout, has_proj, width)
    return first if refused else wgmma


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


def fused_bottleneck_tiled_reference(x, wa, ba, wb, bb, wc, bc, wp=None,
                                     bp=None, frames_per_step: int = 1,
                                     zero_outside: bool = True):
    """Plain PyTorch version that repeats the wgmma kernel's walk: groups of
    ``frames_per_step`` consecutive frames (the last one short) as one
    stream of flat, width-padded positions (a zero row above and below each
    frame, a zero column left and right), steps of 128 positions, conv a
    once per position into a rolling ring of 256 positions of h1 that is
    zero outside the frames, the 3x3 as nine constant offsets into the ring
    for the 128 positions that trail conv a by 64, conv c and the residual
    on those, pad positions not stored. Same casts as
    :func:`fused_bottleneck_plain`. ``zero_outside=False`` leaves relu(ba)
    at the pad positions (wrong on purpose, for the test that shows the
    difference). For the tests and the on-card comparison; nothing on a path
    calls it."""
    cin, cmid, cout = _check_shapes(x, wa, ba, wb, bb, wc, bc, wp, bp)
    b, h, w, _ = x.shape
    if w > WGMMA_MAX_W:
        raise ValueError(f"the walk takes W <= {WGMMA_MAX_W}, got {w}")
    if frames_per_step < 1:
        raise ValueError(f"frames_per_step must be >= 1, got {frames_per_step}")
    dt, dev = x.dtype, x.device
    step, lag, ring_n = WGMMA_STEP_M, WGMMA_LAG, WGMMA_RING
    wp_ = w + 2
    fs = (h + 2) * wp_           # positions of one frame
    g = min(frames_per_step, b)  # frames of a group
    n_pos = g * fs
    last = (g - 1) * fs + h * wp_ + w        # a group's last stored position
    steps = (last + lag) // step + 1
    taps = [(dh - 1) * wp_ + (dw - 1) for dh in range(3) for dw in range(3)]
    waf, wcf = wa.float(), wc.float()
    wbf = wb.float().reshape(9, cmid, cmid)
    wpf = None if wp is None else wp.float()
    shift = [None if t is None else t.float().reshape(1, -1)
             for t in (ba, bb, bc, bp)]
    out = torch.zeros((b * h * w, cout), dtype=dt, device=dev)
    for f0 in range(0, b, g):
        n = min(g, b - f0)
        stream = torch.zeros((g, h + 2, wp_, cin), dtype=dt, device=dev)
        stream[:n, 1:h + 1, 1:w + 1] = x[f0:f0 + n]
        stream = stream.reshape(n_pos, cin)
        pix = torch.full((g, h + 2, wp_), -1, dtype=torch.long, device=dev)
        pix[:n, 1:h + 1, 1:w + 1] = torch.arange(
            f0 * h * w, (f0 + n) * h * w, device=dev).reshape(n, h, w)
        pix = pix.reshape(n_pos)
        ring = torch.zeros((ring_n, cmid), dtype=torch.float32, device=dev)
        for s in range(steps):
            pos = torch.arange(s * step, (s + 1) * step, device=dev)
            at = pos.clamp(max=n_pos - 1)
            inside = (pos < n_pos) & (pix[at] >= 0)
            xs = torch.where(inside[:, None], stream[at].float(), 0.0)
            h1 = F.relu(xs @ waf + shift[0])
            if zero_outside:
                h1 = torch.where(inside[:, None], h1, 0.0)
            ring[pos % ring_n] = h1.to(dt).float()
            opos = pos - lag
            acc = torch.zeros((step, cmid), dtype=torch.float32, device=dev)
            for t, d in enumerate(taps):
                acc += ring[(opos + d) % ring_n] @ wbf[t]
            h2 = F.relu(acc + shift[1]).to(dt).float()
            at = opos.clamp(0, n_pos - 1)
            stored = (opos >= 0) & (opos < n_pos) & (pix[at] >= 0)
            xo = stream[at].float()
            res = xo if wpf is None else xo @ wpf + shift[3]
            y = F.relu(h2 @ wcf + shift[2] + res).to(dt)
            out[pix[at][stored]] = y[stored]
    return out.reshape(b, h, w, cout)


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
    if 0 in x.shape:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")
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


def _raise_on(name: str, entry: str, err: int, x) -> None:
    if err == -2:
        raise ValueError(
            f"{entry}: the tiles for {tuple(x.shape)} {x.dtype} do not fit a "
            "thread block's shared memory")
    if err:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    LAUNCHES_BY_ENTRY[entry] += 1


def _pick_entry(name, entry, x, dims, has_proj) -> str:
    """The routed C entry of wrapper ``name``, or the forced one after
    checking that it is one of the wrapper's and takes the input."""
    cin, _, cmid, cout = dims
    if entry is None:
        return kernel_entry(x.dtype, cin, cmid, cout, has_proj, x.shape[2],
                            multi=name == "fused_bottleneck_multi")
    if entry not in ENTRIES[name]:
        raise ValueError(f"{name}: entry must be one of {ENTRIES[name]}, "
                         f"got {entry!r}")
    if entry == ENTRIES[name][0]:
        refused = wgmma_refusal(x.dtype, cin, cmid, cout, has_proj, x.shape[2])
        if refused:
            raise ValueError(f"{entry} does not take {refused}")
    return entry


def _launch_wgmma(entry, x, ops, dims, out, *frames_per_step) -> int:
    cin, _, cmid, cout = dims
    b, h, w, _ = x.shape
    with torch.cuda.device(x.device):
        return getattr(_build.load_fused_bottleneck(), entry)(
            x.data_ptr(), ops["wa"].data_ptr(), ops["ba"].data_ptr(),
            ops["wb"].data_ptr(), ops["bb"].data_ptr(), ops["wc"].data_ptr(),
            ops["bc"].data_ptr(), out.data_ptr(), b, h, w, cin, cmid, cout,
            *frames_per_step, torch.cuda.current_stream(x.device).cuda_stream)


def fused_bottleneck_frames(x, wa, ba, wb, bb, wc, bc, wp=None, bp=None,
                            entry: Optional[str] = None):
    """The CUDA kernels' per-frame wrapper; same contract as
    :func:`fused_bottleneck_plain`. :func:`kernel_entry` picks the C entry:
    the wgmma kernel walks each frame as one stream of positions, the first
    kernel takes one thread block per (tile, frame). ``entry`` forces one of
    the two. Raises on anything the entry does not take (a CPU tensor,
    another dtype, channel counts off the MMA shapes)."""
    name = "fused_bottleneck_frames"
    ops, dims, bf16 = _prepare(name, x, wa, ba, wb, bb, wc, bc, wp, bp)
    cin, cin_p, cmid, cout = dims
    entry = _pick_entry(name, entry, x, dims, wp is not None)
    b, h, w, _ = x.shape
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if entry == ENTRIES[name][0]:
        err = _launch_wgmma(entry, x, ops, dims, out)
    else:
        if b > MAX_FRAMES:
            raise ValueError(f"{entry}: {b} frames, at most {MAX_FRAMES}")
        ptr = {k: (None if v is None else v.data_ptr())
               for k, v in ops.items()}
        with torch.cuda.device(x.device):
            err = _build.load_fused_bottleneck().fused_bottleneck_frames(
                x.data_ptr(), ptr["wa"], ptr["ba"], ptr["wb"], ptr["bb"],
                ptr["wc"], ptr["bc"], ptr["wp"], ptr["bp"], out.data_ptr(),
                b, h, w, cin, cin_p, cmid, cout, bf16,
                torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(name, entry, err, x)
    return out


# which of (wa, wb, wc) the last launch of the fused_bottleneck_multi entry
# kept in shared memory (decided by its launcher from the shapes; the wgmma
# entry always keeps all three)
LAST_STAGED = (False, False, False)


def fused_bottleneck_multi(x, wa, ba, wb, bb, wc, bc, frames_per_step: int = 4,
                           entry: Optional[str] = None):
    """The CUDA kernels' multi-frame wrapper: the block without projection,
    ``frames_per_step`` consecutive frames a work item, the folded weights
    kept in shared memory. The wgmma entry streams the frames of an item as
    one run of positions and deals the steps evenly over the SMs; the first
    kernel gives each item to one thread block and keeps what weights fit
    beside its tiles. ``entry`` forces one of the two."""
    global LAST_STAGED
    name = "fused_bottleneck_multi"
    if frames_per_step < 1:
        raise ValueError(f"frames_per_step must be >= 1, got {frames_per_step}")
    ops, dims, bf16 = _prepare(name, x, wa, ba, wb, bb, wc, bc, None, None)
    cin, cin_p, cmid, cout = dims
    entry = _pick_entry(name, entry, x, dims, False)
    b, h, w, _ = x.shape
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if entry == ENTRIES[name][0]:
        err = _launch_wgmma(entry, x, ops, dims, out, int(frames_per_step))
        _raise_on(name, entry, err, x)
        return out
    staged = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        err = _build.load_fused_bottleneck().fused_bottleneck_multi(
            x.data_ptr(), ops["wa"].data_ptr(), ops["ba"].data_ptr(),
            ops["wb"].data_ptr(), ops["bb"].data_ptr(), ops["wc"].data_ptr(),
            ops["bc"].data_ptr(), out.data_ptr(), b, h, w, cin, cin_p, cmid,
            cout, int(frames_per_step), bf16, ctypes.byref(staged),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(name, entry, err, x)
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
