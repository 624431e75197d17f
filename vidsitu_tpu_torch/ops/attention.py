"""Non-local attention: a hand-written CUDA kernel and its plain version.

Port of vidsitu_tpu/ops/attention.py. The non-local blocks of the video
backbones (models/video_backbone.py) attend over T*H*W tokens: at 224 px,
stage 3 of I3D-NL has 3136 queries against 784 pooled keys. The kernels
(csrc/nonlocal_attn.cu) keep the (queries x keys) logits on chip and write
only the (queries x d) output. There are two, both written by hand:
``nl_attn_fwd_wgmma`` (Hopper's warpgroup tensor-core instruction, register
accumulators, a K/V ring filled ahead of the products) takes bfloat16 at
d in {64, 128, 256, 512}; ``nl_attn_fwd`` takes float32 and every other
width. :func:`kernel_entry` says which, from dtype and d alone.

Numerics follow the JAX package's ``_einsum_attention``, which is what it
runs at these shapes: float32 logits and softmax, ``dot_product`` divided by
the true key count, the output cast to q's dtype.
"""

from __future__ import annotations

from typing import Optional

import math

import torch

from . import _build

KINDS = ("softmax", "dot_product")
ENTRIES = ("nl_attn_fwd_wgmma", "nl_attn_fwd")
WGMMA_WIDTHS = (64, 128, 256, 512)

# kernel launches since the counts were last reset (a run resets them and
# reads them afterwards to show that its non-local blocks took the kernel,
# and which entry): the total, and the same launches by C entry
LAUNCHES = 0
LAUNCHES_BY_ENTRY = {name: 0 for name in ENTRIES}

# The wgmma kernel's tiling, mirrored from csrc/nonlocal_attn.cu (namespace
# wg; tests hold the two equal): bytes a block may use, tile alignment, ring
# slots, keys per tile up to and above the widest d that one warpgroup
# accumulates, query rows per warpgroup, warpgroups per block.
WGMMA_SMEM_LIMIT = 232448
WGMMA_SMEM_ALIGN = 1024
WGMMA_STAGES = 2
WGMMA_BLOCK_K = 80
WGMMA_BLOCK_K_SPLIT = 32
WGMMA_SPLIT_ABOVE = 256
WGMMA_ROWS_PER_GROUP = 64
WGMMA_GROUPS = 2


def reset_launches() -> None:
    """Set the launch counts to 0."""
    global LAUNCHES
    LAUNCHES = 0
    for name in ENTRIES:
        LAUNCHES_BY_ENTRY[name] = 0


def kernel_entry(dtype: torch.dtype, d: int) -> str:
    """The C entry that takes (dtype, d): a pure function of the two,
    decided before any launch. Raises on what neither kernel takes."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_attention: {dtype}; bfloat16 or float32 only")
    if d % 8 or not 8 <= d <= 512:
        raise ValueError(
            f"fused_attention takes 8 <= d <= 512 with d % 8 == 0; got d={d}")
    if dtype == torch.bfloat16 and d in WGMMA_WIDTHS:
        return "nl_attn_fwd_wgmma"
    return "nl_attn_fwd"


def wgmma_block_k(d: int) -> int:
    """Keys per tile of the wgmma kernel at head width d."""
    return WGMMA_BLOCK_K_SPLIT if d > WGMMA_SPLIT_ABOVE else WGMMA_BLOCK_K


def wgmma_smem_bytes(d: int, block_k: int, stages: int) -> int:
    """Shared memory of one block of the wgmma kernel, as its ``Cfg`` struct
    computes it: alignment slack, the bf16 Q tile (128 query rows, 64 where
    two warpgroups split d) and ``stages`` slots of one K and one V tile."""
    q_rows = WGMMA_ROWS_PER_GROUP * (
        1 if d > WGMMA_SPLIT_ABOVE else WGMMA_GROUPS)
    return WGMMA_SMEM_ALIGN + q_rows * d * 2 + stages * 2 * block_k * d * 2


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kind: str,
    scale: float,
) -> torch.Tensor:
    """Plain PyTorch version: (B, Sq, d) x (B, Sk, d) x (B, Sk, d) ->
    (B, Sq, d), in float32, cast to q's dtype."""
    logits = torch.bmm(q.float(), k.float().transpose(1, 2))
    if kind == "softmax":
        probs = torch.softmax(logits * scale, dim=-1)
    elif kind == "dot_product":
        probs = logits / logits.shape[-1]
    else:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    return torch.bmm(probs, v.float()).to(q.dtype)


def attention_tiled_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kind: str,
    scale: float, block_k: int,
) -> torch.Tensor:
    """Plain PyTorch version that repeats the wgmma kernel's arithmetic step
    by step: key tiles of ``block_k`` with the keys past Sk masked, a running
    max and sum, exp2 with scale * log2(e) folded into one factor, the
    probabilities rounded to q's dtype before the P V product, float32
    accumulation, one division at the end. For the tests and the on-card
    comparison; nothing on the model's path calls it."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    b, sq, d = q.shape
    sk = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    acc = torch.zeros((b, sq, d), dtype=torch.float32, device=q.device)
    m_run = torch.full((b, sq, 1), -math.inf, device=q.device)
    l_run = torch.zeros((b, sq, 1), device=q.device)
    c2 = scale * math.log2(math.e)
    for key0 in range(0, sk, block_k):
        pad = max(0, key0 + block_k - sk)
        kt = torch.nn.functional.pad(kf[:, key0:key0 + block_k], (0, 0, 0, pad))
        vt = torch.nn.functional.pad(vf[:, key0:key0 + block_k], (0, 0, 0, pad))
        past = torch.arange(key0, key0 + block_k, device=q.device) >= sk
        s = torch.bmm(qf, kt.transpose(1, 2))
        if kind == "softmax":
            s = (s * c2).masked_fill(past, -math.inf)
            m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
            # the first tile has m_run = -inf: alpha is 0, not exp2(nan)
            alpha = torch.where(torch.isinf(m_run), torch.zeros_like(m_run),
                                torch.exp2(m_run - m_new))
            p = torch.exp2(s - m_new)
            l_run = l_run * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha
            m_run = m_new
        else:
            p = (s / sk).masked_fill(past, 0.0)
        acc = acc + torch.bmm(p.to(q.dtype).float(), vt)
    if kind == "softmax":
        acc = acc / l_run
    return acc.to(q.dtype)


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kind: str = "softmax", scale: Optional[float] = None,
    entry: Optional[str] = None,
) -> torch.Tensor:
    """The CUDA kernels: same contract as :func:`attention_reference`
    (``scale`` defaults to d**-0.5). Forward only. Raises on anything the
    kernels do not take: a non-CUDA tensor, a dtype other than bfloat16 or
    float32, mismatched shapes, a non-contiguous or misaligned input,
    d % 8 != 0 or d > 512, or an input that requires grad.

    :func:`kernel_entry` picks the C entry from dtype and d. ``entry`` forces
    one of :data:`ENTRIES` instead (to time both side by side) and raises if
    that entry does not take the input: ``nl_attn_fwd`` takes everything
    listed above, ``nl_attn_fwd_wgmma`` only what ``kernel_entry`` routes to
    it."""
    global LAUNCHES
    if entry is not None and entry not in ENTRIES:
        raise ValueError(f"entry must be one of {ENTRIES}, got {entry!r}")
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"fused_attention: {name} is on {t.device}, not CUDA")
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"fused_attention: {name} is {t.dtype}; "
                            "bfloat16 or float32 only")
        if t.dim() != 3:
            raise ValueError(f"fused_attention: {name} must be (B, S, d), "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_attention: {name} must be contiguous "
                             "and 16-byte aligned")
        if t.requires_grad:
            raise RuntimeError("fused_attention is forward-only: "
                               f"{name} requires grad")
    b, sq, d = q.shape
    sk = k.shape[1]
    if (k.shape != (b, sk, d) or v.shape != k.shape
            or k.dtype != q.dtype or v.dtype != q.dtype
            or k.device != q.device or v.device != q.device):
        raise ValueError(
            "fused_attention: q (B, Sq, d), k and v (B, Sk, d) of one dtype "
            f"and device, got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}"
        )
    if d % 8 or not 8 <= d <= 512 or sk < 1 or not 1 <= b <= 65535:
        raise ValueError(
            f"fused_attention takes 8 <= d <= 512 with d % 8 == 0, Sk >= 1 "
            f"and 1 <= B <= 65535; got B={b}, Sk={sk}, d={d}"
        )
    routed = kernel_entry(q.dtype, d)
    if entry is None:
        entry = routed
    elif entry == "nl_attn_fwd_wgmma" and routed != entry:
        raise ValueError(
            f"nl_attn_fwd_wgmma takes bfloat16 with d in {WGMMA_WIDTHS}; "
            f"got {q.dtype}, d={d}")
    if scale is None:
        scale = float(d) ** -0.5
    out = torch.empty_like(q)
    lib = _build.load_nonlocal_attn()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, d, KINDS.index(kind), float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if entry == "nl_attn_fwd_wgmma":
            err = lib.nl_attn_fwd_wgmma(*args, stream)
        else:
            err = lib.nl_attn_fwd(*args, int(q.dtype == torch.bfloat16),
                                  stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    LAUNCHES += 1
    LAUNCHES_BY_ENTRY[entry] += 1
    return out


def nonlocal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kind: str,
    scale: float,
) -> torch.Tensor:
    """Dispatch by device: CPU tensors take :func:`attention_reference`,
    CUDA tensors the kernel (which raises on what it does not take)."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, kind, scale)
    return fused_attention(q, k, v, kind, scale)
