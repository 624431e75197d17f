"""Non-local attention: a hand-written CUDA kernel and its plain version.

Port of vidsitu_tpu/ops/attention.py. The non-local blocks of the video
backbones (models/video_backbone.py) attend over T*H*W tokens: at 224 px,
stage 3 of I3D-NL has 3136 queries against 784 pooled keys. The kernel
(csrc/nonlocal_attn.cu) keeps the (queries x keys) logits on chip and writes
only the (queries x d) output.

Numerics follow the JAX package's ``_einsum_attention``, which is what it
runs at these shapes: float32 logits and softmax, ``dot_product`` divided by
the true key count, the output cast to q's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

KINDS = ("softmax", "dot_product")

# kernel launches since the count was last reset (a run sets it to 0 and
# reads it afterwards to show that its non-local blocks took the kernel)
LAUNCHES = 0


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


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kind: str = "softmax", scale: Optional[float] = None,
) -> torch.Tensor:
    """The CUDA kernel: same contract as :func:`attention_reference`
    (``scale`` defaults to d**-0.5). Forward only. Raises on anything the
    kernel does not take: a non-CUDA tensor, a dtype other than bfloat16 or
    float32, mismatched shapes, a non-contiguous or misaligned input,
    d % 8 != 0 or d > 512, or an input that requires grad."""
    global LAUNCHES
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
    if scale is None:
        scale = float(d) ** -0.5
    out = torch.empty_like(q)
    lib = _build.load_nonlocal_attn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.nl_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, d, KINDS.index(kind), float(scale),
            int(q.dtype == torch.bfloat16), stream,
        )
    if err:
        raise RuntimeError(f"nl_attn_fwd launch failed: cudaError {err}")
    LAUNCHES += 1
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
