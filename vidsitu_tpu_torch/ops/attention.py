"""Non-local attention: a hand-written CUDA kernel and its plain version.

Port of vidsitu_tpu/ops/attention.py. The non-local blocks of the video
backbones (models/video_backbone.py) attend over T*H*W tokens: at 224 px,
stage 3 of I3D-NL has 3136 queries against 784 pooled keys. The kernels
(csrc/nonlocal_attn.cu) keep the (queries x keys) logits on chip and write
only the (queries x d) output. There are two, both written by hand:
``nl_attn_fwd_wgmma`` (Hopper's warpgroup tensor-core instruction, register
accumulators, a K/V ring filled ahead of the products) takes bfloat16 and
float16 at d in {64, 128, 256, 512}; ``nl_attn_fwd`` takes float32 and
every other width. :func:`kernel_entry` says which, from dtype and d alone.
Each entry is a template over its element type; the C entries take the
dtype as a code (:data:`DTYPE_CODES`).

Training adds two backward entries (the gradient: dQ, dK and dV from dO,
recomputing the probabilities from each row's log-sum-exp, which either
forward entry writes on request): ``nl_attn_bwd_wgmma`` (wgmma, register
accumulators, a cp.async ring) takes bfloat16 and float16 at the same four
widths, ``nl_attn_bwd`` float32 and every other width;
:func:`bwd_kernel_entry` routes as :func:`kernel_entry` does. In float16 the
backward scales dS by a power of two before rounding it (:func:`ds_scale`):
float16's range ends at 2^-24, where a training step's small dS would round
to zero. :class:`NonLocalAttnFn` is the
``torch.autograd.Function`` around the routed forward and the routed
backward; :func:`nonlocal_attention` takes it on CUDA when an input requires
grad.

Numerics follow the JAX package's ``_einsum_attention``, which is what it
runs at these shapes (and what ``jax.grad`` differentiates in training):
float32 logits and softmax, ``dot_product`` divided by the true key count,
the output cast to q's dtype, for float32, bfloat16 and float16 inputs
alike.
"""

from __future__ import annotations

from typing import Optional

import math

import torch

from . import _build

KINDS = ("softmax", "dot_product")
ENTRIES = ("nl_attn_fwd_wgmma", "nl_attn_fwd")  # the forward entries
BWD_ENTRY = "nl_attn_bwd"  # the wmma / float32 backward entry
WGMMA_BWD_ENTRY = "nl_attn_bwd_wgmma"
BWD_ENTRIES = (WGMMA_BWD_ENTRY, BWD_ENTRY)
WGMMA_WIDTHS = (64, 128, 256, 512)
LOG2E = math.log2(math.e)
# the C entries' dtype argument; the 16-bit types take the tensor cores
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HALF_DTYPES = (torch.bfloat16, torch.float16)
# float16's dS scale (csrc/nonlocal_attn.cu, bwd::ds_scale): the power of two
# that puts a bound on |dS| at 2^DS_TARGET, within 2^+-DS_MAX_SHIFT
DS_TARGET, DS_MAX_SHIFT = 14, 60

# kernel launches since the counts were last reset (a run resets them and
# reads them afterwards to show that its non-local blocks took the kernel,
# and which entry): the total, the same launches by C entry, backward
# included, and by dtype and C entry
LAUNCHES = 0
LAUNCHES_BY_ENTRY = {name: 0 for name in ENTRIES + BWD_ENTRIES}
LAUNCHES_BY_DTYPE = {str(dt).removeprefix("torch."): dict(LAUNCHES_BY_ENTRY)
                     for dt in DTYPE_CODES}

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

# The wgmma backward's tiling, mirrored from csrc/nonlocal_attn.cu (namespace
# wgb; tests hold the two equal): rows of one warpgroup, ring slots, the
# widest output one warpgroup keeps, queries a streamed tile of the dK / dV
# pass (and at d = 512), keys a streamed tile of the dQ pass at d <= 128, 256
# and 512.
WGMMA_BWD_ROWS = 64
WGMMA_BWD_STAGES = 2
WGMMA_BWD_CHUNK = 256
WGMMA_BWD_KV_BLOCK_Q = 64
WGMMA_BWD_KV_BLOCK_Q_WIDE = 16
WGMMA_BWD_Q_BLOCK_K = 64
WGMMA_BWD_Q_BLOCK_K_MID = 32
WGMMA_BWD_Q_BLOCK_K_WIDE = 16


def reset_launches() -> None:
    """Set the launch counts to 0."""
    global LAUNCHES
    LAUNCHES = 0
    for counts in (LAUNCHES_BY_ENTRY, *LAUNCHES_BY_DTYPE.values()):
        for name in counts:
            counts[name] = 0


def _count(entry: str, dtype: torch.dtype) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_ENTRY[entry] += 1
    LAUNCHES_BY_DTYPE[str(dtype).removeprefix("torch.")][entry] += 1


def kernel_entry(dtype: torch.dtype, d: int) -> str:
    """The C entry that takes (dtype, d): a pure function of the two,
    decided before any launch. Raises on what neither kernel takes."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"fused_attention: {dtype}; float32, bfloat16 or "
                        "float16 only")
    if d % 8 or not 8 <= d <= 512:
        raise ValueError(
            f"fused_attention takes 8 <= d <= 512 with d % 8 == 0; got d={d}")
    if dtype in HALF_DTYPES and d in WGMMA_WIDTHS:
        return "nl_attn_fwd_wgmma"
    return "nl_attn_fwd"


def bwd_kernel_entry(dtype: torch.dtype, d: int) -> str:
    """The backward's C entry for (dtype, d), as :func:`kernel_entry` routes
    the forward: bfloat16 and float16 at d in {64, 128, 256, 512} to the
    wgmma kernel, everything else to ``nl_attn_bwd``. Raises on what neither
    takes."""
    if kernel_entry(dtype, d) == "nl_attn_fwd_wgmma":
        return WGMMA_BWD_ENTRY
    return BWD_ENTRY


def wgmma_block_k(d: int) -> int:
    """Keys per tile of the wgmma kernel at head width d."""
    return WGMMA_BLOCK_K_SPLIT if d > WGMMA_SPLIT_ABOVE else WGMMA_BLOCK_K


def wgmma_smem_bytes(d: int, block_k: int, stages: int) -> int:
    """Shared memory of one block of the wgmma kernel, as its ``Cfg`` struct
    computes it: alignment slack, the 16-bit Q tile (128 query rows, 64 where
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
    scale: float, block_k: int, return_lse: bool = False,
):
    """Plain PyTorch version that repeats the wgmma kernel's arithmetic step
    by step: key tiles of ``block_k`` with the keys past Sk masked, a running
    max and sum, exp2 with scale * log2(e) folded into one factor, the
    probabilities rounded to q's dtype before the P V product, float32
    accumulation, one division at the end. For the tests and the on-card
    comparison; nothing on the model's path calls it.

    ``return_lse``: also return the rows' log-sum-exp as the kernels write
    it, (B, Sq) float32 in the log2 domain (m + log2 l of the running max
    and sum), or None for dot_product."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    b, sq, d = q.shape
    sk = k.shape[1]
    wd = _work_dtype(q)
    qf, kf, vf = q.to(wd), k.to(wd), v.to(wd)
    acc = torch.zeros((b, sq, d), dtype=wd, device=q.device)
    m_run = torch.full((b, sq, 1), -math.inf, dtype=wd, device=q.device)
    l_run = torch.zeros((b, sq, 1), dtype=wd, device=q.device)
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
        acc = acc + torch.bmm(p.to(q.dtype).to(wd), vt)
    lse = None
    if kind == "softmax":
        acc = acc / l_run
        lse = (m_run + torch.log2(l_run)).squeeze(-1)
    out = acc.to(q.dtype)
    return (out, lse) if return_lse else out


def _work_dtype(q: torch.Tensor) -> torch.dtype:
    """float32, the kernels' accumulation type; float64 inputs (gradcheck)
    keep float64."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _check_cuda_inputs(fn: str, named) -> None:
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} is on {t.device}, not CUDA")
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{fn}: {name} is {t.dtype}; "
                            "float32, bfloat16 or float16 only")
        if t.dim() != 3:
            raise ValueError(f"{fn}: {name} must be (B, S, d), "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous "
                             "and 16-byte aligned")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{fn} is not differentiable: {name} "
                               "requires grad (use NonLocalAttnFn)")


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kind: str = "softmax", scale: Optional[float] = None,
    entry: Optional[str] = None, with_lse: bool = False,
):
    """The CUDA kernels: same contract as :func:`attention_reference`
    (``scale`` defaults to d**-0.5). Forward only. Raises on anything the
    kernels do not take: a non-CUDA tensor, a dtype other than float32,
    bfloat16 or float16, mismatched shapes, a non-contiguous or misaligned input,
    d % 8 != 0 or d > 512, or an input that requires grad while grad is
    enabled.

    :func:`kernel_entry` picks the C entry from dtype and d. ``entry`` forces
    one of :data:`ENTRIES` instead (to time both side by side) and raises if
    that entry does not take the input: ``nl_attn_fwd`` takes everything
    listed above, ``nl_attn_fwd_wgmma`` only what ``kernel_entry`` routes to
    it.

    ``with_lse``: return ``(out, lse)``, lse the rows' log-sum-exp in the
    log2 domain, (B, Sq) float32, written by the same launch (None for
    dot_product); the backward reads it."""
    if entry is not None and entry not in ENTRIES:
        raise ValueError(f"entry must be one of {ENTRIES}, got {entry!r}")
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    _check_cuda_inputs("fused_attention", (("q", q), ("k", k), ("v", v)))
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
            f"nl_attn_fwd_wgmma takes bfloat16 or float16 with d in "
            f"{WGMMA_WIDTHS}; got {q.dtype}, d={d}")
    if scale is None:
        scale = float(d) ** -0.5
    out = torch.empty_like(q)
    lse = None
    if with_lse and kind == "softmax":
        lse = torch.empty((b, sq), dtype=torch.float32, device=q.device)
    lib = _build.load_nonlocal_attn()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, sq, sk, d, KINDS.index(kind), float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn = getattr(lib, entry)
        err = fn(*args, DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    _count(entry, q.dtype)
    return (out, lse) if with_lse else out


# The backward kernel's tiles, mirrored from csrc/nonlocal_attn.cu (namespace
# bwd, struct Cfg): (rows of the block's own tile, rows streamed past it) of
# the dK / dV pass (own keys, streamed queries) and of the dQ pass (own
# queries, streamed keys), by dtype and head width rounded up to 64 / 128 /
# 256 / 512. tests hold the two equal.
BWD_SMEM_LIMIT = 232448


def padded_width(d: int) -> int:
    """d rounded up to the kernels' 64, 128, 256 or 512."""
    return next(w for w in WGMMA_WIDTHS if d <= w)


def bwd_tiles(dtype: torch.dtype, d: int) -> dict:
    """{'kv': (keys, queries), 'q': (queries, keys)} per tile of the two
    backward passes (bfloat16 and float16 alike)."""
    dp = padded_width(d)
    if dtype in HALF_DTYPES:
        if dp >= 512:
            return {"kv": (16, 32), "q": (32, 32)}
        if dp == 256:
            return {"kv": (32, 64), "q": (64, 32)}
        return {"kv": (64, 64), "q": (64, 64)}
    n = 16 if dp >= 512 else 32
    return {"kv": (n, n), "q": (n, n)}


def bwd_smem_bytes(dtype: torch.dtype, d: int, kv: bool) -> int:
    """Shared memory of one block of a backward pass, as ``bwd::Cfg``
    computes it: two own tiles, the float accumulators (two for dK / dV),
    two streamed tiles, S and dP in float, P and dS in the input type, and
    the rows' statistics, each region aligned to 128 bytes."""
    size = 2 if dtype in HALF_DTYPES else 4
    dp = padded_width(d)
    na, ns = bwd_tiles(dtype, d)["kv" if kv else "q"]
    qrows, kcols = (ns, na) if kv else (na, ns)
    ldt, lda = dp + 16 // size, dp + 4
    lds, ldp = kcols + 4, kcols + 16 // size
    a128 = lambda n: -(-n // 128) * 128
    return (a128(size * 2 * na * ldt) + a128(4 * (2 if kv else 1) * na * lda)
            + a128(size * 2 * ns * ldt) + 2 * a128(4 * qrows * lds)
            + 2 * a128(size * qrows * ldp) + 4 * 2 * qrows)


def bwd_wgmma_tiles(d: int) -> dict:
    """{'kv': (keys, queries), 'q': (queries, keys)} per block and streamed
    tile of the wgmma backward's two passes at d in {64, 128, 256, 512}, as
    ``wgb::Cfg`` sets them: 64 own keys against 64 queries (16 at d = 512);
    128 own queries (64 at d = 512) against 64 keys (32 at d = 256, 16 at
    d = 512)."""
    if d not in WGMMA_WIDTHS:
        raise ValueError(f"{WGMMA_BWD_ENTRY} takes d in {WGMMA_WIDTHS}, got {d}")
    wide = d > WGMMA_BWD_CHUNK
    block_q = WGMMA_BWD_KV_BLOCK_Q_WIDE if wide else WGMMA_BWD_KV_BLOCK_Q
    block_k = (WGMMA_BWD_Q_BLOCK_K_WIDE if wide else WGMMA_BWD_Q_BLOCK_K
               if d <= 128 else WGMMA_BWD_Q_BLOCK_K_MID)
    q_rows = WGMMA_BWD_ROWS * (1 if wide else 2)
    return {"kv": (WGMMA_BWD_ROWS, block_q), "q": (q_rows, block_k)}


def bwd_wgmma_smem_bytes(d: int, kv: bool) -> int:
    """Shared memory of one block of a wgmma backward pass, as ``wgb::Cfg``
    computes it. dK / dV: alignment slack, K and V of 64 keys, ring slots of
    one Q and one dO tile, the slots' lse and D vectors, the float32 P^T
    hand-over tile; dQ: slack, Q and dO of the block's rows, ring slots of
    one K and one V tile."""
    tiles = bwd_wgmma_tiles(d)
    if kv:
        keys, block_q = tiles["kv"]
        return (WGMMA_SMEM_ALIGN + 2 * keys * d * 2
                + WGMMA_BWD_STAGES * 2 * block_q * d * 2
                + WGMMA_BWD_STAGES * 2 * block_q * 4 + keys * block_q * 4)
    q_rows, block_k = tiles["q"]
    return (WGMMA_SMEM_ALIGN + 2 * q_rows * d * 2
            + WGMMA_BWD_STAGES * 2 * block_k * d * 2)


def fused_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: Optional[torch.Tensor], kind: str = "softmax",
    scale: Optional[float] = None, entry: Optional[str] = None,
):
    """The backward kernels: (dq, dk, dv) in q's dtype from the forward's
    inputs, its output ``o``, the output's gradient ``do`` and, for softmax,
    the rows' log-sum-exp ``lse`` that ``fused_attention(...,
    with_lse=True)`` returned. Takes float32, bfloat16 and float16 at every d
    the forward takes; raises on anything else, as :func:`fused_attention`.

    :func:`bwd_kernel_entry` picks the C entry from dtype and d. ``entry``
    forces one of :data:`BWD_ENTRIES` instead and raises if that entry does
    not take the input: ``nl_attn_bwd`` takes everything listed above,
    ``nl_attn_bwd_wgmma`` only what ``bwd_kernel_entry`` routes to it. One
    call counts one launch, whatever the entry launches inside."""
    if entry is not None and entry not in BWD_ENTRIES:
        raise ValueError(f"entry must be one of {BWD_ENTRIES}, got {entry!r}")
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if entry == WGMMA_BWD_ENTRY and not (
            q.dtype in HALF_DTYPES and q.shape[-1] in WGMMA_WIDTHS):
        raise ValueError(
            f"{WGMMA_BWD_ENTRY} takes bfloat16 or float16 with d in "
            f"{WGMMA_WIDTHS}; got {q.dtype}, d={q.shape[-1]}")
    _check_cuda_inputs("fused_attention_backward", (
        ("q", q), ("k", k), ("v", v), ("o", o), ("do", do)))
    b, sq, d = q.shape
    sk = k.shape[1]
    if (k.shape != (b, sk, d) or v.shape != k.shape or o.shape != q.shape
            or do.shape != q.shape
            or any(t.dtype != q.dtype or t.device != q.device
                   for t in (k, v, o, do))):
        raise ValueError(
            "fused_attention_backward: q, o and do (B, Sq, d), k and v "
            "(B, Sk, d) of one dtype and device, got "
            f"{[tuple(t.shape) for t in (q, k, v, o, do)]}")
    routed = bwd_kernel_entry(q.dtype, d)  # raises on what neither takes
    entry = entry or routed
    if sq < 1 or sk < 1 or not 1 <= b <= 65535:
        raise ValueError(f"fused_attention_backward takes Sq, Sk >= 1 and "
                         f"1 <= B <= 65535; got B={b}, Sq={sq}, Sk={sk}")
    delta = None
    if kind == "softmax":
        if (lse is None or lse.shape != (b, sq) or lse.dtype != torch.float32
                or lse.device != q.device or not lse.is_contiguous()):
            raise ValueError("fused_attention_backward: softmax needs the "
                             "forward's (B, Sq) float32 lse")
        delta = torch.empty((b, sq), dtype=torch.float32, device=q.device)
    if scale is None:
        scale = float(d) ** -0.5
    # float16's dS scale: the largest squared row norms of dO and V, as
    # float32 bits, reduced by the kernels' first launch
    bound = (torch.zeros(2, dtype=torch.int32, device=q.device)
             if q.dtype == torch.float16 else None)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.load_nonlocal_attn()
    ptr = lambda t: None if t is None else t.data_ptr()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), ptr(lse if kind == "softmax" else None), ptr(delta),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, d,
            KINDS.index(kind), float(scale), ptr(bound),
            DTYPE_CODES[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    _count(entry, q.dtype)
    return dq, dk, dv


def ds_scale(do: torch.Tensor, v: torch.Tensor, kind: str, scale: float,
             sk: int) -> float:
    """The power of two by which the backward kernels scale dS before
    rounding it to float16, and dK, dQ back after their sums (1.0 for the
    other dtypes): ``bwd::ds_scale`` of csrc/nonlocal_attn.cu, from the
    largest squared row norms of ``do`` and ``v`` in float32. It puts the
    bound 2 scale |dO_i| |V_j| (softmax; |dO_i| |V_j| / Sk for dot_product)
    on |dS| at 2^DS_TARGET: float16 then keeps dS down to 2^-38 of that
    bound, where unscaled it would round everything under 2^-24 to zero."""
    if do.dtype != torch.float16:
        return 1.0
    n_do = (do.float() ** 2).sum(-1).max()
    n_v = (v.float() ** 2).sum(-1).max()
    c = torch.tensor(2.0 * scale if kind == "softmax" else 1.0 / sk,
                     dtype=torch.float32)
    b2 = float(c * c * n_do.cpu() * n_v.cpu())
    if not b2 > 0:
        return 1.0
    k = math.floor(DS_TARGET - 0.5 * math.log2(b2))
    return 2.0 ** max(-DS_MAX_SHIFT, min(DS_MAX_SHIFT, k))


def attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, kind: str, scale: float,
):
    """Plain PyTorch version of the backward, in float32 math, cast to q's
    dtype: the softmax recomputed whole, D = rowsum(dO o O) from the given
    output (as the kernel takes it), dS = P (dP - D) scaled, or dP / Sk for
    dot_product."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    wd = _work_dtype(q)
    qf, kf, vf, of, dof = (t.to(wd) for t in (q, k, v, o, do))
    logits = torch.bmm(qf, kf.transpose(1, 2))
    dp = torch.bmm(dof, vf.transpose(1, 2))
    if kind == "softmax":
        p = torch.softmax(logits * scale, dim=-1)
        ds = scale * p * (dp - (dof * of).sum(-1, keepdim=True))
    else:
        p = logits / logits.shape[-1]
        ds = dp / logits.shape[-1]
    dq = torch.bmm(ds, kf)
    dk = torch.bmm(ds.transpose(1, 2), qf)
    dv = torch.bmm(p.transpose(1, 2), dof)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def attention_backward_tiled_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: Optional[torch.Tensor], kind: str, scale: float,
    block_q: Optional[int] = None, block_k: Optional[int] = None,
    entry: Optional[str] = None,
):
    """Plain PyTorch version that repeats the backward kernels' arithmetic:
    tiles of ``block_q`` queries and ``block_k`` keys (by default the dK /
    dV pass's of ``entry``: ``nl_attn_bwd_wgmma``'s for
    :func:`bwd_wgmma_tiles`, else ``nl_attn_bwd``'s, which is also what
    float64 and other widths take), P recomputed from the stored log-sum-exp
    as 2^(S scale log2 e - lse) with the rows and keys past the ends masked,
    D = rowsum(dO o O), P and dS rounded to q's dtype before the products
    that take them (dS times :func:`ds_scale`, and dK, dQ divided by it
    after their sums), float32 accumulation. For the tests and the on-card
    comparison."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    b, sq, d = q.shape
    sk = k.shape[1]
    if entry == WGMMA_BWD_ENTRY:
        kv_tiles = bwd_wgmma_tiles(d)["kv"]
    elif entry in (None, BWD_ENTRY):
        kv_tiles = bwd_tiles(q.dtype, d)["kv"]
    else:
        raise ValueError(f"entry must be one of {BWD_ENTRIES}, got {entry!r}")
    block_q = block_q or kv_tiles[1]
    block_k = block_k or kv_tiles[0]
    wd = _work_dtype(q)
    qf, kf, vf, dof = (t.to(wd) for t in (q, k, v, do))
    delta = (dof * o.to(wd)).sum(-1)
    mult = ds_scale(do, v, kind, scale, sk)
    c2 = scale * LOG2E
    dq = torch.zeros((b, sq, d), dtype=wd, device=q.device)
    dk = torch.zeros((b, sk, d), dtype=wd, device=q.device)
    dv = torch.zeros((b, sk, d), dtype=wd, device=q.device)
    for q0 in range(0, sq, block_q):
        qs = slice(q0, q0 + block_q)
        for k0 in range(0, sk, block_k):
            ks = slice(k0, k0 + block_k)
            s = torch.bmm(qf[:, qs], kf[:, ks].transpose(1, 2))
            dp = torch.bmm(dof[:, qs], vf[:, ks].transpose(1, 2))
            if kind == "softmax":
                p = torch.exp2(s * c2 - lse[:, qs, None])
                ds = scale * p * (dp - delta[:, qs, None])
            else:
                p, ds = s / sk, dp / sk
            p, ds = p.to(q.dtype).to(wd), (ds * mult).to(q.dtype).to(wd)
            dv[:, ks] += torch.bmm(p.transpose(1, 2), dof[:, qs])
            dk[:, ks] += torch.bmm(ds.transpose(1, 2), qf[:, qs])
            dq[:, qs] += torch.bmm(ds, kf[:, ks])
    return tuple(t.to(q.dtype) for t in (dq / mult, dk / mult, dv))


def _kernel_forward(q, k, v, kind, scale):
    return fused_attention(q, k, v, kind, scale, with_lse=True)


def _kernel_backward(q, k, v, o, do, lse, kind, scale):
    return fused_attention_backward(q, k, v, o, do, lse, kind, scale)


class NonLocalAttnFn(torch.autograd.Function):
    """Attention with the kernels on both sides: the routed forward entry
    (which also writes the rows' log-sum-exp) and the routed backward entry
    (:func:`bwd_kernel_entry`: ``nl_attn_bwd_wgmma`` for bfloat16 and
    float16 at the four widths). Saves q, k, v, the output and the statistics.

    ``forward_impl(q, k, v, kind, scale) -> (out, lse)`` and
    ``backward_impl(q, k, v, out, dout, lse, kind, scale) -> (dq, dk, dv)``
    are the kernel wrappers; a test may set them to the tiled plain versions
    to run the wiring on the CPU."""

    forward_impl = staticmethod(_kernel_forward)
    backward_impl = staticmethod(_kernel_backward)

    @staticmethod
    def forward(ctx, q, k, v, kind: str, scale: float):
        out, lse = NonLocalAttnFn.forward_impl(
            q.detach(), k.detach(), v.detach(), kind, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kind, ctx.scale = kind, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = NonLocalAttnFn.backward_impl(
            q.detach(), k.detach(), v.detach(), out.detach(),
            dout.contiguous(), lse, ctx.kind, ctx.scale)
        return dq, dk, dv, None, None


def nonlocal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kind: str,
    scale: float,
) -> torch.Tensor:
    """Dispatch by device: CPU tensors take :func:`attention_reference`
    (under autograd when an input requires grad); CUDA tensors the kernel,
    forward only, or :class:`NonLocalAttnFn` when grad is enabled and an
    input requires grad. The kernels raise on what they do not take."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, kind, scale)
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return NonLocalAttnFn.apply(q, k, v, kind, scale)
    return fused_attention(q, k, v, kind, scale)
