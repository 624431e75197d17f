"""Beam-cache row gather: a hand-written CUDA kernel and its plain version.

Port of the TPU kernel ``beam_gather_rows_multi``
(benchmarks/probe_beam_gather.py:62). Beam search reorders its KV cache
after every step: for every cache leaf, ``out[r] = x[src_rows[r]]``. The
kernel (csrc/beam_gather.cu) does this for all leaves in one launch, into
new buffers. It moves bytes, so it takes any dtype and every row width: the
TPU routing's floor of 1024-element rows guarded a Mosaic tiling fault that
a GPU does not have.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from . import _build

# kernel launches since the count was last reset (a run sets it to 0 and
# reads it afterwards to show that its beam reorders took the kernel)
LAUNCHES = 0

INDEX_DTYPES = (torch.int32, torch.int64)


def beam_gather_rows_reference(leaves: Sequence[torch.Tensor],
                               src_rows: torch.Tensor) -> List[torch.Tensor]:
    """Plain PyTorch version: ``index_select`` of ``src_rows`` on axis 0 of
    every leaf."""
    return [x.index_select(0, src_rows) for x in leaves]


def beam_gather_rows(leaves: Sequence[torch.Tensor],
                     src_rows: torch.Tensor) -> List[torch.Tensor]:
    """The CUDA kernel: same contract as :func:`beam_gather_rows_reference`,
    one launch for all leaves, outputs in new buffers. Raises on anything
    the kernel does not take: a leaf or index off CUDA or on another device,
    a non-contiguous leaf, leaves with different leading dimensions, an
    index tensor that is not 1-D int32/int64, or more leaves than the
    kernel's parameter struct holds. An index out of range traps on the
    device."""
    global LAUNCHES
    leaves = list(leaves)
    if not leaves:
        raise ValueError("beam_gather_rows: no leaves")
    dev = leaves[0].device
    if dev.type != "cuda":
        raise ValueError(f"beam_gather_rows: leaf 0 is on {dev}, not CUDA")
    if src_rows.device != dev:
        raise ValueError(f"beam_gather_rows: src_rows is on {src_rows.device}, "
                         f"leaves on {dev}")
    if src_rows.dtype not in INDEX_DTYPES or src_rows.dim() != 1:
        raise TypeError("beam_gather_rows: src_rows must be 1-D int32 or "
                        f"int64, got {src_rows.dtype} {tuple(src_rows.shape)}")
    n_src = leaves[0].shape[0] if leaves[0].dim() else 0
    for i, x in enumerate(leaves):
        if x.device != dev:
            raise ValueError(f"beam_gather_rows: leaf {i} is on {x.device}, "
                             f"leaf 0 on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"beam_gather_rows: leaf {i} is not contiguous")
        if x.dim() < 1 or x.shape[0] != n_src:
            raise ValueError(
                "beam_gather_rows: every leaf needs the same leading "
                f"dimension; leaf {i} is {tuple(x.shape)}, leaf 0 "
                f"{tuple(leaves[0].shape)}")
    lib = _build.load_beam_gather()
    max_leaves = lib.beam_gather_max_leaves()
    if len(leaves) > max_leaves:
        raise ValueError(f"beam_gather_rows takes at most {max_leaves} leaves "
                         f"per launch, got {len(leaves)}")
    src_rows = src_rows.contiguous()
    n_out = src_rows.shape[0]
    outs = [torch.empty((n_out,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=dev) for x in leaves]
    if n_out == 0:
        return outs
    n = len(leaves)
    src_ptrs = (ctypes.c_void_p * n)(*[x.data_ptr() for x in leaves])
    dst_ptrs = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    row_bytes = (ctypes.c_longlong * n)(
        *[x.numel() // max(n_src, 1) * x.element_size() for x in leaves])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.beam_gather_rows(
            src_ptrs, dst_ptrs, row_bytes, n, src_rows.data_ptr(),
            int(src_rows.dtype == torch.int64), n_out, n_src, stream)
    if err:
        raise RuntimeError(f"beam_gather_rows launch failed: cudaError {err}")
    LAUNCHES += 1
    return outs


def gather_rows(leaves: Sequence[torch.Tensor],
                src_rows: torch.Tensor) -> List[torch.Tensor]:
    """Dispatch by device: CPU tensors take the plain version, CUDA tensors
    the kernel (which raises on what it does not take)."""
    if leaves and leaves[0].device.type == "cpu":
        return beam_gather_rows_reference(leaves, src_rows)
    return beam_gather_rows(leaves, src_rows)
