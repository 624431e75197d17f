"""Copy probes: three hand-written CUDA copies and their plain version.

Ports of the TPU probes ``pallas_copy`` (benchmarks/gates.py:86,
benchmarks/micro3.py:44), ``manual_copy`` (benchmarks/micro3.py:130) and
``hbm2hbm`` (benchmarks/micro3.py:158). They measure what a hand-written
kernel's data path moves on this card, beside the library's copy and one
elementwise operation (``vidsitu_tpu_torch.gates``, gate 1):

  * :func:`staged_copy`: device memory -> shared memory -> device memory in
    blocks of a caller-given shape, each block whole in shared memory;
  * :func:`pipelined_copy`: the same path through a two-slot ring filled by
    ``cp.async`` while the other slot is stored;
  * :func:`direct_copy`: device memory to device memory, no staging.

The kernels (csrc/copy_probe.cu) move bytes, so they take any dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

# kernel launches by kernel since the counts were last reset
LAUNCHES = {"staged_copy": 0, "pipelined_copy": 0, "direct_copy": 0}

SMEM_LIMIT = 232448  # bytes of shared memory one thread block can have
# persistent thread blocks per SM: two 64 KB rings fit an SM beside each
# other; the direct copy keeps 16 blocks of 256 threads in flight
PIPELINED_BLOCKS_PER_SM = 2
DIRECT_BLOCKS_PER_SM = 16


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of every probe: a copy."""
    return x.clone()


def check_block(x: torch.Tensor, block: Tuple[int, int]) -> None:
    """Raise unless ``block`` = (rows, columns) is a block shape
    :func:`staged_copy` takes for the 2-D ``x``: it divides the array, its
    rows are whole 16-byte vectors, and it fits shared memory."""
    if x.dim() != 2:
        raise ValueError(f"staged_copy takes a 2-D tensor, got {tuple(x.shape)}")
    bm, bn = int(block[0]), int(block[1])
    rows, cols = x.shape
    if bm < 1 or bn < 1 or rows % bm or cols % bn:
        raise ValueError(f"block {block} does not divide {tuple(x.shape)}")
    if bn * x.element_size() % 16 or cols * x.element_size() % 16:
        raise ValueError(
            f"block rows of {bn * x.element_size()} bytes are not whole "
            "16-byte vectors")
    need = bm * bn * x.element_size()
    if need > SMEM_LIMIT:
        raise ValueError(
            f"block {block} of {x.dtype} needs {need} bytes of shared "
            f"memory; a thread block has at most {SMEM_LIMIT}")


def _check_cuda(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensor is on {x.device}, not CUDA")
    if not x.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")
    if x.numel() == 0 or x.numel() * x.element_size() % 16:
        raise ValueError(f"{name}: {x.numel() * x.element_size()} bytes is "
                         "not a positive multiple of 16")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: storage is not 16-byte aligned")


def _launched(name: str, err: int) -> None:
    if err == -2:
        raise ValueError(f"{name}: does not fit shared memory")
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def staged_copy(x: torch.Tensor, block: Tuple[int, int] = (32, 2048)
                ) -> torch.Tensor:
    """The staged copy kernel on a 2-D CUDA tensor, ``block`` = (rows,
    columns) per thread block. Raises on a block shape the kernel does not
    take (:func:`check_block`)."""
    _check_cuda("staged_copy", x)
    check_block(x, block)
    out = torch.empty_like(x)
    es = x.element_size()
    with torch.cuda.device(x.device):
        err = _build.load_copy_probe().staged_copy(
            x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1] * es,
            int(block[0]), int(block[1]) * es,
            torch.cuda.current_stream(x.device).cuda_stream)
    _launched("staged_copy", err)
    return out


def pipelined_copy(x: torch.Tensor, chunk_bytes: int = 32768) -> torch.Tensor:
    """The two-slot ``cp.async`` ring copy on a CUDA tensor of any shape."""
    _check_cuda("pipelined_copy", x)
    if chunk_bytes < 16 or chunk_bytes % 16 or 2 * chunk_bytes > SMEM_LIMIT:
        raise ValueError(
            f"chunk_bytes={chunk_bytes}: two chunks of whole 16-byte vectors "
            f"must fit {SMEM_LIMIT} bytes of shared memory")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _build.load_copy_probe().pipelined_copy(
            x.data_ptr(), out.data_ptr(), x.numel() * x.element_size(),
            int(chunk_bytes), PIPELINED_BLOCKS_PER_SM,
            torch.cuda.current_stream(x.device).cuda_stream)
    _launched("pipelined_copy", err)
    return out


def direct_copy(x: torch.Tensor) -> torch.Tensor:
    """The unstaged grid-stride copy kernel on a CUDA tensor of any shape."""
    _check_cuda("direct_copy", x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _build.load_copy_probe().direct_copy(
            x.data_ptr(), out.data_ptr(), x.numel() * x.element_size(),
            DIRECT_BLOCKS_PER_SM,
            torch.cuda.current_stream(x.device).cuda_stream)
    _launched("direct_copy", err)
    return out


KERNELS = {"staged_copy": staged_copy, "pipelined_copy": pipelined_copy,
           "direct_copy": direct_copy}


def probe_copy(x: torch.Tensor, kind: str, **kwargs) -> torch.Tensor:
    """Dispatch by device: a CPU tensor takes the plain version (after the
    block-shape check of the staged kind), a CUDA tensor the kernel ``kind``
    (which raises on what it does not take)."""
    if kind not in KERNELS:
        raise ValueError(f"unknown copy probe {kind!r}; one of {list(KERNELS)}")
    if x.device.type == "cpu":
        if kind == "staged_copy" and "block" in kwargs:
            check_block(x, kwargs["block"])
        return copy_plain(x)
    return KERNELS[kind](x, **kwargs)
