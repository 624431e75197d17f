"""Build and load the port's CUDA kernels (nvcc by hand + ctypes).

The sources under ``vidsitu_tpu_torch/csrc/`` have a plain C interface, so
``nvcc`` compiles each one in seconds into a shared library under
``vidsitu_tpu_torch/_build/``, named by the hash of its source and flags: a
changed source builds anew, an unchanged one is loaded from disk. Nothing is
built at import time; the first launch builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import uuid
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of vidsitu_tpu_torch are built from source at first use"
    )


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/{name}.cu`` unless its hashed library exists; returns
    the library path. The compiler's resource report (``-Xptxas -v``) goes
    to ``_build/{name}.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{uuid.uuid4().hex[:8]}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {name}.cu:\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return out


@functools.cache
def load_nonlocal_attn() -> ctypes.CDLL:
    """The non-local attention library (both forward entries and the
    backward), built on first call."""
    lib = ctypes.CDLL(str(build("nonlocal_attn")))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    shared = [ptr] * 5 + [i32] * 5 + [ctypes.c_float]  # q k v o lse ...
    lib.nl_attn_fwd.argtypes = shared + [i32, ptr]  # is_bf16, stream
    lib.nl_attn_fwd_wgmma.argtypes = shared + [ptr]
    lib.nl_attn_bwd.argtypes = [ptr] * 10 + [i32] * 5 + [ctypes.c_float,
                                                         i32, ptr]
    lib.nl_attn_fwd.restype = lib.nl_attn_fwd_wgmma.restype = i32
    lib.nl_attn_bwd.restype = i32
    return lib


@functools.cache
def load_beam_gather() -> ctypes.CDLL:
    """The beam-cache row-gather library, built on first call."""
    lib = ctypes.CDLL(str(build("beam_gather")))
    fn = lib.beam_gather_rows
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.beam_gather_max_leaves.argtypes = []
    lib.beam_gather_max_leaves.restype = ctypes.c_int
    return lib


@functools.cache
def load_fused_bottleneck() -> ctypes.CDLL:
    """The fused inference bottleneck library (both kernels, four entries),
    built on first call."""
    lib = ctypes.CDLL(str(build("fused_bottleneck")))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_bottleneck_frames.argtypes = [ptr] * 10 + [i32] * 8 + [ptr]
    lib.fused_bottleneck_frames.restype = i32
    lib.fused_bottleneck_multi.argtypes = (
        [ptr] * 8 + [i32] * 9 + [ctypes.POINTER(i32), ptr])
    lib.fused_bottleneck_multi.restype = i32
    lib.fused_bottleneck_frames_wgmma.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
    lib.fused_bottleneck_multi_wgmma.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
    lib.fused_bottleneck_wgmma_smem_bytes.argtypes = [i32]
    for fn in (lib.fused_bottleneck_frames_wgmma,
               lib.fused_bottleneck_multi_wgmma,
               lib.fused_bottleneck_wgmma_smem_bytes):
        fn.restype = i32
    return lib


@functools.cache
def load_copy_probe() -> ctypes.CDLL:
    """The copy-probe library (staged, pipelined and direct copies), built
    on first call."""
    lib = ctypes.CDLL(str(build("copy_probe")))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.staged_copy.argtypes = [ptr, ptr, i64, i64, i32, i32, ptr]
    lib.pipelined_copy.argtypes = [ptr, ptr, i64, i32, i32, ptr]
    lib.direct_copy.argtypes = [ptr, ptr, i64, i32, ptr]
    for fn in (lib.staged_copy, lib.pipelined_copy, lib.direct_copy):
        fn.restype = i32
    return lib
