"""Native (C++) components, loaded via ctypes with pure-Python fallback.

``load_bpe_core()`` compiles ``bpe_core.cpp`` once (g++ -O2 -shared) into
a cache dir and returns a ctypes handle factory, or None when no
toolchain is available / compilation fails / VIDSITU_NO_NATIVE=1 — the
callers (tokenization/bpe.py) then keep the pure-Python path. The two
implementations are asserted id-identical in tests/test_native_bpe.py.

``load_jpeg_core()`` / ``decode_resize_batch()``: batch JPEG decode +
Pillow-bit-identical resize on a C++ thread pool (jpeg_core.cpp) for
the data loader's worker-side hot path (reference pays this per frame
in torch DataLoader workers, dat_loader.py:454-475). Falls back to
None the same way (additionally when libjpeg is absent); callers
(data/frames.py) keep the PIL path.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

_SRC_DIR = Path(__file__).resolve().parent
_LOG = logging.getLogger(__name__)
_LIB = None
_LIB_FAILED = False


def _cache_dir() -> Optional[Path]:
    # default to a USER-OWNED cache (XDG), never the shared system
    # tempdir: a world-writable predictable path would let another
    # local user pre-plant a .so that we would then CDLL (arbitrary
    # code execution); ~/.cache is 0700-protected per user
    env_cache = os.environ.get("VIDSITU_NATIVE_CACHE")
    if env_cache:
        cache = Path(env_cache)
    else:
        xdg = os.environ.get("XDG_CACHE_HOME")
        base = Path(xdg) if xdg else Path.home() / ".cache"
        cache = base / "vidsitu_tpu" / "native"
    try:
        cache.mkdir(parents=True, exist_ok=True, mode=0o700)
    except OSError as e:
        # unwritable/uncreatable cache (read-only NFS, locked-down host): the
        # callers keep their pure-Python/PIL paths
        _LOG.info("native cache dir unavailable (%s): %s", cache, e)
        return None
    return cache


def _build(
    src_name: str,
    lib_stem: str,
    extra_flags=(),
    extra_deps=(),
    host_specific: bool = False,
    key_extra: str = "",
) -> Optional[Path]:
    src = _SRC_DIR / src_name
    cache = _cache_dir()
    if cache is None:
        return None
    key = str(sys.version_info[0]) + key_extra
    if host_specific:
        # -march=native output must never be shared across CPU models
        # (VIDSITU_NATIVE_CACHE on NFS across a heterogeneous fleet would
        # SIGILL mid-batch): key the filename on the CPU model
        import hashlib
        import platform

        model = ""
        try:
            with open("/proc/cpuinfo") as f:
                for ln in f:
                    if ln.startswith("model name"):
                        model = ln.split(":", 1)[1].strip()
                        break
        except OSError:
            pass
        key += "_" + hashlib.sha1(
            f"{platform.machine()}|{model}".encode()
        ).hexdigest()[:10]
    lib = cache / f"lib{lib_stem}_{key}.so"
    # staleness vs EVERY source the object depends on (e.g. the
    # generated unicode tables header, not just the .cpp)
    deps = [src] + [_SRC_DIR / d for d in extra_deps]
    newest_src = max(d.stat().st_mtime for d in deps if d.exists())
    if lib.exists() and lib.stat().st_mtime >= newest_src:
        return lib
    # compile to a private tmp then atomic-rename: a concurrent process
    # must never CDLL a half-written .so (and then cache the failure)
    tmp = lib.with_name(lib.name + f".tmp{os.getpid()}")
    cmd = [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
        str(src), "-o", str(tmp), *extra_flags,
    ]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=300
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        _LOG.info("native %s build unavailable: %s", lib_stem, e)
        tmp.unlink(missing_ok=True)
        return None
    if proc.returncode != 0:
        _LOG.warning(
            "native %s build failed:\n%s", lib_stem, proc.stderr[-2000:]
        )
        tmp.unlink(missing_ok=True)
        return None
    try:
        os.replace(tmp, lib)
    except OSError as e:
        _LOG.info("native %s publish failed: %s", lib_stem, e)
        tmp.unlink(missing_ok=True)
        return None
    return lib


def _runtime_unicode_header() -> Optional[Path]:
    """Regenerate unicode_tables.h from the RUNTIME regex module into
    the cache (keyed by regex version), so the C++ pre-tokenizer
    classifies \\p{L}/\\p{N}/\\s with exactly the Unicode DB the Python
    path uses — the committed header would silently diverge after a
    regex upgrade. Returns None (committed-header fallback) when regex
    is unavailable or the cache is unwritable."""
    try:
        import regex
    except ImportError:
        return None
    cache = _cache_dir()
    if cache is None:
        return None
    hdr = cache / f"unicode_tables_regex{regex.__version__}.h"
    if hdr.exists():
        return hdr
    from . import gen_unicode_tables

    tmp = hdr.with_name(hdr.name + f".tmp{os.getpid()}")
    try:
        with open(tmp, "w") as f:
            gen_unicode_tables.main(f)
        os.replace(tmp, hdr)
    except OSError as e:
        _LOG.info("unicode table regeneration failed: %s", e)
        tmp.unlink(missing_ok=True)
        return None
    return hdr


def _build_lib() -> Optional[Path]:
    hdr = _runtime_unicode_header()
    flags, deps, key = (), ["unicode_tables.h"], ""
    if hdr is not None:
        # quoted-include override; the .so cache key carries the regex
        # version so a downgrade never reuses a lib built against a
        # newer Unicode DB (mtime alone cannot tell them apart)
        flags = (f'-DVIDSITU_UNICODE_TABLES_OVERRIDE="{hdr}"',)
        deps.append(str(hdr))  # absolute: Path/'abs' resolves to abs
        import regex

        key = f"_u{regex.__version__}"
    return _build(
        "bpe_core.cpp", "bpe_core", extra_flags=flags,
        extra_deps=tuple(deps), key_extra=key,
    )


def load_bpe_core():
    """Returns the loaded ctypes library or None."""
    global _LIB, _LIB_FAILED
    if os.environ.get("VIDSITU_NO_NATIVE") == "1":
        return None
    if _LIB is not None:
        return _LIB
    if _LIB_FAILED:
        return None
    lib_path = _build_lib()
    if lib_path is None:
        _LIB_FAILED = True
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as e:
        _LOG.warning("native bpe load failed: %s", e)
        _LIB_FAILED = True
        return None
    lib.bpe_create.restype = ctypes.c_void_p
    lib.bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.bpe_destroy.argtypes = [ctypes.c_void_p]
    lib.bpe_encode.restype = ctypes.c_int32
    lib.bpe_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    _LIB = lib
    return _LIB


class NativeBPE:
    """ctypes wrapper over the C++ byte-level BPE encode core."""

    def __init__(self, vocab: dict, merges: List[tuple]):
        lib = load_bpe_core()
        if lib is None:
            raise RuntimeError("native bpe core unavailable")
        self._lib = lib
        vocab_buf = "".join(
            f"{tok}\t{idx}\n" for tok, idx in vocab.items()
        ).encode("utf-8")
        merges_buf = "".join(f"{a} {b}\n" for a, b in merges).encode("utf-8")
        self._handle = lib.bpe_create(vocab_buf, merges_buf)
        if not self._handle:
            raise RuntimeError("bpe_create failed")

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        cap = max(64, 2 * len(data) + 16)
        while True:
            out = (ctypes.c_int32 * cap)()
            n = self._lib.bpe_encode(
                self._handle, data, len(data), out, cap
            )
            if n >= 0:
                return list(out[:n])
            if n == -2:
                # non-closed vocab/merges: the pure-Python path raises
                # KeyError here — mirror it instead of dropping tokens
                raise KeyError(
                    f"BPE piece missing from vocab while encoding "
                    f"{text[:60]!r}"
                )
            cap *= 2  # -1: output buffer too small

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.bpe_destroy(self._handle)
        except Exception:
            pass


_JPEG_LIB = None
_JPEG_FAILED = False


def load_jpeg_core():
    """Returns the loaded jpeg ctypes library or None."""
    global _JPEG_LIB, _JPEG_FAILED
    if os.environ.get("VIDSITU_NO_NATIVE") == "1":
        return None
    if _JPEG_LIB is not None:
        return _JPEG_LIB
    if _JPEG_FAILED:
        return None
    lib_path = _build(
        "jpeg_core.cpp", "jpeg_core",
        # -march=native vectorizes the resample inner loops; the cache
        # filename is keyed on the CPU model (host_specific) so a shared
        # cache dir can never serve another host's instruction set
        extra_flags=("-O3", "-march=native", "-ljpeg"),
        host_specific=True,
    )
    if lib_path is None:
        _JPEG_FAILED = True
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as e:
        _LOG.warning("native jpeg load failed: %s", e)
        _JPEG_FAILED = True
        return None
    lib.jpeg_decode_resize_batch.restype = ctypes.c_int32
    lib.jpeg_decode_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.jpeg_pillow_resize_rgb.restype = None
    lib.jpeg_pillow_resize_rgb.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
    ]
    _JPEG_LIB = lib
    return _JPEG_LIB


def decode_resize_batch(paths, out_hw: int, n_threads: int = 0,
                        fast: bool = False):
    """Decode JPEG ``paths`` -> uint8 (N, out_hw, out_hw, 3), or None
    when the native core is unavailable (callers fall back to PIL).

    ``fast=False`` is BIT-IDENTICAL to
    ``np.asarray(Image.open(p).convert("RGB").resize((out_hw, out_hw)))``
    (decode parity + Pillow's exact fixed-point BICUBIC resample,
    tests/test_native_jpeg.py). ``fast=True`` decodes at the smallest
    sufficient DCT scale first — faster, not pixel-identical.
    ``n_threads=0`` uses the host's CPU count.

    Missing files raise FileNotFoundError (the PIL path raises too).
    Files libjpeg cannot decode straight to RGB (e.g. CMYK/YCCK JPEGs,
    which PIL's convert('RGB') handles) return None so the caller falls
    back to the PIL path for the batch.
    """
    import numpy as np

    lib = load_jpeg_core()
    if lib is None:
        return None
    paths = [str(p) for p in paths]
    n = len(paths)
    out = np.empty((n, out_hw, out_hw, 3), np.uint8)
    if n == 0:
        return out
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    rc = lib.jpeg_decode_resize_batch(
        arr, n, out.ctypes.data_as(ctypes.c_void_p), out_hw, out_hw,
        n_threads, 1 if fast else 0,
    )
    if rc != 0:
        bad = paths[-rc - 1]
        if not os.path.exists(bad):
            raise FileNotFoundError(bad)
        # decodable-by-PIL-but-not-by-this-core inputs (CMYK/YCCK color
        # spaces, exotic markers): fall back to the PIL path rather than
        # failing the whole 300-frame batch on one odd file
        _LOG.warning(
            "native jpeg decode failed for %s; falling back to PIL "
            "for this batch", bad,
        )
        return None
    return out


def pillow_resize_rgb(img, out_w: int, out_h: int):
    """Native Pillow-exact BICUBIC resample of a uint8 (H, W, 3) array
    (bit-parity test hook); None when the core is unavailable."""
    import numpy as np

    lib = load_jpeg_core()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    assert c == 3, img.shape
    out = np.empty((out_h, out_w, 3), np.uint8)
    lib.jpeg_pillow_resize_rgb(
        img.ctypes.data_as(ctypes.c_void_p), w, h,
        out.ctypes.data_as(ctypes.c_void_p), out_w, out_h,
    )
    return out
