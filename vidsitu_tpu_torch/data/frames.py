"""Frame sampling, decoding and pathway packing (host-side, numpy).

TPU-native layout decision: frames are emitted **channels-last**
(T, H, W, C) — the canonical JAX/XLA conv layout — instead of the
reference's torch NCTHW (video_utils.py:41-74). Sampling/normalization
semantics match the reference exactly.
"""

from __future__ import annotations

import os
import uuid
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from PIL import Image


def get_sequence(
    center_idx: int, half_len: int, sample_rate: int, max_num_frames: int
) -> List[int]:
    """64-frame window around the event center, clamped to [0, max)
    (reference: utils/video_utils.py:18-38)."""
    seq = list(range(center_idx - half_len, center_idx + half_len, sample_rate))
    return [min(max(ix, 0), max_num_frames - 1) for ix in seq]


def read_img(img_fpath, out_hw: int = 224) -> np.ndarray:
    """JPEG -> RGB uint8 (H, W, C), resized (reference: dat_loader.py:183-191)."""
    img = Image.open(img_fpath).convert("RGB")
    img = img.resize((out_hw, out_hw))
    return np.asarray(img)


def read_img_batch(
    paths, out_hw: int = 224, threads: int = 1, fast: bool = False
) -> np.ndarray:
    """Decode a batch of JPEGs -> uint8 (N, out_hw, out_hw, 3).

    Routes through the C++ batch core (native/jpeg_core.cpp: libjpeg +
    Pillow-bit-identical fixed-point BICUBIC resample on a thread pool
    — the TPU-native analog of the decode the reference pays inside
    torch DataLoader workers, dat_loader.py:454-475) and falls back to
    the per-frame PIL path when the core is unavailable
    (VIDSITU_NO_NATIVE=1 / no toolchain / no libjpeg). ``fast=True``
    uses DCT-scaled decode: faster, NOT pixel-identical to PIL — only
    for opt-in cache building. The default path is bit-identical either
    way (tests/test_native_jpeg.py).
    """
    from ..native import decode_resize_batch

    out = decode_resize_batch(paths, out_hw, n_threads=threads, fast=fast)
    if out is not None:
        return out
    # PIL fallback (ignores ``fast`` — exact is the only Python path)
    return np.stack([read_img(p, out_hw=out_hw) for p in paths])


def _n_avail_frames(frm_dir, vid_seg_name: str, max_frms: int) -> int:
    """Frames present on disk for a segment, capped at ``max_frms``.

    Prep (and the reference's strict check, dwn_yt.py:169-176) accept a
    segment with >= 290 frames, while the sampling geometry indexes up
    to frame 300 — a 290-299-frame segment is therefore legal input and
    must not crash the loader. Fast path: one exists() on the last
    frame; only a short segment pays the directory scan. ffmpeg dumps
    frames contiguously from 1, so the file count IS the top index."""
    d = Path(frm_dir) / vid_seg_name
    if (d / f"{vid_seg_name}_{max_frms:06d}.jpg").exists():
        return max_frms
    return min(len(list(d.glob(f"{vid_seg_name}_*.jpg"))), max_frms)


def _frame_paths(frm_dir, vid_seg_name: str, idxs, max_frms: int):
    """0-based frame indices -> JPEG paths, edge-clamped to the frames
    actually on disk (same clamp-to-edge semantics get_sequence already
    applies at the [0, max) boundary)."""
    def mk(ix: int) -> str:
        return f"{frm_dir}/{vid_seg_name}/{vid_seg_name}_{ix + 1:06d}.jpg"

    if os.path.exists(mk(max(idxs))):
        return [mk(ix) for ix in idxs]
    n = _n_avail_frames(frm_dir, vid_seg_name, max_frms)
    if n == 0:
        raise FileNotFoundError(mk(0))
    return [mk(min(ix, n - 1)) for ix in idxs]


def segment_cache_path(
    cache_dir, vid_seg_name: str, out_hw: int, fast: bool = False
) -> Path:
    """Cache file for one segment's decoded frames, keyed by resolution
    AND decode mode (sampling geometry stays free: the full 300-frame
    track is cached). ``fast`` caches (DCT-scaled decode, not
    pixel-identical to PIL) get a distinct suffix so they can never
    silently poison an exact-path reader sharing the cache_dir."""
    suffix = "_fast" if fast else ""
    return Path(cache_dir) / f"{vid_seg_name}_{out_hw}{suffix}.npy"


def write_segment_cache(
    frm_dir,
    vid_seg_name: str,
    cache_dir,
    out_hw: int,
    max_frms: int = 300,
    threads: int = 1,
    fast: bool = False,
    force: bool = False,
) -> Path:
    """One-time decode of a segment's JPEG track into a single uint8
    ``(T, H, W, 3)`` npy that the loader memmaps.

    Rationale (host feed gap): the flagship featext device rate needs
    ~13 GB/s of decoded frames, far beyond any host's JPEG decode; a
    decoded-uint8 cache turns the per-epoch cost into a sequential read
    (the reference pays JPEG decode in every dataloader worker on every
    epoch, dat_loader.py:454-475). Atomic tmp+rename write so concurrent
    writers/readers never see a torn file.
    """
    path = segment_cache_path(cache_dir, vid_seg_name, out_hw, fast=fast)
    if path.exists() and not force:
        return path
    n = _n_avail_frames(frm_dir, vid_seg_name, max_frms)
    if n == 0:
        raise FileNotFoundError(
            f"{frm_dir}/{vid_seg_name}: no frames on disk"
        )
    arr = read_img_batch(
        [
            f"{frm_dir}/{vid_seg_name}/{vid_seg_name}_{ix:06d}.jpg"
            for ix in range(1, n + 1)
        ],
        out_hw=out_hw,
        threads=threads,
        fast=fast,
    )
    if n < max_frms:
        # legal short segment (>= MIN_FRAMES JPEGs): pad by repeating
        # the last frame so the cached track always has max_frms rows —
        # exactly what the edge-clamped JPEG path reads (_frame_paths)
        arr = np.concatenate(
            [arr, np.repeat(arr[-1:], max_frms - n, axis=0)], axis=0
        )
    path.parent.mkdir(parents=True, exist_ok=True)
    # pid alone is NOT unique across hosts sharing the cache dir
    # (containerized workers repeat pid sequences), so key the tmp by a
    # fresh uuid too — concurrent writers of the same segment must
    # never interleave into one tmp file and publish a torn track
    tmp = path.with_suffix(
        f".tmp{os.getpid()}_{uuid.uuid4().hex[:8]}.npy"
    )
    np.save(tmp, arr)
    os.replace(tmp, path)
    return path


def normalize_frames(frames: np.ndarray, mean, std) -> np.ndarray:
    """uint8 (T,H,W,C) -> float32 normalized (video_utils.py:147-164)."""
    x = frames.astype(np.float32) / 255.0
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    return (x - mean) / std


def pack_pathways(frames: np.ndarray, vid_cfg) -> Dict[str, np.ndarray]:
    """Split a (T,H,W,C) clip into pathway dict.

    slowfast: fast = all T frames, slow = every alpha-th frame
    (video_utils.py:41-74); single-pathway archs: fast only.
    """
    if vid_cfg.reverse_input_channel:
        frames = frames[..., ::-1]
    if vid_cfg.arch == "slowfast":
        alpha = vid_cfg.slowfast.alpha
        t = frames.shape[0]
        idx = np.linspace(0, t - 1, t // alpha).astype(np.int64)
        return {"slow": frames[idx], "fast": frames}
    return {"fast": frames}


def load_event_clips(
    frm_dir,
    vid_seg_name: str,
    cent_frm_per_ev: Dict[str, int],
    frm_seq_len: int,
    sampling_rate: int,
    vid_cfg,
    max_frms: int = 300,
    out_hw: int = 224,
    keep_uint8: bool = False,
    cache_dir: Optional[str] = None,
    cache_write: bool = True,
) -> Dict[str, np.ndarray]:
    """Read + normalize + pack the 5 event windows of one video segment.

    Output: {"frms_ev_fast_tensor": (5, Tf, H, W, 3) float32,
             optionally "frms_ev_slow_tensor": (5, Ts, H, W, 3)}.
    (reference: dat_loader.py:454-501, channels-last here)

    ``cache_dir``: decoded-uint8 frame cache — hit reads slice a
    memmapped per-segment npy instead of decoding JPEGs; a miss decodes
    and (``cache_write``) populates the cache for the next epoch.
    """
    track = None  # memmapped (T, H, W, 3) uint8 when cached
    if cache_dir:
        cpath = segment_cache_path(cache_dir, vid_seg_name, out_hw)
        if not cpath.exists():
            # accept a prep-built fast cache (DCT-scaled decode; lossy
            # vs PIL, explicitly keyed by filename) when no exact cache
            # exists and we are not allowed to build one
            fast_p = segment_cache_path(cache_dir, vid_seg_name, out_hw,
                                        fast=True)
            if fast_p.exists() and not cache_write:
                cpath = fast_p
            elif cache_write:
                cpath = write_segment_cache(
                    frm_dir, vid_seg_name, cache_dir, out_hw, max_frms
                )
        if cpath.exists():
            track = np.load(cpath, mmap_mode="r")
            if track.shape[0] < max_frms:
                # cache written by a caller with a shorter track (the
                # filename keys on resolution + decode mode, not
                # length): rebuild in place when allowed, else fall
                # back to JPEG decode — never index past / read
                # different frames than the JPEG path would
                track = None
                if cache_write:
                    cpath = write_segment_cache(
                        frm_dir, vid_seg_name, cache_dir, out_hw,
                        max_frms, force=True,
                    )
                    track = np.load(cpath, mmap_mode="r")
                    if track.shape[0] < max_frms:  # source track short
                        track = None
    fast_lst = []
    slow_lst = []
    for ev in range(1, 6):
        center_ix = cent_frm_per_ev[f"Ev{ev}"]
        idxs = get_sequence(
            center_idx=center_ix,
            half_len=frm_seq_len // 2,
            sample_rate=sampling_rate,
            max_num_frames=max_frms,
        )
        if track is not None:
            frms = np.asarray(track[idxs])
        else:
            frms = read_img_batch(
                _frame_paths(frm_dir, vid_seg_name, idxs, max_frms),
                out_hw=out_hw,
            )
        if not keep_uint8:
            frms = normalize_frames(frms, vid_cfg.mean, vid_cfg.std)
        paths = pack_pathways(frms, vid_cfg)
        fast_lst.append(paths["fast"])
        if "slow" in paths:
            slow_lst.append(paths["slow"])

    dt = np.uint8 if keep_uint8 else np.float32
    out = {"frms_ev_fast_tensor": np.stack(fast_lst).astype(dt)}
    if slow_lst:
        out["frms_ev_slow_tensor"] = np.stack(slow_lst).astype(dt)
    return out
