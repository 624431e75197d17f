"""Dataset preparation tooling (reference: prep_data/dwn_yt.py).

Downloads the 10-second VidSitu clips with yt-dlp, trims with ffmpeg,
validates size/frame-count with retries, and dumps 30-fps JPEG frames
``{seg}/{seg}_{ix:06d}.jpg`` — the exact layout the frame dataset reads
(dat_loader.py:456-459). All external work is subprocess-based and gated
on the binaries being present (this module is host tooling, not a
device-compute path).
"""

from __future__ import annotations

import json
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path
from typing import Dict, List, Optional, Tuple


class MissingToolError(RuntimeError):
    pass


def _require(binary: str):
    if shutil.which(binary) is None:
        raise MissingToolError(
            f"'{binary}' not found on PATH - install it to run data prep"
        )


def parse_seg_name(vid_seg: str) -> Tuple[str, float, float]:
    """'v_<ytid>_seg_<st>_<end>' -> (ytid, start, end)
    (reference: dwn_yt.py naming convention)."""
    assert vid_seg.startswith("v_")
    body = vid_seg[2:]
    ytid, seg = body.rsplit("_seg_", 1)
    st, en = seg.split("_")
    return ytid, float(st), float(en)


MIN_SRC_FPS = 20  # truncation guard: any real YT video is >= 24 fps


def download_clip(
    vid_seg: str,
    out_dir,
    retries: int = 3,
    min_bytes: int = 20_000,
    fmt: str = "22/best",
    cookies_file: str = "",
) -> Optional[Path]:
    """Download + trim one 10s segment (dwn_yt.py:150-211).

    ``fmt`` defaults to the reference's yt-dlp format ``22/best``
    (1280x720 mp4, dwn_yt.py:154) so prepared frames are
    pixel-comparable to reference-prepared data; the reference retries
    failures with ``webm`` (dwn_yt.py:197-202) — `main` does the same.
    A download that trims to fewer frames than the segment duration can
    hold at MIN_SRC_FPS is treated as truncated and retried (the
    reference's strict frame-count check, dwn_yt.py:169-176, applied at
    download time; skipped when ffprobe is unavailable)."""
    _require("yt-dlp")
    _require("ffmpeg")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ytid, st, en = parse_seg_name(vid_seg)
    out_path = out_dir / f"{vid_seg}.mp4"

    def _valid() -> bool:
        if not (out_path.exists()
                and out_path.stat().st_size >= min_bytes):
            return False
        if shutil.which("ffprobe") is None:
            return True
        try:
            return count_frames(out_path) >= (en - st) * MIN_SRC_FPS
        except (subprocess.SubprocessError, IndexError, KeyError,
                ValueError):
            # unprobeable or malformed container (no video stream, no
            # packet count, a non-integer count) == corrupt
            return False

    if _valid():
        return out_path  # idempotent rerun: keep the validated clip
    for attempt in range(retries):
        try:
            cookie_args = (
                ["--cookies", cookies_file] if cookies_file else []
            )  # reference dwn_yt.py:134-139
            url = subprocess.run(
                ["yt-dlp", "-g", "-f", fmt, *cookie_args,
                 f"https://www.youtube.com/watch?v={ytid}"],
                capture_output=True, text=True, timeout=120, check=True,
            ).stdout.strip().splitlines()[0]
            subprocess.run(
                ["ffmpeg", "-y", "-ss", str(st), "-i", url,
                 "-t", str(en - st), "-c:v", "libx264", "-an",
                 str(out_path)],
                capture_output=True, timeout=300, check=True,
            )
            if _valid():
                return out_path
            # undersized/truncated/unprobeable: drop the bad file
            # (extract_frames treats any existing mp4 as good) and
            # fall to the backoff below before re-hitting YouTube
            out_path.unlink(missing_ok=True)
            raise subprocess.SubprocessError("invalid download")
        except (subprocess.SubprocessError, IndexError):
            time.sleep(2.0 * (attempt + 1))
    out_path.unlink(missing_ok=True)  # never leave a failed partial
    return None


def count_frames(video_path) -> int:
    _require("ffprobe")
    out = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0",
         "-count_packets", "-show_entries", "stream=nb_read_packets",
         "-of", "json", str(video_path)],
        capture_output=True, text=True, check=True,
    )
    return int(json.loads(out.stdout)["streams"][0]["nb_read_packets"])


MIN_FRAMES = 290  # reference strict check (dwn_yt.py:169-176)


def extract_frames(
    video_path, frames_root, vid_seg: str, fps: int = 30
) -> int:
    """Dump 30fps JPEGs {seg}/{seg}_%06d.jpg (dwn_yt.py:229-280;
    -q:v 1 matches the reference's encode quality so prepared frames
    are pixel-comparable to reference-prepared data).

    An already-complete segment (>= MIN_FRAMES JPEGs, the reference's
    strict check) is skipped; a SHORT leftover from an interrupted run
    is wiped and re-extracted — counting any nonzero number of frames
    as success would leave the segment short forever. A segment that
    genuinely yields 290-299 frames passes (as in the reference); the
    loader edge-clamps its window to the frames on disk
    (data/frames._frame_paths)."""
    _require("ffmpeg")
    seg_dir = Path(frames_root) / vid_seg
    existing = len(list(seg_dir.glob("*.jpg"))) if seg_dir.is_dir() else 0
    if existing >= MIN_FRAMES:
        return existing
    if existing:
        for f in seg_dir.glob("*.jpg"):
            f.unlink()
    seg_dir.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        ["ffmpeg", "-y", "-i", str(video_path), "-r", str(fps), "-q:v", "1",
         str(seg_dir / f"{vid_seg}_%06d.jpg")],
        capture_output=True, timeout=300, check=True,
    )
    return len(list(seg_dir.glob("*.jpg")))


def run_pool(fn, items: List, max_workers: int = 8) -> Dict:
    """Bounded thread pool over subprocess jobs (dwn_yt.py:43-87 analog)."""
    results = {}
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        futs = {ex.submit(fn, it): it for it in items}
        for fut in as_completed(futs):
            it = futs[fut]
            try:
                results[it] = fut.result()
            except Exception as e:  # keep going; report at the end
                results[it] = e
    return results


_SETUP_CFG = Path(__file__).parent / "configs" / "vsitu_setup_cfg.yml"

# reference setup-YAML key -> our CLI flag (dwn_yt.py:285 surface)
_SETUP_KEY_MAP = {
    "video_trimmed_dir": "video_dir",
    "video_frm_tdir": "frames_dir",
    "max_processes": "max_workers",
    "split_dir": "split_dir",
    "retry_count": "retry_count",
    "cookies_file": "cookies_file",
    "frame_cache_dir": "cache_dir",
}


def _load_setup_cfg(path) -> Dict:
    """configs/vsitu_setup_cfg.yml -> argparse defaults, mapping the
    reference's key names (prep_data/dwn_yt.py:285) onto our flags."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return {
        _SETUP_KEY_MAP[k]: v for k, v in raw.items() if k in _SETUP_KEY_MAP
    }


def _segs_from_split_dir(split_dir) -> List[str]:
    """Union of the segment lists in every *.json split file (the
    reference's YTDown.get_all_yt_ids walks split_dir the same way)."""
    segs = set()
    for fp in sorted(Path(split_dir).glob("*.json")):
        with open(fp) as f:
            data = json.load(f)
        if isinstance(data, list):
            segs.update(
                s if isinstance(s, str) else s.get("vid_seg_id", "")
                for s in data
            )
    segs.discard("")
    return sorted(segs)


def main(argv=None):
    """CLI mirroring prep_data/dwn_yt.py --task_type=dwn_vids|extract_frames.
    Defaults come from configs/vsitu_setup_cfg.yml (the reference's setup
    YAML surface, dwn_yt.py:285); explicit flags override it."""
    import argparse

    ap = argparse.ArgumentParser(description="VidSitu data prep")
    ap.add_argument("--setup_cfg", default=str(_SETUP_CFG),
                    help="setup YAML with reference key names "
                         "(vsitu_setup_cfg.yml); '' disables")
    ap.add_argument("--task_type", required=True,
                    choices=["dwn_vids", "extract_frames",
                             "build_frame_cache"])
    ap.add_argument("--split_file", default=None,
                    help="JSON list of segment ids; alternative: "
                         "--split_dir")
    ap.add_argument("--split_dir", default=None,
                    help="directory of *.json split files; all segment "
                         "ids are unioned (reference get_all_yt_ids)")
    ap.add_argument("--video_dir", default="./data/vsitu_video_trimmed_dir")
    ap.add_argument("--frames_dir", default="./data/vsitu_frames")
    ap.add_argument("--cache_dir", default="./data/vsitu_frame_cache")
    ap.add_argument("--out_hw", type=int, default=224)
    ap.add_argument("--max_workers", type=int, default=8)
    ap.add_argument("--retry_count", type=int, default=3)
    ap.add_argument("--cookies_file", default="",
                    help="yt-dlp --cookies file (reference dwn_yt surface)")
    ap.add_argument(
        "--decode_threads", type=int, default=1,
        help="C++ decode threads per segment (build_frame_cache); "
             "total decode parallelism = max_workers * decode_threads",
    )
    ap.add_argument(
        "--fast_decode", action="store_true",
        help="build_frame_cache only: DCT-scaled JPEG decode (2-4x "
             "faster on large frames, pixels NOT bit-identical to the "
             "reference's PIL preproc — written under a distinct "
             "{seg}_{hw}_fast.npy name; the loader only reads it when "
             "no exact cache exists and tpu.frame_cache_write is off)",
    )
    # two-phase parse: the setup YAML provides defaults, flags override
    pre, _ = ap.parse_known_args(argv)
    if pre.setup_cfg and Path(pre.setup_cfg).exists():
        ap.set_defaults(**_load_setup_cfg(pre.setup_cfg))
    args = ap.parse_args(argv)

    if args.split_file:
        with open(args.split_file) as f:
            segs = json.load(f)
    elif args.split_dir and Path(args.split_dir).is_dir():
        segs = _segs_from_split_dir(args.split_dir)
    else:
        ap.error("need --split_file, or --split_dir (flag or setup YAML) "
                 "pointing at an existing directory")

    if args.task_type == "build_frame_cache":
        # one-time JPEG decode -> per-segment uint8 npy tree; training /
        # featext then read memmapped slices instead of re-decoding
        # every epoch (host feed gap, see data/frames.write_segment_cache)
        from .data.frames import write_segment_cache

        def one_seg(s):
            return write_segment_cache(
                args.frames_dir, s, args.cache_dir, out_hw=args.out_hw,
                threads=args.decode_threads, fast=args.fast_decode,
            )

        res = run_pool(one_seg, segs, max_workers=args.max_workers)
        ok = sum(1 for v in res.values() if isinstance(v, Path))
        print(f"cached {ok}/{len(segs)} segments -> {args.cache_dir}")
        return

    if args.task_type == "dwn_vids":
        res = run_pool(
            lambda s: download_clip(s, args.video_dir,
                                    retries=args.retry_count,
                                    cookies_file=args.cookies_file),
            segs, max_workers=args.max_workers,
        )
        # second pass over failures with format=webm, like the
        # reference (dwn_yt.py:197-202)
        failed = [s for s, v in res.items() if not isinstance(v, Path)]
        if failed:
            res.update(run_pool(
                lambda s: download_clip(s, args.video_dir, fmt="webm",
                                        retries=args.retry_count,
                                        cookies_file=args.cookies_file),
                failed, max_workers=args.max_workers,
            ))
        ok = sum(1 for v in res.values() if isinstance(v, Path))
        print(f"downloaded {ok}/{len(segs)}")
    else:
        def one(s):
            return extract_frames(
                Path(args.video_dir) / f"{s}.mp4", args.frames_dir, s
            )

        res = run_pool(one, segs, max_workers=args.max_workers)
        ok = sum(1 for v in res.values()
                 if isinstance(v, int) and v >= MIN_FRAMES)
        short = [s for s, v in res.items()
                 if isinstance(v, int) and 0 < v < MIN_FRAMES]
        errs = [s for s, v in res.items() if isinstance(v, Exception)]
        print(f"extracted {ok}/{len(segs)}"
              + (f" ({len(short)} SHORT, e.g. {short[:3]} — rerun to "
                 f"retry)" if short else "")
              + (f" ({len(errs)} ERRORED, e.g. {errs[:3]} — missing or"
                 f" corrupt mp4; rerun dwn_vids)" if errs else ""))


if __name__ == "__main__":
    main()
