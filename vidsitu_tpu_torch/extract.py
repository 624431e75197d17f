"""Pre-extracted feature pipeline on a GPU (port of vidsitu_tpu/extract.py;
reference: vidsitu_code/feat_extractor.py): run the video backbone + trimmed
head over every segment of the requested splits and write one
``{seg}_feats.npy`` of shape (5, D), float32, per segment — the input of
the SFPreFeats_* SRL models and the sfpret_* evrel models.

    python -m vidsitu_tpu_torch.extract --device=cuda --split=valid \\
        --ckpt=sfbase.pth --mdl.sf_mdl_name=i3d_r50_nl_8x8

One process per GPU: under ``torchrun`` each rank extracts its shard of the
segments (``ShardedSampler``, as vidsitu_tpu/extract.py:138-145 does)::

    torchrun --standalone --nproc_per_node=8 -m vidsitu_tpu_torch.extract \\
        --device=cuda --split=valid --ckpt=sfbase.pth
"""

from __future__ import annotations

import os
import uuid
from collections import deque
from pathlib import Path
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from .convert.from_flax import flax_to_state_dict, seeded_variables
from .data.dataset import VsituDS
from .data.loader import DataLoader, fold_frame_events
from .models.common import take_dtypes
from .models.vb_models import build_feat_extractor
from .parallel.collectives import get_rank, get_world_size

_FRAME_KEYS = ("frms_ev_fast_tensor", "frms_ev_slow_tensor")


def default_feats_dir(cfg, mdl_name: Optional[str] = None) -> Path:
    """Per-model feature directory, like the reference's
    ``vsitu_frm_feats/{mdl_name}`` (feat_extractor.py:86)."""
    return Path(cfg.ds.vsitu.vsitu_frm_feats) / (
        mdl_name or cfg.mdl.sf_mdl_name
    )


class FramesOnlyDS:
    """All-splits frames dataset (VsituDS_All, feat_extractor.py:20-74)."""

    def __init__(self, cfg, comm, split_type: str):
        self.base = VsituDS(cfg, comm, split_type, task_type="vb")
        self.vseg_lst = self.base.vseg_lst

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx: int):
        out = self.base.get_frms_all(idx)
        out["vseg_idx"] = np.asarray(idx, dtype=np.int64)
        return out


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent (extraction never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False"
        )
    return dev


def _check_one_device(n_devices: int) -> None:
    if n_devices != 1:
        raise NotImplementedError(
            f"n_devices={n_devices}: a process drives one GPU. Start one "
            f"process per GPU instead: torchrun --standalone "
            f"--nproc_per_node={n_devices} -m vidsitu_tpu_torch.extract "
            "--device=cuda ..."
        )


def extract_features(
    cfg,
    comm,
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    splits: Optional[List[str]] = None,
    out_dir: Optional[str] = None,
    batch_size: int = 4,
    num_threads: int = 0,
    mdl_name: Optional[str] = None,
    clip_batch: int = 128,
    device="cuda",
    n_devices: int = 1,
    timings: Optional[List[float]] = None,
) -> Dict[str, int]:
    """Extract features for the given splits. Returns counts per split.

    ``state_dict`` is the feature extractor's (``convert.from_flax``);
    without one the weights are seeded random ones (testing only).

    The device consumes a flat clip stream in batches of exactly
    ``clip_batch`` clips. Videos load at ``batch_size`` granularity, the
    5-event fold is a free host view, clips buffer until a full batch is
    ready, and the (5, D) per-segment regroup happens on the host after the
    fetch (a segment's 5 clips are consecutive in stream order even when
    they span batches). The final partial batch is zero-padded to
    ``clip_batch``. The default of 128 was chosen for TPU lanes; its best
    value on a GPU is not measured yet.

    Host and device overlap one step: each batch is copied to the device
    asynchronously from pinned memory and its features are copied back
    asynchronously; they are fetched (the host waits) only after the next
    batch has been queued, and written while the device computes.

    ``timings``, when given, receives the host clock (``time.perf_counter``)
    after each batch's features are fetched.

    Under a process group each rank takes its shard of every split's
    segments; the sampler repeats a few so that every shard has as many,
    and their files are written twice, each atomically. The counts are this
    rank's files.
    """
    import time

    if clip_batch < 1:
        raise ValueError(f"clip_batch must be >= 1, got {clip_batch}")
    _check_one_device(n_devices)
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    splits = splits or ["valid", "train"]
    out_dir = Path(out_dir) if out_dir else default_feats_dir(cfg, mdl_name)
    out_dir.mkdir(parents=True, exist_ok=True)

    model = build_feat_extractor(cfg)
    if state_dict is None:
        state_dict = flax_to_state_dict(seeded_variables(model, seed=0))
    else:  # given weights keep their dtype, as the JAX package's do
        take_dtypes(model, state_dict)
    model.load_state_dict(state_dict, strict=True)
    model.to(device=dev, memory_format=torch.channels_last_3d)

    counts: Dict[str, int] = {}
    for split in splits:
        ds = FramesOnlyDS(cfg, comm, split)
        dl = DataLoader(ds, batch_size=batch_size, shuffle=False,
                        drop_last=False, num_threads=num_threads,
                        num_shards=get_world_size(), shard_id=get_rank())
        n = 0
        parts: List[Dict[str, np.ndarray]] = []  # buffered folded clips
        n_buf = 0
        keys: List[str] = []
        vid_queue: deque = deque()  # vseg indices in stream order
        row_buf: Optional[np.ndarray] = None  # <5 rows spanning flushes
        pending = None  # (host feats, copy-done event, n_valid), one behind

        def write_seg(seg: str, arr: np.ndarray):
            nonlocal n
            # tmp + atomic rename: a crash must never leave a torn .npy
            # that downstream training silently loads
            tmp = out_dir / (
                f".{seg}_feats.{os.getpid()}_{uuid.uuid4().hex[:8]}.npy.tmp"
            )
            with open(tmp, "wb") as f:  # np.save(path) would append .npy
                np.save(f, arr)
            os.replace(tmp, out_dir / f"{seg}_feats.npy")
            n += 1

        def flush(item):
            nonlocal row_buf
            host, done, n_valid = item
            if done is not None:
                done.synchronize()
            feats = host.numpy()[:n_valid]  # float32: the file contract
            if timings is not None:
                timings.append(time.perf_counter())
            rows = (feats if row_buf is None or not len(row_buf)
                    else np.concatenate([row_buf, feats]))
            k = rows.shape[0] // 5
            for i in range(k):
                seg = ds.vseg_lst[vid_queue.popleft()]
                write_seg(seg, rows[5 * i:5 * i + 5])
            row_buf = rows[5 * k:]

        def pop_clip_batch(n_take: int) -> Dict[str, np.ndarray]:
            nonlocal n_buf
            taken: Dict[str, list] = {k: [] for k in keys}
            got = 0
            while got < n_take:
                part = parts[0]
                avail = part[keys[0]].shape[0]
                take = min(n_take - got, avail)
                for k in keys:
                    taken[k].append(part[k][:take])
                if take == avail:
                    parts.pop(0)
                else:
                    for k in keys:
                        part[k] = part[k][take:]  # view, no copy
                got += take
            n_buf -= n_take
            return {k: (v[0] if len(v) == 1 else np.concatenate(v))
                    for k, v in taken.items()}

        def dispatch(batch_np: Dict[str, np.ndarray], n_valid: int):
            nonlocal pending
            inp = {}
            for k, v in batch_np.items():
                t = torch.from_numpy(np.ascontiguousarray(v))
                inp[k] = (t.pin_memory().to(dev, non_blocking=True)
                          if cuda else t)
            with torch.inference_mode():
                out = model.clip_features(inp).float()
            done = None
            if cuda:
                host = torch.empty(out.shape, dtype=torch.float32,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host = out
            if pending is not None:
                flush(pending)
            pending = (host, done, n_valid)

        for batch in dl:
            folded = fold_frame_events(batch)
            if not keys:
                keys = [k for k in _FRAME_KEYS if folded.get(k) is not None]
            parts.append({k: np.asarray(folded[k]) for k in keys})
            n_buf += parts[-1][keys[0]].shape[0]
            vid_queue.extend(int(i) for i in np.asarray(batch["vseg_idx"]))
            while n_buf >= clip_batch:
                dispatch(pop_clip_batch(clip_batch), clip_batch)
        if n_buf:
            tail = pop_clip_batch(n_buf)
            pad = clip_batch - tail[keys[0]].shape[0]
            tail = {k: np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)])
                for k, v in tail.items()}
            dispatch(tail, clip_batch - pad)
        if pending is not None:
            flush(pending)
        if vid_queue or (row_buf is not None and len(row_buf)):
            raise AssertionError(
                "clip-stream regroup invariant broken: leftover "
                f"{len(vid_queue)} videos / "
                f"{0 if row_buf is None else len(row_buf)} rows"
            )
        counts[split] = n
    return counts


def main(argv=None):
    """CLI: python -m vidsitu_tpu_torch.extract --device=cuda --split=valid
    ... (reference: python vidsitu_code/feat_extractor.py, :115-179)."""
    import argparse

    ap = argparse.ArgumentParser(description="extract video features (GPU)")
    ap.add_argument("--split", action="append", default=None)
    ap.add_argument("--out_dir", default=None)
    ap.add_argument(
        "--mdl_name_used", default=None,
        help="subdirectory under ds.vsitu.vsitu_frm_feats (reference "
             "feat_extractor.py main arg; default: cfg.mdl.sf_mdl_name)",
    )
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument(
        "--clip_batch", type=int, default=128,
        help="device batch in CLIPS (flat 5-event stream); 128 was chosen "
             "for TPU lanes and is not yet measured on a GPU")
    ap.add_argument(
        "--n_devices", type=int, default=1,
        help="GPUs this process drives: 1 (start one process per GPU with "
             "torchrun)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda raises when no GPU is visible; "
                         "under torchrun cuda is cuda:{LOCAL_RANK}")
    ap.add_argument("--dist_backend", default=None,
                    help="nccl or gloo (default: nccl on CUDA, gloo on the "
                         "CPU); naming one starts a process group")
    ap.add_argument("--num_threads", type=int, default=8,
                    help="JPEG-decode thread pool size")
    ap.add_argument("--ckpt", default="", help="SFBase torch checkpoint")
    ap.add_argument(
        "--allow_random_weights", action="store_true",
        help="extract from seeded random weights (testing only)",
    )
    ap.add_argument("overrides", nargs="*", help="--dotted.key=value")
    args, unknown = ap.parse_known_args(argv)

    from .parallel.collectives import is_dist, synchronize
    from .parallel.mesh import init_distributed
    from .utils.config import get_cfg_with_overrides

    overrides = {}
    for tok in list(args.overrides) + list(unknown):
        if not (tok.startswith("--") and "=" in tok):
            ap.error(f"expected --dotted.key=value, got {tok!r}")
        k, v = tok[2:].split("=", 1)
        overrides[k] = v
    cfg = get_cfg_with_overrides("featext", **overrides)
    if not args.ckpt and not args.allow_random_weights:
        # without a checkpoint the features would come from RANDOM
        # weights and downstream models would silently train on noise
        ap.error(
            "--ckpt is required (pass --allow_random_weights to extract "
            "from seeded random weights, e.g. for smoke tests)"
        )
    had_group = is_dist()
    device = init_distributed(args.device, args.dist_backend)
    try:
        counts = _extract_cli(cfg, args, device)
        synchronize()
    finally:
        if is_dist() and not had_group:
            torch.distributed.destroy_process_group()
    print(counts)


def _extract_cli(cfg, args, device) -> Dict[str, int]:
    from .data.comm import build_comm

    comm = build_comm(cfg)
    state_dict = None
    if args.ckpt:
        from .convert.hf_torch import load_torch_state_dict
        from .convert.slowfast_torch import convert_sfbase_checkpoint

        conv = convert_sfbase_checkpoint(
            load_torch_state_dict(args.ckpt), cfg.vid_mdl.arch)
        state_dict = flax_to_state_dict({
            "params": {"backbone": conv["params"]["backbone"]},
            "batch_stats": {"backbone": conv["batch_stats"]["backbone"]},
        })
    return extract_features(
        cfg, comm, state_dict=state_dict,
        splits=args.split or ["valid", "train"],
        out_dir=args.out_dir, batch_size=args.batch_size,
        num_threads=args.num_threads, mdl_name=args.mdl_name_used,
        clip_batch=args.clip_batch, device=device, n_devices=args.n_devices,
    )


if __name__ == "__main__":
    main()
