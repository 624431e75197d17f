"""Diagnostics for the release surfaces on the GPU, one JSON line each.

``python -m vidsitu_tpu_torch.release_probe fit [--seed=42]`` takes the
``verify_release --fit`` rehearsal's tiny ``rob_evrel`` (its data, dims and
batch) and holds the card against the CPU on the same initial weights and
the same batch:

  * the first step's loss with dropout off, and each module's output
    (the first modules whose outputs part by more than 1e-4 of their scale);
  * the first step's loss under 64 dropout masks drawn on each device
    (mean and spread);
  * the 2-epoch train-loss trajectory of ``Learner.fit`` with the card's
    own masks, with dropout off, and with masks drawn on the CPU and moved
    to the card (the CPU run's masks).

``python -m vidsitu_tpu_torch.release_probe stem`` times phase 18's I3D-NL
R50 update (16 videos = 80 clips, bf16) with the stem's max pool in one
pass and as two one-axis pools, in turns, with each one's peak memory.

``python -m vidsitu_tpu_torch.release_probe stem_fold`` first runs a
training step of both cells' models, folded and plain, counts
``Conv3d.padded_calls`` and names the op and shapes that launch each float32
conv kernel and each kernel on the frames (the stems, their folds); then it
times each stem conv of the benchmark's cells alone (80 clips, 224 px, bf16,
channels-last), as cuDNN takes its 3 channels and folded
(``video_backbone.folded_conv3d``): forward, fold pass and weight gradient
in turns, with the kernels each runs.

All three need a GPU; ``--out=DIR`` also writes the lines to ``DIR/release_probe.jsonl``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.nn import functional as F

EVREL = ("evrel", "rob_evrel")


def evrel_learner(work: Path, paths: Dict, dev: torch.device, seed: int,
                  uid: str):
    """The ``--fit`` rehearsal's ``rob_evrel`` learner (verify_release.py
    ``fit_rehearsal``'s overrides) with ``train.seed = seed``."""
    from .train.build import build_learner
    from .utils.config import get_cfg_with_overrides
    from .verify_release import _FIT_DIMS

    cfg = get_cfg_with_overrides(uid, **{
        **paths, **_FIT_DIMS["evrel"], "task_type": EVREL[0],
        "mdl.mdl_name": EVREL[1], "train.bs": 8, "train.bsv": 8,
        "train.nw": 0, "train.nwv": 0, "train.dtype": "float32",
        "train.epochs": 2, "train.seed": seed,
        "misc.tmp_path": str(work / f"tmp_{uid}")})
    with contextlib.redirect_stdout(io.StringIO()):
        return build_learner(cfg, uid, dev), cfg


def first_batch(learner):
    from .data.loader import fold_frame_events
    from .train.learner import batch_to_device

    learner.data.train_dl.set_epoch(0)
    return batch_to_device(fold_frame_events(next(iter(
        learner.data.train_dl))), learner.device)


def module_outputs(model, batch) -> Dict[str, torch.Tensor]:
    """Every module's tensor output (a dict's ``last_hidden_state``) of one
    training-mode forward with dropout off, in forward order."""
    from .models.common import deterministic

    outs: Dict[str, torch.Tensor] = {}

    def keep(mod, args, out, name):
        if isinstance(out, dict):
            out = out.get("last_hidden_state", out.get("loss"))
        if isinstance(out, torch.Tensor):
            outs[name] = out.detach().double().cpu()

    hooks = [m.register_forward_hook(lambda mod, a, o, n=n: keep(mod, a, o, n))
             for n, m in model.named_modules() if n]
    model.train()
    with torch.no_grad(), deterministic():
        outs["loss"] = model(batch)["loss"].detach().double().cpu()
    for h in hooks:
        h.remove()
    return outs


def masked_losses(model, batch, dev: torch.device, n: int) -> List[float]:
    from .models.common import dropout_generator

    model.train()
    out = []
    with torch.no_grad():
        for k in range(n):
            with dropout_generator(torch.Generator(device=dev).manual_seed(k)):
                out.append(float(model(batch)["loss"]))
    return out


@contextlib.contextmanager
def masks_from_host():
    """Draw every dropout mask from the innermost generator on the host and
    move it to the activations' device: a CUDA run then drops what a CPU
    run with the same generator state drops."""
    from .models import common

    plain = common.dropout

    def dropout(x, rate, training):
        if rate == 0.0 or not training or getattr(common._DROPOUT, "off",
                                                  False):
            return x
        gen = common._DROPOUT.gen
        keep = torch.rand(x.shape, generator=gen) < 1.0 - rate
        return x * keep.to(x.device) / (1.0 - rate)

    common.dropout = dropout
    try:
        yield
    finally:
        common.dropout = plain


def trajectory(work, paths, dev, seed, mode: str, tag: str) -> List[float]:
    """``Learner.fit(2 epochs, lr 1e-3)`` as ``--fit`` runs it; ``mode`` is
    ``masks`` (the device's own), ``off`` (no dropout) or ``host_masks``
    (a host generator seeded as the CPU run's)."""
    from .models.common import deterministic

    uid = f"traj_{tag}_{mode}"
    learner, cfg = evrel_learner(work, paths, dev, seed, uid)
    ctx = contextlib.ExitStack()
    if mode == "off":
        ctx.enter_context(deterministic())
    elif mode == "host_masks":
        cpu_gen = evrel_learner(work, paths, torch.device("cpu"), seed,
                                uid + "_ref")[0].dropout_gen
        learner.dropout_gen = cpu_gen
        ctx.enter_context(masks_from_host())
    with ctx, contextlib.redirect_stdout(io.StringIO()):
        learner.fit(epochs=2, lr=1e-3)
    mfile = (Path(cfg.misc.tmp_path) / "tracking"
             / f"{cfg.expm.exp_name}_{cfg.task_type}" / uid / "metrics.jsonl")
    return [json.loads(ln)["trn_loss"] for ln in mfile.read_text().splitlines()
            if "trn_loss" in ln]


def probe_fit(seed: int, n_masks: int = 64, gpu: str = "cuda") -> Dict:
    """The ``fit`` diagnosis (see the module's docstring), ``gpu`` against
    the CPU."""
    with tempfile.TemporaryDirectory(prefix="release_probe_") as tmp:
        return _probe_fit(Path(tmp), seed, n_masks, torch.device(gpu))


def _probe_fit(work: Path, seed: int, n_masks: int, cuda: torch.device):
    from .data.synth import make_synth_dataset

    cpu = torch.device("cpu")
    paths = make_synth_dataset(work / "synth", n_train=8, n_valid=4, seed=5,
                               with_frames=True)
    res: Dict = {"probe": "fit", "seed": seed, "device": str(cuda)}
    models, batches = {}, {}
    for tag, dev in (("cpu", cpu), ("cuda", cuda)):
        learner, _ = evrel_learner(work, paths, dev, seed, f"first_{tag}")
        models[tag], batches[tag] = learner.model, first_batch(learner)
    res["batch_checksum"] = {k: float(v.double().sum())
                             for k, v in batches["cpu"].items()}
    assert all(torch.equal(batches["cpu"][k], batches["cuda"][k].cpu())
               for k in batches["cpu"])
    res["same_initial_weights"] = all(
        torch.equal(a, b.cpu()) for a, b in zip(
            models["cpu"].state_dict().values(),
            models["cuda"].state_dict().values()))
    outs = {k: module_outputs(models[k], batches[k]) for k in models}
    res["loss_no_dropout"] = {k: float(outs[k]["loss"]) for k in outs}
    parted = []
    for name, a in outs["cpu"].items():
        b = outs["cuda"][name]
        err = float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
        if err > 1e-4:
            parted.append((name, err))
    res["modules"] = len(outs["cpu"])
    res["modules_parted"] = parted[:8]
    for k, dev in (("cpu", cpu), ("cuda", cuda)):
        ls = masked_losses(models[k], batches[k], dev, n_masks)
        res[f"masked_{k}"] = {"mean": float(np.mean(ls)),
                              "std": float(np.std(ls)), "n": n_masks,
                              "min": min(ls), "max": max(ls)}
    del models, batches
    res["trajectory"] = {
        f"{tag}_{mode}": trajectory(work, paths, dev, seed, mode, tag)
        for tag, dev, mode in (("cpu", cpu, "masks"), ("cuda", cuda, "masks"),
                               ("cpu", cpu, "off"), ("cuda", cuda, "off"),
                               ("cuda", cuda, "host_masks"))}
    return res


def probe_stem(turns_reps: int = 5) -> Dict:
    """Phase 18's update (chip_smoke.py ``phase_train_step``: the I3D-NL
    R50 at 16 videos, bf16, the routed kernels, seeded non-zero gammas)
    with each stem pool."""
    from .bench import make_vb_train
    from .convert.from_flax import flax_to_state_dict, seeded_variables
    from .models import video_backbone as VB
    from .timing import medians_in_turns

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, opt, batch, _ = make_vb_train("i3d_r50_nl_8x8", 16, dev)
    model.load_state_dict(flax_to_state_dict(seeded_variables(model, 0)),
                          strict=True)
    stems = [m for m in model.modules() if isinstance(m, VB.Stem)]

    def one_pass(self, x):
        return F.max_pool3d(self.conv(x), (1, 3, 3), stride=(1, 2, 2),
                            padding=(0, 1, 1))

    def two_pools(self, x):
        return VB.repeatable_stem_pool(self.conv(x))

    def with_pool(fwd):
        def step():
            for s in stems:
                s._forward = fwd.__get__(s)
            opt.zero_grad(set_to_none=True)
            loss = model(batch)["loss"]
            loss.backward()
            opt.step()
            return loss
        return step

    steps = [with_pool(one_pass), with_pool(two_pools)]
    peaks = []
    for step in steps:
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        step()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated(dev) / 2**30)
    rounds = [medians_in_turns(steps, turns_reps) for _ in range(3)]
    return {"probe": "stem", "device": torch.cuda.get_device_name(0),
            "videos": 16, "clips": 80, "stems": len(stems),
            "ms_one_pass": [r[0] for r in rounds],
            "ms_two_pools": [r[1] for r in rounds],
            "peak_gib_one_pass": peaks[0], "peak_gib_two_pools": peaks[1]}


# (name, Cout, temporal kernel, frames) of the cells' stems
STEMS = (("i3d_r50_nl_8x8", 64, 5, 8), ("slowfast_slow", 64, 1, 8),
         ("slowfast_fast", 8, 5, 32))
# kernel names of float32 convolutions, off the tensor cores
F32_CONV = ("f32f32", "sgemm", "convolveNd")


def _kernels(fn) -> List:
    """[name, device ms] of the kernels one call of ``fn`` runs."""
    from torch.profiler import ProfilerActivity, profile

    from .timing import kernel_rows

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [[e.key[:140], e.device_time_total / 1e3] for e in kernel_rows(prof)]


def _launching_ops(events: List[Dict], match) -> List:
    """[kernel, op, input dims, ms] summed over a Chrome trace's kernels
    whose name ``match`` accepts: the op is the innermost ``aten::`` op on
    the launching thread that holds the kernel's launch record."""
    launches, ops = {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (e["tid"], e["ts"])
        elif e.get("cat") == "cpu_op" and e["name"].startswith("aten::"):
            ops.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e.get("dur", 0), e["name"],
                 json.dumps(args.get("Input Dims"))))
    by: Dict = {}
    for e in events:
        if e.get("cat") != "kernel" or not match(e["name"]):
            continue
        tid, t = launches.get((e.get("args") or {}).get("correlation"), (None, 0))
        held = [o for o in ops.get(tid, ()) if o[0] <= t <= o[1]]
        op = min(held, key=lambda o: o[1] - o[0]) if held else (0, 0, "?", "?")
        key = (e["name"][:140], op[2], op[3])
        by[key] = by.get(key, 0.0) + e.get("dur", 0) / 1e3
    return [[*k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])]


def probe_stem_fold(clips: int = 80, size: int = 224, videos: int = 16,
                    reps: int = 10) -> Dict:
    """In a training step of each model, folded and plain: the padded calls
    and the float32 conv and frame kernels with the ops that launch them;
    then each stem conv alone, plain and folded. The steps come first:
    after the stems alone, the profiler has left out the plain stems'
    forward kernels from a step's trace on an H100."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from .bench import make_vb_train
    from .models import video_backbone as VB
    from .timing import medians_in_turns

    def wgrad(gy, x, w, stride, padding):
        dil = (1,) * len(stride)
        return torch.ops.aten.convolution_backward(
            gy, x, w, None, stride, padding, dil, False, (0,) * len(stride), 1,
            (False, True, False))[1]

    dev = torch.device("cuda")
    out = {"probe": "stem_fold", "clips": clips, "size": size, "stems": {}}
    folds = VB.folds_conv

    def on_frames(kernel, dims):
        """A float32 conv kernel, or one launched by an op on the frames."""
        if any(p in kernel for p in F32_CONV):
            return True
        try:
            return any(isinstance(d, list) and size in d for d in json.loads(dims))
        except (TypeError, ValueError):
            return False

    for preset in ("i3d_r50_nl_8x8", "slow_fast_nl_r50_8x8"):
        model, opt, batch, _ = make_vb_train(preset, videos, dev)

        def step():
            opt.zero_grad(set_to_none=True)
            model(batch)["loss"].backward()
            opt.step()

        for label, fold in (("folded", folds), ("plain", lambda *a: False)):
            VB.folds_conv = fold
            try:
                step()
                VB.Conv3d.padded_calls = 0
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                             record_shapes=True) as prof:
                    step()
                    torch.cuda.synchronize()
            finally:
                VB.folds_conv = folds
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            out.setdefault("steps", {}).setdefault(preset, {})[label] = {
                "padded_calls": VB.Conv3d.padded_calls,
                "kernels": [r for r in _launching_ops(events, lambda k: True)
                            if on_frames(r[0], r[2])]}
        del model, opt, batch
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, cout, kt, frames in STEMS:
        x = torch.randn((clips, frames, size, size, 3), generator=gen,
                        device=dev).to(torch.bfloat16).permute(0, 4, 1, 2, 3)
        w = (0.1 * torch.randn((cout, 3, kt, 7, 7), generator=gen, device=dev)).to(
            torch.bfloat16).to(memory_format=torch.channels_last_3d)
        st, pd = (1, 2, 2), (kt // 2, 3, 3)
        y = F.conv3d(x, w, None, st, pd)
        gy = torch.randn(y.shape, generator=gen, device=dev).to(
            torch.bfloat16).to(memory_format=torch.channels_last_3d)
        n, _, t, ho, wo = y.shape
        gy2 = gy.permute(0, 2, 3, 4, 1).reshape(n * t, ho, wo, cout).permute(0, 3, 1, 2)
        ch = VB.folded_channels(3, kt)
        frames2d, w2d = VB.fold_frames(x, kt, 1, kt // 2, 1, ch), VB.fold_weight(w, ch)
        v = {"plain": (lambda: F.conv3d(x, w, None, st, pd),
                       lambda: wgrad(gy, x, w, st, pd), None),
             "folded": (lambda: F.conv2d(frames2d, w2d, None, st[1:], pd[1:]),
                        lambda: wgrad(gy2, frames2d, w2d, st[1:], pd[1:]),
                        lambda: VB.fold_frames(x, kt, 1, kt // 2, 1, ch))}
        ref = y.float()
        rows = {}
        for key, (fwd, bwd, _) in v.items():
            yk = fwd().float()
            if yk.dim() == 4:
                yk = yk.permute(0, 2, 3, 1).reshape(n, t, ho, wo, cout).permute(0, 4, 1, 2, 3)
            rows[key] = {"max_rel_diff_to_plain": float((yk - ref).abs().max() / ref.abs().max()),
                         "kernels_fwd": _kernels(fwd),
                         "kernels_wgrad": _kernels(bwd)}
        fns = [(k, i, f) for k, fs in v.items() for i, f in enumerate(fs) if f]
        for _ in range(3):
            ms = medians_in_turns([f for *_, f in fns], reps)
            for (k, i, _), m in zip(fns, ms):
                rows[k].setdefault(("fwd_ms", "wgrad_ms", "fold_ms")[i], []).append(m)
        flops = 2 * y.numel() * 3 * kt * 49
        for r in rows.values():
            r["fwd_share_of_989"] = flops / (min(r["fwd_ms"]) * 1e-3) / 989e12
        out["stems"][name] = {"cout": cout, "kt": kt, "frames": frames,
                              "folded_channels": ch, "useful_gflop": flops / 1e9, **rows}
        del x, w, y, gy, gy2, frames2d, w2d, v, fns
        torch.cuda.empty_cache()
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=("fit", "stem", "stem_fold"))
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("release_probe needs a GPU: no CUDA device visible")
    res = {"fit": lambda: probe_fit(args.seed), "stem": probe_stem,
           "stem_fold": probe_stem_fold}[args.probe]()
    res["gpu"] = torch.cuda.get_device_name(0)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        with open(Path(args.out) / "release_probe.jsonl", "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
