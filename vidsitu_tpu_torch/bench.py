"""Measuring entry point of the port (counterpart of the JAX package's
``python bench.py <mode>``): one JSON line per metric.

    python -m vidsitu_tpu_torch.bench featext [clips] [iters]
    python -m vidsitu_tpu_torch.bench decode|decode5|decode_real|decode5_real [bs] [iters]
    python -m vidsitu_tpu_torch.bench feed [segments] [iters]      # host only
    python -m vidsitu_tpu_torch.bench gates [--batch]
    python -m vidsitu_tpu_torch.bench vbtrain|vbtrain16 [videos] [iters]
    python -m vidsitu_tpu_torch.bench srl|srl_real|evrel_real [bs] [iters] [--vocab=N]
    python -m vidsitu_tpu_torch.bench all

Flags: ``--device=cuda`` (the default; raises when no GPU is visible, never
falls back to the CPU; ``--device=cpu`` is for tests and names the CPU in
its output) and ``--dotted.key=value`` config overrides. ``train.dtype`` is
bfloat16 on a GPU and float32 on the CPU unless overridden.

Every line holds ``metric``, ``value``, ``unit``, ``device`` and the roofline
keys: achieved GB/s and TFLOP/s and their shares of the card's published
peaks, with the card named in ``roofline_of``. A line from the CPU carries
no roofline (the keys are null). Times on a GPU are CUDA-event medians over
queued calls after one warm-up (``timing.py``). ``vbtrain`` and
``vbtrain16`` time the verb model's train step; ``srl`` (narrow dims, 32
videos), ``srl_real`` (the reference's d 1024, 16 videos) and
``evrel_real`` (roberta-base, 8 videos) time the SRL and evrel train steps
with dropout on, the JAX bench's modes (its ``bench_srl_train``);
``--vocab=N`` builds the SRL model over N output classes (GPT-2's 50,281
instead of the synthetic vocabulary's 427) to time the output layer at
its real size.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .extract import resolve_device
from .timing import call_ms, kernel_rows
from .train.adam import make_adam

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
# full 700 W power limit): HBM3 bandwidth and bf16 tensor-core rate
H100_HBM_GBPS = 3350.0
H100_BF16_TFLOPS = 989.0

VB_CLASSES = 2154  # the JAX bench's verb vocabulary size
ROOFLINE_KEYS = ("hbm_gbps", "tflops", "hbm_frac", "flops_frac",
                 "roofline_frac", "roofline_of")

# the reference's production decoder dims (configs/tx_cfgs/transformer.yaml:
# d=1024, ffn=2048, 3 layers, 8 heads) for decode_real / decode5_real
REAL_TX = {
    "tx_dec.decoder_embed_dim": 1024,
    "tx_dec.decoder_ffn_embed_dim": 2048,
    "tx_dec.decoder_layers": 3,
    "tx_dec.decoder_attention_heads": 8,
    "tx_dec.encoder_embed_dim": 1024,
    "tx_dec.encoder_ffn_embed_dim": 2048,
    "tx_dec.encoder_layers": 3,
    "tx_dec.encoder_attention_heads": 8,
}
# narrow dims of the plain decode / decode5 modes
TINY_TX = {
    "tx_dec.decoder_embed_dim": 128,
    "tx_dec.decoder_ffn_embed_dim": 256,
    "tx_dec.decoder_layers": 2,
    "tx_dec.decoder_attention_heads": 4,
    "tx_dec.encoder_embed_dim": 128,
    "tx_dec.encoder_ffn_embed_dim": 256,
    "tx_dec.encoder_layers": 2,
    "tx_dec.encoder_attention_heads": 4,
}


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def compute_dtype(dev: torch.device, overrides: Optional[Dict]) -> str:
    """``train.dtype``: the override, else bfloat16 on a GPU, float32 on the
    CPU."""
    return (overrides or {}).get("train.dtype") or (
        "bfloat16" if dev.type == "cuda" else "float32")


def roofline(bytes_per_call: float, flops_per_call: float,
             wall_s_per_call: float, dev: torch.device) -> Dict:
    """Achieved GB/s and TFLOP/s and their shares of the H100's published
    peaks; the binding resource's share is ``roofline_frac``. On the CPU
    every key is None: a CPU time says nothing about the card."""
    if dev.type != "cuda":
        return dict.fromkeys(ROOFLINE_KEYS)
    gbps = bytes_per_call / 1e9 / wall_s_per_call
    tflops = flops_per_call / 1e12 / wall_s_per_call
    hbm_frac = gbps / H100_HBM_GBPS
    flops_frac = tflops / H100_BF16_TFLOPS
    return {
        "hbm_gbps": round(gbps, 1),
        "tflops": round(tflops, 2),
        "hbm_frac": round(hbm_frac, 4),
        "flops_frac": round(flops_frac, 4),
        "roofline_frac": round(max(hbm_frac, flops_frac), 4),
        "roofline_of": f"{device_name(dev)} (published peaks: "
                       f"{H100_HBM_GBPS:g} GB/s, {H100_BF16_TFLOPS:g} "
                       "TFLOP/s bf16)",
    }


def bench_slowfast_featext(clips: int = 32, iters: int = 10, device="cuda",
                           overrides: Optional[Dict] = None) -> Dict:
    """Forward throughput of the SlowFast R50 8x8 feature extractor on a
    flat clip stream (the extractor's device program: ``clip_features`` on
    (clips, T, H, W, 3) frames), seeded weights. The default of 32 clips is
    the port's ``clip_batch``. FLOPs are counted by
    ``torch.utils.flop_counter`` over one forward; the bytes are the least
    the forward must move (frames and weights read once, features written
    once)."""
    from torch.utils.flop_counter import FlopCounterMode

    from .convert.from_flax import flax_to_state_dict, seeded_variables
    from .models.selector import DTYPES
    from .models.vb_models import build_feat_extractor
    from .utils.config import get_cfg_with_overrides

    dev = resolve_device(device)
    dtype = compute_dtype(dev, overrides)
    cfg = get_cfg_with_overrides("bench", **{
        "mdl.sf_mdl_name": "slow_fast_nl_r50_8x8", **(overrides or {}),
        "train.dtype": dtype})
    model = build_feat_extractor(cfg)
    model.load_state_dict(flax_to_state_dict(seeded_variables(model, 0)),
                          strict=True)
    model.to(device=dev, memory_format=torch.channels_last_3d)
    vm = cfg.vid_mdl
    t, hw = int(vm.num_frames), int(vm.crop_size)
    gen = torch.Generator(device=dev).manual_seed(0)

    def frames(n_t):
        return torch.randn((clips, n_t, hw, hw, 3), generator=gen,
                           device=dev).to(DTYPES[dtype])

    batch = {"frms_ev_fast_tensor": frames(t),
             "frms_ev_slow_tensor": frames(t // int(vm.slowfast.alpha))}

    def forward():
        with torch.inference_mode():
            return model.clip_features(batch)

    with FlopCounterMode(display=False) as counter:
        out = forward()
    flops = float(counter.get_total_flops())
    assert out.shape[0] == clips and bool(torch.isfinite(out).all())
    moved = float(
        sum(v.numel() * v.element_size() for v in batch.values())
        + sum(p.numel() * p.element_size() for p in model.state_dict().values())
        + out.numel() * out.element_size())
    ms = float(np.median(call_ms(forward, iters, dev)))
    return {
        "metric": "slowfast_r50_8x8_featext",
        "value": round(clips * 1e3 / ms, 2),
        "unit": "clips/sec/chip" if dev.type == "cuda" else "clips/sec/cpu",
        "device": device_name(dev),
        "clips": clips,
        "dtype": dtype,
        "ms_per_forward": round(ms, 3),
        "flops_per_forward": flops,
        **roofline(moved, flops, ms / 1e3, dev),
    }


def make_vb_train(preset: str, videos: int, device, overrides=None,
                  seed: int = 1):
    """The verb model of ``preset`` at full width and depth with flax's
    initial values from ``seed``, parameters in ``train.param_dtype`` on
    ``device`` (products in ``train.dtype``), its Adam(0.9, 0.99), and a
    seeded batch of ``videos`` x 5 clips of normal frames, pre-folded, with
    zero labels. Returns (model, optimizer, batch, cfg)."""
    from .models.common import cast_params
    from .models.selector import DTYPES, init_model_variables
    from .models.vb_models import VbVideoModel
    from .models.video_backbone import VideoCfg
    from .utils.config import get_cfg_with_overrides

    dev = resolve_device(device)
    dtype = compute_dtype(dev, overrides)
    cfg = get_cfg_with_overrides("bench", **{
        "mdl.sf_mdl_name": preset, **(overrides or {}), "train.dtype": dtype})
    vid_cfg = VideoCfg.from_cfg(
        cfg.vid_mdl, dtype=DTYPES[dtype], remat=cfg.train.remat,
        remat_stages=cfg.train.remat_stages,
        bn_f32_stats=cfg.train.bn_f32_stats)
    model = init_model_variables(cast_params(
        VbVideoModel(vid_cfg, VB_CLASSES),
        DTYPES[cfg.train.param_dtype]), seed)
    model.to(dev).train()
    if dev.type == "cuda":
        model.to(memory_format=torch.channels_last_3d)
    opt = make_adam(model.parameters(), 1e-4)
    vm = cfg.vid_mdl
    t, hw = int(vm.num_frames), int(vm.crop_size)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def frames(n_t):
        return torch.randn((videos * 5, n_t, hw, hw, 3), generator=gen,
                           device=dev).to(DTYPES[dtype])

    batch = {"frms_ev_fast_tensor": frames(t),
             "label_tensor": torch.zeros((videos, 5), dtype=torch.long,
                                         device=dev)}
    if vm.arch == "slowfast":
        batch["frms_ev_slow_tensor"] = frames(t // int(vm.slowfast.alpha))
    return model, opt, batch, cfg


def bench_vb_train(videos: int = 8, iters: int = 4, accum: int = 1,
                   device="cuda", overrides: Optional[Dict] = None) -> Dict:
    """SlowFast-R50 8x8 verb-model training throughput (forward, backward,
    Adam, BatchNorm statistics) in videos/s, the JAX bench's ``vbtrain``:
    ``videos`` x 5 clips of 224 px frames a step, bf16 products, float32
    parameters and Adam. ``accum=2`` (``vbtrain16``) takes one update every
    two steps with the mean of their gradients (``train.grad_accum``), the
    global batch of 16 videos. FLOPs are counted by
    ``torch.utils.flop_counter`` over one step (forward and backward); the
    bytes are the least a step must move: the frames read once and, per
    parameter, the weight read, its gradient written and, at an update,
    read with the two Adam moments read and written and the weight written
    (4 bytes each)."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = resolve_device(device)
    model, opt, batch, cfg = make_vb_train("slow_fast_nl_r50_8x8", videos,
                                           dev, overrides)
    count = [0]

    def step():
        loss = model(batch)["loss"]
        (loss / accum).backward()
        count[0] += 1
        if count[0] % accum == 0:
            opt.step()
            opt.zero_grad(set_to_none=True)
        return loss

    with FlopCounterMode(display=False) as counter:
        loss = step()
    flops = float(counter.get_total_flops())
    assert bool(torch.isfinite(loss)), float(loss)
    n_params = sum(p.numel() for p in model.parameters())
    moved = float(sum(v.numel() * v.element_size() for v in batch.values())
                  + 4 * n_params * (2 + 6 / accum))
    ms = float(np.median(call_ms(step, iters, dev)))
    name = "slowfast_vb_train_throughput"
    if accum > 1:
        name += f"_bs{videos * accum}_accum{accum}"
    return {
        "metric": name,
        "value": round(videos * 1e3 / ms, 2),
        "unit": "videos/sec/chip" if dev.type == "cuda" else "videos/sec/cpu",
        "device": device_name(dev),
        "videos": videos,
        "accum": accum,
        "dtype": cfg.train.dtype,
        "ms_per_step": round(ms, 3),
        "flops_per_step": flops,
        **roofline(moved, flops, ms / 1e3, dev),
    }


def make_lang_train(task: str, mdl_name: str, bs: int, device, root: Path,
                    extra: Optional[Dict] = None,
                    overrides: Optional[Dict] = None,
                    vocab: Optional[int] = None, seed: int = 1):
    """An SRL or evrel model with flax's initial values from ``seed``,
    parameters in ``train.param_dtype`` on ``device`` in ``train()``
    (products in ``train.dtype``), its Adam(0.9, 0.99), and one train batch
    of ``bs`` videos of a synthetic split written under ``root``, on the
    device.
    ``vocab`` widens the SRL model's vocabulary (the batch's token ids stay
    those of the synthetic one). Returns (model, optimizer, batch, cfg)."""
    from .data import get_data
    from .data.synth import make_synth_dataset
    from .models.selector import (
        build_model,
        build_srl_model,
        init_model_variables,
    )
    from .train.learner import batch_to_device
    from .utils.config import get_cfg_with_overrides

    dev = resolve_device(device)
    paths = make_synth_dataset(root / "data", n_train=max(bs, 8), n_valid=5,
                               seed=0)
    cfg = get_cfg_with_overrides("bench", **{
        **paths, **(extra if extra is not None else TINY_TX),
        "task_type": task, "mdl.mdl_name": mdl_name, "train.bs": bs,
        "train.bsv": bs, "train.nw": 0, "train.nwv": 0,
        "misc.tmp_path": str(root / "tmp"), **(overrides or {}),
        "train.dtype": compute_dtype(dev, overrides)})
    data = get_data(cfg)
    comm = data.train_dl.dataset.comm
    if vocab:
        model = build_srl_model(cfg, vocab, comm.gpt2_hf_tok.pad_token_id)
    else:
        model = build_model(cfg, comm)
    init_model_variables(model, seed)
    model.to(dev).train()
    opt = make_adam(model.parameters(), 1e-4)
    batch = batch_to_device(next(iter(data.train_dl)), dev)
    return model, opt, batch, cfg


def train_step_fn(model, opt, batch, gen: torch.Generator):
    """One forward with dropout drawn from ``gen``, backward and Adam
    update; returns the loss on the device."""
    from .models.common import dropout_generator

    def step():
        with dropout_generator(gen):
            loss = model(batch)["loss"]
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss

    return step


def profile_step(step, dev: torch.device):
    """(the kernels of one ``step`` under ``torch.profiler``, by name; the
    wall seconds of the same step unprofiled), on a GPU."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize(dev)
    return kernel_rows(prof), wall


def device_busy(step, dev: torch.device) -> Optional[float]:
    """Share of one step's wall time that the card spends in kernels
    (``profile_step``). None on the CPU."""
    if dev.type != "cuda":
        return None
    rows, wall = profile_step(step, dev)
    return round(sum(e.self_device_time_total for e in rows) / 1e6 / wall, 4)


def bench_lang_train(task: str = "vb_arg", mdl: str = "sfpret_txe_txd_vbarg",
                     bs: int = 32, iters: int = 10,
                     extra: Optional[Dict] = None,
                     name: str = "srl_train_throughput",
                     vocab: Optional[int] = None, device="cuda",
                     overrides: Optional[Dict] = None) -> Dict:
    """Train-step throughput of a language-side model (the JAX bench's
    ``bench_srl_train``): forward with dropout on, backward and
    Adam(0.9, 0.99) on device tensors, ``bs`` videos a step. FLOPs by
    ``FlopCounterMode`` over one step; bytes the least a step must move
    (the batch read once; per parameter the weight read, its gradient
    written, then read with the two Adam moments read and written and the
    weight written, 4 bytes each); peak memory over the timed steps; the
    device-busy share of one profiled step."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="bench_train_") as tmp:
        model, opt, batch, cfg = make_lang_train(
            task, mdl, bs, dev, Path(tmp), extra, overrides, vocab)
    step = train_step_fn(model, opt, batch,
                         torch.Generator(device=dev).manual_seed(7))
    with FlopCounterMode(display=False) as counter:
        loss = step()
    flops = float(counter.get_total_flops())
    assert bool(torch.isfinite(loss)), float(loss)
    n_params = sum(p.numel() for p in model.parameters())
    moved = float(sum(v.numel() * v.element_size() for v in batch.values())
                  + 4 * n_params * 8)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ms = float(np.median(call_ms(step, iters, dev)))
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else None)
    busy = device_busy(step, dev)
    n_vocab = (model.dec_cfg.vocab_size if task == "vb_arg"
               else model.rob_cfg.vocab_size)
    if vocab:
        name += f"_v{vocab}"
    return {
        "metric": name,
        "value": round(bs * 1e3 / ms, 2),
        "unit": "videos/sec/chip" if dev.type == "cuda" else "videos/sec/cpu",
        "device": device_name(dev),
        "bs": bs,
        "mdl": mdl,
        "vocab": n_vocab,
        "dtype": cfg.train.dtype,
        "ms_per_step": round(ms, 3),
        "flops_per_step": flops,
        "peak_gib": None if peak is None else round(peak, 3),
        "device_busy": busy,
        **roofline(moved, flops, ms / 1e3, dev),
    }


def bench_srl_train(bs: int = 32, iters: int = 10, real_dims: bool = False,
                    vocab: Optional[int] = None, device="cuda",
                    overrides: Optional[Dict] = None) -> Dict:
    """``srl`` (narrow dims, 32 videos) and ``srl_real`` (the reference's
    3+3 layers at d 1024, 16 videos): ``sfpret_txe_txd_vbarg``."""
    return bench_lang_train(
        "vb_arg", "sfpret_txe_txd_vbarg", bs, iters,
        REAL_TX if real_dims else None,
        "srl_train_throughput_d1024" if real_dims else "srl_train_throughput",
        vocab, device, overrides)


def bench_evrel_train(bs: int = 8, iters: int = 10, device="cuda",
                      overrides: Optional[Dict] = None) -> Dict:
    """``evrel_real``: ``rob_evrel`` at the config's roberta-base dims."""
    return bench_lang_train("evrel", "rob_evrel", bs, iters, {},
                            "evrel_train_throughput_robbase", None, device,
                            overrides)


def seg_schedule(budget_steps: int, seg_min: int):
    """Segmented-decode schedule as [(n_steps, cache_len)]: the cache starts
    at ``seg_min`` positions and doubles between segments
    (gen/generate.py, ``seg_bounds``)."""
    if seg_min <= 0 or seg_min >= budget_steps:
        return [(budget_steps, budget_steps)]
    out, prev, cap = [], 0, seg_min
    while cap < budget_steps:
        out.append((cap - prev, cap + 1))
        prev, cap = cap, cap * 2
    out.append((budget_steps - prev, budget_steps))
    return out


def decode_traffic_bytes(cfg, params_bytes: float, cache_itemsize: int,
                         bs: int, beam: int,
                         steps: Optional[int] = None) -> float:
    """Analytic device-memory traffic of one decode of ``bs`` videos: per
    step, attention reads the self K/V cache rows up to the segment length,
    plus every weight once (products with few rows are bound by reading the
    weights). ``steps`` cuts the schedule to the steps a decode really took
    (every beam may finish before the budget); None counts the whole
    budget, as the JAX bench does."""
    d = int(cfg.tx_dec.decoder_embed_dim)
    layers = int(cfg.tx_dec.decoder_layers)
    rows = bs * 5 * beam
    budget = min(int(cfg.gen.max_len_b), 1023) + 1
    left = budget if steps is None else min(int(steps), budget)
    total = 0.0
    for n_steps, cache_len in seg_schedule(budget, int(cfg.tpu.seg_decode_min)):
        n = min(n_steps, left)
        left -= n
        total += n * (layers * rows * cache_len * d * 2 * cache_itemsize
                      + params_bytes)
    return total


def setup_decode(bs: int, dev: torch.device, dtype: str, root: Path,
                 extra: Optional[Dict] = None,
                 overrides: Optional[Dict] = None):
    """A synthetic SRL decoding problem: ``(cfg, comm, model, batch)`` with a
    seeded ``sfpret_txe_txd_vbarg`` on ``dev`` and one train batch of ``bs``
    videos from a synthetic dataset written under ``root``."""
    from .convert.from_flax import flax_to_state_dict, seeded_variables
    from .data import get_data
    from .data.synth import make_synth_dataset
    from .models.selector import build_model
    from .utils.config import get_cfg_with_overrides

    paths = make_synth_dataset(root / "data", n_train=max(bs, 8), n_valid=5,
                               seed=0)
    cfg = get_cfg_with_overrides("bench", **{
        **paths, **(extra if extra is not None else TINY_TX),
        "task_type": "vb_arg", "mdl.mdl_name": "sfpret_txe_txd_vbarg",
        "train.bs": bs, "train.bsv": bs, "train.nw": 0, "train.nwv": 0,
        "misc.tmp_path": str(root / "tmp"), **(overrides or {}),
        "train.dtype": dtype})
    data = get_data(cfg)
    comm = data.train_dl.dataset.comm
    model = build_model(cfg, comm)
    model.load_state_dict(
        flax_to_state_dict(seeded_variables(model, int(cfg.train.seed))),
        strict=True)
    model.to(dev).eval()
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in next(iter(data.train_dl)).items()}
    return cfg, comm, model, batch


def bench_srl_decode(bs: int = 16, iters: int = 5, beam: int = 1,
                     real_dims: bool = False, device="cuda",
                     overrides: Optional[Dict] = None) -> Dict:
    """SRL decode latency (ms per 5-event video) through
    ``models.selector.build_srl_generate_fn``, tokens fetched to the host
    after every call. ``real_dims`` takes the reference's d=1024, 3-layer
    decoder and adds the roofline of the analytic cache-plus-weights traffic
    for the steps the decode took."""
    from .models.selector import build_srl_generate_fn

    dev = resolve_device(device)
    dtype = compute_dtype(dev, overrides)
    with tempfile.TemporaryDirectory(prefix="bench_decode_") as tmp:
        cfg, comm, model, batch = setup_decode(
            bs, dev, dtype, Path(tmp), REAL_TX if real_dims else None,
            overrides)
        if beam != 1:
            cfg.gen.beam_size = beam
        gen_fn = build_srl_generate_fn(cfg, comm, model)

        def call():
            return gen_fn(batch).cpu()

        call()  # warm-up
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            call()
            times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    steps = gen_fn.steps[-1]
    name = ("srl_greedy_decode_latency" if beam == 1
            else f"srl_beam{beam}_decode_latency")
    if real_dims:
        name += "_d1024"
    out = {
        "metric": name,
        "value": round(dt / bs * 1e3, 3),
        "unit": "ms/video",
        "device": device_name(dev),
        "bs": bs,
        "dtype": dtype,
        "steps": steps,
        "ms_per_step": round(dt * 1e3 / max(steps, 1), 4),
        **dict.fromkeys(ROOFLINE_KEYS),
    }
    if real_dims:
        params = list(model.parameters())
        out.update(roofline(decode_traffic_bytes(
            cfg, sum(p.numel() * p.element_size() for p in params),
            torch.empty((), dtype=model.dec_cfg.dtype).element_size(), bs,
            beam, steps=steps), 0.0, dt, dev))
    return out


def bench_host_feed(segments: int = 4, iters: int = 3) -> Dict:
    """Host input-pipeline rates (no GPU): JPEG-decode clips/s against
    decoded-uint8 frame-cache clips/s at the real 224 px geometry, from
    1280x720 JPEGs as the reference's data preparation stores them."""
    import os
    import shutil

    from PIL import Image

    from .data.frames import load_event_clips, write_segment_cache

    class _VidCfg:
        reverse_input_channel = False
        arch = "slowfast"

        class slowfast:
            alpha = 4

        mean = [0.45, 0.45, 0.45]
        std = [0.225, 0.225, 0.225]

    root = tempfile.mkdtemp(prefix="feedbench_")
    frames, cache = f"{root}/frames", f"{root}/cache"
    rng = np.random.default_rng(0)
    segs = [f"v_seg_{i}" for i in range(segments)]
    cent = {f"Ev{e}": 30 + 60 * (e - 1) for e in range(1, 6)}
    try:
        # structured content (gradients + noise): pure noise has no DCT
        # sparsity and would overstate the decode cost
        yy, xx = np.mgrid[0:720, 0:1280]
        base = np.stack(
            [xx * 255 // 1279, yy * 255 // 719, (xx + yy) * 255 // 1998],
            axis=-1).astype(np.int16)
        for seg in segs:
            os.makedirs(f"{frames}/{seg}", exist_ok=True)
            for ix in range(1, 301):
                arr = (base + rng.integers(0, 48, (720, 1280, 3))).clip(
                    0, 255).astype(np.uint8)
                Image.fromarray(arr).save(
                    f"{frames}/{seg}/{seg}_{ix:06d}.jpg", quality=92)

        def run(cache_dir, keep_uint8=False, reps=iters):
            for _ in range(reps):
                for seg in segs:
                    load_event_clips(
                        frames, seg, cent, frm_seq_len=64, sampling_rate=2,
                        vid_cfg=_VidCfg, out_hw=224, cache_dir=cache_dir,
                        cache_write=False, keep_uint8=keep_uint8)

        def rate(cache_dir, keep_uint8=False):
            run(cache_dir, keep_uint8, reps=1)  # warm the page cache
            t0 = time.perf_counter()
            run(cache_dir, keep_uint8)
            return segments * 5 * iters / (time.perf_counter() - t0)

        jpeg_rate = rate(None)  # the native C++ decode core when it builds
        os.environ["VIDSITU_NO_NATIVE"] = "1"
        try:
            jpeg_rate_pil = rate(None)  # forced per-frame PIL decoding
        finally:
            os.environ.pop("VIDSITU_NO_NATIVE", None)
        t0 = time.perf_counter()
        for seg in segs:
            write_segment_cache(frames, seg, cache, out_hw=224)
        build_s_per_seg = (time.perf_counter() - t0) / segments
        cache_rate = rate(cache)
        cache_u8_rate = rate(cache, keep_uint8=True)
        return {
            "metric": "host_feed_cache_clips_per_sec",
            "value": round(cache_rate, 1),
            "unit": "clips/sec",
            "device": "cpu (host only)",
            "jpeg_decode_clips_per_sec": round(jpeg_rate, 1),
            "jpeg_decode_pil_clips_per_sec": round(jpeg_rate_pil, 1),
            "cache_uint8_clips_per_sec": round(cache_u8_rate, 1),
            "cache_build_sec_per_segment": round(build_s_per_seg, 2),
            **dict.fromkeys(ROOFLINE_KEYS),
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


def bench_gates(batch: bool = False, device="cuda") -> Dict:
    from . import gates

    return {"metric": "stack_gates", "value": 0, "unit": "decisions",
            **gates.main(batch=batch, device=device)}


def run_all(device="cuda", overrides: Optional[Dict] = None) -> List[Dict]:
    """Every ported mode, one JSON line each as it completes."""
    modes = [
        (bench_slowfast_featext, {}),
        (bench_srl_train, {}),
        (bench_srl_train, {"real_dims": True, "bs": 16}),
        (bench_evrel_train, {}),
        (bench_srl_decode, {"real_dims": True}),
        (bench_srl_decode, {"real_dims": True, "beam": 5}),
    ]
    results = []
    for fn, kw in modes:
        results.append(fn(device=device, overrides=overrides, **kw))
        print(json.dumps(results[-1]), flush=True)
    results.append(bench_gates(device=device))
    print(json.dumps(results[-1], default=str), flush=True)
    return results


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    """Run one mode; prints and returns its JSON-able results."""
    argv = list(sys.argv[1:] if argv is None else argv)
    which = argv[0] if argv and not argv[0].startswith("--") else "all"
    sizes = [int(a) for a in argv[1:] if not a.startswith("--")]
    flags = {"device": "cuda", "vocab": ""}
    overrides: Dict[str, str] = {}
    batch = False
    for a in argv:
        if a == "--batch":
            batch = True
        elif a.startswith("--") and "=" in a:
            key, val = a[2:].split("=", 1)
            (flags if key in flags else overrides)[key] = val
        elif a.startswith("--"):
            raise SystemExit(f"expected --key=value or --batch, got {a!r}")
    kw = dict(device=flags["device"], overrides=overrides)
    if which == "all":
        return run_all(**kw)
    if which == "featext":
        res = bench_slowfast_featext(*sizes[:2], **kw)
    elif which in ("decode", "decode5", "decode_real", "decode5_real"):
        kw.update(zip(("bs", "iters"), sizes))
        res = bench_srl_decode(beam=5 if "5" in which else 1,
                               real_dims=which.endswith("_real"), **kw)
    elif which in ("srl", "srl_real"):
        kw.update(zip(("bs", "iters"), sizes))
        if which == "srl_real":
            kw.setdefault("bs", 16)
        res = bench_srl_train(real_dims=which == "srl_real",
                              vocab=int(flags["vocab"] or 0) or None, **kw)
    elif which == "evrel_real":
        kw.update(zip(("bs", "iters"), sizes))
        res = bench_evrel_train(**kw)
    elif which in ("vbtrain", "vbtrain16"):
        kw.update(zip(("videos", "iters"), sizes))
        res = bench_vb_train(accum=2 if which == "vbtrain16" else 1, **kw)
    elif which == "feed":
        res = bench_host_feed(*sizes[:2])
    elif which == "gates":
        res = bench_gates(batch=batch, device=flags["device"])
    else:
        raise SystemExit(f"unknown bench mode {which!r}")
    print(json.dumps(res, default=str), flush=True)
    return [res]


if __name__ == "__main__":
    main()
