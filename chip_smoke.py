#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vidsitu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases, each of which must pass (any failure raises and exits non-zero):

1. build: the non-local attention kernels (one source, two entries: the
   wgmma kernel and the wmma / float32 one) from vidsitu_tpu_torch/csrc/;
2. kernel vs plain: both entries against the plain PyTorch version at the
   I3D-NL 224 px shapes (B=8: stage 3 3136x784x256, stage 4 784x196x512),
   a ragged one (200x200x128) and two whose Sq and Sk are no multiples of
   the wgmma kernel's tiles (B=8 130x57x256, B=3 65x196x512), both kinds,
   with the JAX package's tolerances (atol 2e-4 float32, which only the
   wmma entry takes; 5e-2 bf16, or one bf16 step of the largest output
   where that is more); the wgmma entry also against the plain version
   that repeats its tiled arithmetic; then the wgmma entry, the wmma entry,
   the plain version and the library's fused attention timed in turns in
   bf16 at the main path's batch (32 clips);
3. main path: ``extract_features`` of I3D-NL R50 (full width and depth,
   224 px, 8 frames, bf16, seeded weights with non-zero BatchNorm gammas)
   over a synthetic valid split of 8 segments = 40 clips at clip_batch 32:
   2 dispatches (the second zero-padded), 8 files of (5, 2048), finite, and
   exactly 5 non-local blocks x 2 dispatches kernel launches, all on the
   entry that ``kernel_entry`` names for bf16 at d = 256 and 512;
4. kernel path == plain path: one batch of those clips through the model
   once with the routed kernel and once with the plain attention, features
   within 2e-2 of the feature scale (bf16); the forward timed in turns with
   the routed kernel, with the wmma entry forced, and with the plain
   attention;
5. the default configuration (SlowFast R50 8x8) forward on 8 clips;
6. build: the beam-cache row-gather kernel (built with phase 1's, both
   nvcc processes started together);
7. kernel vs plain: the row gather against ``index_select`` on the SRL
   decode's cache at beam 5 (400 rows; per layer 2 self leaves of
   8 x L x 128 for L = 65, 129, 201 and 2 cross leaves of 8 x 1 x 128;
   3 layers = 12 leaves per launch), bf16 and float32, bit-identical; then
   the 12-leaf reorder at each L timed against the plain version, in
   turns, with calls queued back to back (device time) and one call at a
   time (host time of the wrapper included);
8. SRL main path: ``python -m vidsitu_tpu_torch.main`` in process,
   ``sfpret_txe_txd_vbarg`` at full width (3+3 layers, d 1024, 8 heads),
   bf16, seeded weights, beam 5 without ancestry, on the features phase 3
   wrote (8 real segments padded to the eval batch of 16 = 400 beam rows):
   one pkl entry per segment with 5 events whose text starts with the
   forced verb, finite metrics, and exactly one kernel launch per decode
   step;
9. routes agree on that batch: the reorder route with the kernel and with
   the plain gather (identical tokens and scores, timed in turns), the
   ancestry route against the reorder route in float32 (tokens equal on
   >= 95 % of events, see ROUTE_AGREEMENT), greedy once; each route's
   time per batch; then a ``torch.profiler`` trace of one more decode of
   the main path's batch (phase 8's profile);
10. the generator alone at the real vocabulary size (GPT-2's 50,257 tokens
   plus the 23 role/separator tokens and pad), beam 5, both routes, timed;
11. build: the fused inference bottleneck and the copy probes (built with
   phase 1's and phase 6's, four nvcc processes started together);
12. kernel vs plain: the fused bottleneck's four C entries (the kernel
   designed for Hopper: wgmma, persistent blocks, resident weights, behind
   both wrappers; the first kernel: one block per tile and frame, or several
   frames per block), routed and forced, against the plain version in
   float32 (atol 2e-4) and bf16 (5e-2 of the output scale) at slow-s2 with
   projection (56x56, 80->64->256), slow-s2 without (256/64/256), slow-s3
   (28x28, 512/128/512) and a ragged one (7x9, 24->16->32, with projection),
   seeded non-zero shifts; the wgmma entries also against the plain version
   that repeats their walk, and 67 frames in groups of 1, 2, 3 and 7 (more
   steps than blocks, runs that cross groups); the two shapes that stay on
   the first kernel timed at 256 frames; then the routed entries, the first kernel's
   entries forced and the unfused chain (``Bottleneck.forward``, bf16,
   channels-last) timed in turns at 256 and 960 frames, three ``F.conv2d``
   on the folded weights as a second library yardstick, the routed kernel
   with calls queued back to back, and the plain version timed at 256;
13. this slice's model path at full width: one forward of the seeded
   SlowFast R50 8x8 (phase 5's model) on 8 clips in bf16 with hooks on the
   six eligible slow-pathway blocks (s2 blocks 0-2, s3 blocks 1-3);
   ``run_fused_block`` on each captured input equals the captured output
   within 2e-2 of its scale; six kernel launches, s2 blocks 1-2 on the
   wgmma entry, the others on the first kernel's;
14. the copy probes bit-identical to their input on a 768 MB bf16 tensor,
   at every block shape, the TPU probe's VMEM-sized blocks refused; GB/s of
   each beside ``clone()`` and one elementwise op;
15. ``vidsitu_tpu_torch.bench`` in process: ``gates`` (FLIP / no-flip lines),
   ``featext 32`` and ``decode5_real``, one JSON line each;
16. the attention's backward entries (built in phase 1 from the same
   source; ``ptxas`` registers and spills of their kernels printed):
   ``nl_attn_bwd_wgmma`` routed in bf16, ``nl_attn_bwd`` forced in bf16 and
   routed in float32, each against the plain backward and the plain version
   that repeats its own tiles, and the forward's log-sum-exp against the
   plain one, at phase 2's shapes, both kinds (error relative to each
   gradient's scale: 2e-4 float32; 5e-2 bf16, or one bf16 step of the
   largest gradient where that is more); two calls of the wgmma entry
   bitwise equal; then both entries, autograd of the plain attention and
   the library's fused attention's backward timed in turns at B = 80 (s3
   and s4);
17. this slice's main path: ``python -m vidsitu_tpu_torch.main
   --task_type=vb`` in process, I3D-NL R50 at full width and depth, bf16
   products, float32 parameters and Adam, on a synthetic 224 px split of 8
   train segments (2 steps of 4 videos = 20 clips an epoch): two epochs,
   each validated, the best model validated again, then a second call that
   resumes epoch 2's checkpoint by uid for one more epoch. Finite losses,
   weights and BatchNorm statistics moved, ``{uid}.ckpt``, 5 events x 5
   verbs per segment in ``valid_0.pkl``, the optimizer state restored, and
   exactly 5 forward launches a train step and an eval batch and 5
   backward launches a train step, all on the routed entries
   (``nl_attn_fwd_wgmma``, ``nl_attn_bwd_wgmma``);
18. one I3D-NL train step at the config's batch (16 videos = 80 clips) on
   device tensors with the kernels and with the plain attention under
   autograd: loss and every non-local block's theta / phi / g / out
   gradients within 5e-2 of their scale; the update timed in turns (ms,
   videos/s, TFLOP/s by ``FlopCounterMode``), peak memory, and a
   ``torch.profiler`` breakdown of one update;
19. ``vidsitu_tpu_torch.bench`` ``vbtrain`` and ``vbtrain16`` in process
   (SlowFast R50 8x8, 8 videos a step, the second with grad_accum 2);
20. this slice's main path: ``python -m vidsitu_tpu_torch.main
   --task_type=vb_arg`` in process, ``sfpret_txe_txd_vbarg`` at full width
   (3+3 layers, d 1024, 8 heads), bf16 products, float32 parameters and
   Adam, dropout on, flax's initial values, on a synthetic split's seeded
   (5, 2048) features (32 train segments: 2 steps of 16 videos an epoch; 8
   valid segments in one eval batch of 16): two epochs, each validated at
   beam 5 on the reorder route, the best model validated again, then a
   second call that resumes epoch 2's checkpoint by uid for a third. Finite
   losses, every weight matrix moved, ``{uid}.ckpt``, the optimizer's step
   count and the dropout generator's offset continued (3/2 of epoch 2's),
   one pkl entry a segment with 5 events that start with their verbs, and
   exactly one ``beam_gather_rows`` launch per decode step of every
   validation;
21. one SRL step at 16 videos on device tensors (the same model), bf16
   against float32 from the same initial values, dropout off: loss within
   1e-2 relative; every gradient that is well-conditioned at these weights
   within 5e-2 of its scale (no less than 1e-3 of the model's largest
   gradient): one whose float32 value moves by less than 1e-2 of its scale
   when only the batch's float inputs are rounded to bf16 (a third step);
   the others printed (see STEP_GRAD_TOL); then the bf16 step with dropout
   on timed (ms, videos/s, TFLOP/s by ``FlopCounterMode``, peak memory) and
   a ``torch.profiler`` breakdown of one step with the device-busy share;
22. ``main.py --task_type=evrel`` for ``rob_evrel`` and ``sfpret_evrel`` at
   roberta-base dims (12 layers, d 768, 12 heads, ffn 3072), 8 videos a
   step, on the same split: two epochs plus the resumed third as in phase
   20, the top-1 relation per pair and annotator in ``valid_0.pkl``, finite
   ``Macro_Top_1`` / ``Top_1`` and validation loss; then phase 21's step
   check and timing for each at 8 videos;
23. ``vidsitu_tpu_torch.bench`` ``srl``, ``srl_real`` at the synthetic
   vocabulary (427) and at GPT-2's (50,281), and ``evrel_real``, one JSON
   line each;
24. several processes, one rank: ``python -m torch.distributed.run
   --standalone --nproc_per_node=1`` of this script in child mode
   (``--dist-child``), which calls ``vidsitu_tpu_torch.main.main`` with
   ``--dist_backend=nccl``: phase 17's fit (same data, size and width) for
   one epoch and its validation through the several-process code path (the
   process group, the gradient all-reduce); its first-step loss and its
   epoch agree with phase 17's first (DP_BF16_RTOL, DP_METRIC_ATOL), 20
   forward and 10 backward launches on the routed entries;
25. two ranks on the one card (``--device=cuda:0 --dist_backend=gloo``:
   NCCL refuses two ranks on one GPU), one torchrun each: the same fit with
   the global batch split in two (BatchNorm statistics and the loss over
   the global batch; then a float32 first step whose global loss equals one
   process's within DP_LOSS_RTOL), SRL validation at full width
   (``--only_val``, beam 5, the reorder route, 16 segments a rank as in
   phase 8: rank 0's
   merged ``valid_0.pkl`` equals phase 8's entry for entry, one row-gather
   launch per decode step on each rank), and the I3D-NL R50 extraction
   (``vidsitu_tpu_torch.extract.main``: phase 3's 8 files, each within
   FEATURE_RTOL). Each rank sets the kernels' counts to 0 before its entry
   point, reads them after it, and then holds each kernel of its path
   against the plain version once at its own shapes;
26. ``python -m vidsitu_tpu_torch.verify_release --fit --device=cuda`` in
   a subprocess, at the module's defaults (2 epochs, train.seed 42): the
   training lifecycle of ``vb/sf_base``, ``vb_arg/sfpret_txe_txd_vbarg``
   and ``evrel/rob_evrel`` at the JAX module's tiny dims (epochs,
   validation, the best checkpoint, a final validation writing
   ``valid_0.pkl``, resume by uid, one more epoch): every task ``[ok]``, rc
   0, each task's loss drops (the first batch under the first step's
   masks), its pickle exists, its metrics are finite; the receipt printed. No kernel lies on this
   path (SlowFast has no non-local block; SRL validates on the ancestry
   route);
27. the release checks at full width on phase 17's 224 px tree and its
   vocab dirs: ``train_step_check`` of ``vb/sf_base`` (SlowFast R50 8x8),
   ``vb_arg/tx_only``, ``vb_arg/sfpret_txe_txd_vbarg`` (d 1024, features
   2048) and ``evrel/rob_evrel`` (roberta-base widths), each ``[ok]`` with
   its step's ms and peak GiB; then ``main --weights`` on a SFBase .pth in
   PySlowFast's layout made from the port's seeded R50 model (``[ok]``, and
   loaded back equal to it) beside an unrecognised .pt (``[skip]``);
28. a resize with the kernels: phase 17's I3D-NL R50 fit in float32
   (``nl_attn_fwd`` / ``nl_attn_bwd``), epoch 1 on 2 gloo ranks on cuda:0,
   saved (the ranks of phase 33's launch, before their resize); epoch 2 resumed from it on one NCCL rank; against a straight
   2-epoch run in this process: the epoch-2 loss within ELASTIC_RTOL, the
   parameters and the statistics each within ELASTIC_DRIFT of the epoch's
   update, 20 forward and 10 backward launches an epoch in every run and
   rank, the txt log's resize line (deterministic algorithms in those runs;
   the repeat of the resumed epoch 2, bitwise, is phase 33's). Two controls resume the same checkpoint in this process
   the wrong way (Adam's state left out; another data order, train.seed
   43): each must part from the straight run by more than ELASTIC_RTOL and
   ELASTIC_DRIFT;
29. dropout that does not depend on the number of ranks, and a grad_accum
   cycle carried through a checkpoint: ``sfpret_txe_txd_vbarg`` at full
   width (d 1024, dropout 0.1, float32 products, global batch 16,
   ``train.grad_accum=2``). The first step's global loss on 2 gloo ranks on
   cuda:0 equals one process's within DP_LOSS_RTOL; with the ranks'
   generators seeded apart (the control) it parts by more. The 2 ranks
   save after step 3 (a cycle in flight), one process resumes for steps
   4-6: the parameters within DROP_DRIFT of the straight run's steps 4-6
   update, the losses within DP_LOSS_RTOL; resumed without the cycle (the
   control), beyond DROP_DRIFT;
30. fsdp on the card: one NCCL rank on a (1, 1) ``data`` x ``fsdp`` mesh
   (gloo does not carry FSDP2's reduce-scatter on CUDA tensors and NCCL
   refuses two ranks on one card), ``build_learner`` sharding the I3D-NL
   R50 (``fully_shard`` on its bottlenecks, non-local blocks and root):
   one update at 80 clips in bf16 against one process's from the same
   weights (contiguous, as FSDP2 keeps parameters): the loss within
   DP_BF16_RTOL, the parameters and statistics within ELASTIC_DRIFT of the
   update; 5 ``nl_attn_fwd_wgmma`` and 5 ``nl_attn_bwd_wgmma`` launches an
   update; then the fsdp, contiguous and channels-last updates timed in
   turns, with their peak memory, and the layout a sharded convolution
   receives;
31. phase 28's fit under fsdp (one NCCL rank, (1, 1) mesh) saved after
   epoch 1 through ``ckpt_backend=orbax`` (torch.distributed.checkpoint,
   generations behind ``LIVE``), epoch 2 resumed on one NCCL rank without
   fsdp: against phase 28's straight run within phase 28's limits, 20
   forward and 10 backward launches an epoch in each run;
32. tensor parallelism: 2 gloo ranks on cuda:0 on a ``[1, 2]`` ``data`` x
   ``model`` mesh (each rank 4 of the 8 heads and 1024 of the 2048 hidden
   columns), one torchrun launch, against one process in this process:
   ``sfpret_txe_txd_vbarg`` at d 1024 in float32 with dropout 0.1 (also on
   the attention probabilities and the FFN activation, the sites inside
   the split region) trained one step of 16 videos through
   ``vidsitu_tpu_torch.main`` and validated at beam 5 on the reorder
   route: the first-step loss within DP_LOSS_RTOL, the split leaves'
   gradients gathered whole within TP_GRAD_RTOL of the largest, one
   ``beam_gather_rows`` launch per decode step on each rank, each reorder
   of a rank's 4-head cache bitwise equal to ``index_select``, at least
   ROUTE_AGREEMENT of the validation events equal to one process's; a
   one-step pair on ``build_learner``: the TP loss within DP_LOSS_RTOL,
   and with each rank drawing a dropout mask of its own slice's shape (the
   control) outside it; one ``rob_evrel`` step at roberta-base widths (12
   heads, ffn 3072) within DP_LOSS_RTOL; then the bf16 TP step and one
   process's timed (recorded only) with the device-busy share;
33. the mid-run resize: phase 28's I3D-NL R50 fit in float32 on 2 gloo
   ranks on cuda:0 through ``build_learner`` (one launch, run in phase 28,
   whose saved epoch 1 it gives), ``Learner.request_resize(1)``
   before ``fit``: rank 1 leaves at the end of epoch 1 (after the
   validation and the saves), rank 0 fits epoch 2 alone; against phase
   28's straight run (no new one): the epoch-2 loss within ELASTIC_RTOL,
   the parameters and the statistics within ELASTIC_DRIFT of the epoch's
   update, phase 28's two wrong resumes outside those limits, epoch 2
   bitwise phase 28's checkpoint resume (the same epoch 1, then one rank
   under deterministic algorithms), the txt log's resize line, and 20
   ``nl_attn_fwd`` / 10 ``nl_attn_bwd`` launches an epoch on each rank
   that trained it (rank 1: epoch 1 only);
34. the port's dry run (``python -m vidsitu_tpu_torch.dryrun --n 2
   --device cuda``, the counterpart of ``__graft_entry__.dryrun_multichip``)
   in a subprocess: 2 gloo ranks sharing the card (``data`` [2]; the
   tensor-parallel step on ``data`` x ``model`` [1, 2]) against one
   process at the JAX entry's tiny sizes and limits: the three tasks'
   steps, the TP step, the segmented ancestry beam decode, the extractor
   and an elastic 2 -> 1 resume; its 8 lines and its receipt printed;
35. the dtype surface, run after phase 19: (a) every float16 attention
   entry that takes the input (``nl_attn_fwd_wgmma`` / ``nl_attn_bwd_wgmma``
   routed at d 64-512, ``nl_attn_fwd`` / ``nl_attn_bwd`` forced there and
   routed at d = 24) against the plain and the tiled plain versions at
   phase 2's shapes and d = 24, both kinds, output gradients of scale 1
   and 2^-14 (the dS scale at work): outputs within 2e-2 of their scale,
   gradients within 5e-2; then timed at s3 / s4 (forward B = 32, backward
   B = 80) against the forced entries, the plain version and the
   library's float16 fused attention and its backward; (b)
   ``train.dtype=float16`` through ``extract_features`` on phase 3's split
   (10 float16 ``nl_attn_fwd_wgmma`` launches), the 32-clip features with
   the kernels against the plain attention within 2e-2 of their scale (5
   launches, none from the plain path), and one 80-clip
   ``Learner.train_step`` (5 + 5 float16 launches); (c) one I3D-NL R50
   update at 80 clips with ``train.dtype=train.param_dtype=bfloat16``
   through ``Learner.train_step`` (Adam in the parameters' dtype): the loss
   within 1e-2 of phase 18's float32-parameter loss, 5 + 5 bf16 launches,
   bf16 parameters and moments, float32 statistics, the update's ms and
   peak memory beside phase 18's; (d) ``sfpret_txe_txd_vbarg`` at d 1024
   with bf16 parameters: one train step of 16 videos, then a beam-5 decode
   of one batch on the reorder route, one ``beam_gather_rows`` launch a
   step, every reorder bitwise equal to ``index_select``.

Phases 1-32 run as before, at the same depth and repeats. A child that
fails, a launch past DP_TIMEOUT_S or a disagreement fails the smoke.

Prints the GPU's name and power limit first, a JSON line of kernel results
before the last line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import functools
import json
import math
import pickle
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
S3, S4, RAGGED = (3136, 784, 256), (784, 196, 512), (200, 200, 128)
# (name, B, (Sq, Sk, d)) of phase 2's checks; the last two are ragged against
# the wgmma kernel's 128 / 64 query rows and 80 / 32 keys per tile
ATTN_CHECKS = (("s3", 8, S3), ("s4", 8, S4), ("ragged", 8, RAGGED),
               ("ragged-d256", 8, (130, 57, 256)),
               ("ragged-d512", 3, (65, 196, 512)))
ATOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
V1_ENTRY = "nl_attn_fwd"  # the wmma / float32 entry
BWD_V1_ENTRY = "nl_attn_bwd"  # the backward's wmma / float32 entry
FEATURE_RTOL = 2e-2  # kernel vs plain path, relative to max |feature|
# built together: phases 1, 6 and 11 (twice)
KERNELS = ("nonlocal_attn", "beam_gather", "fused_bottleneck", "copy_probe")
BUILD_PHASE = dict(zip(KERNELS, (1, 6, 11, 11)))
# published peaks of one H100 SXM (NVIDIA's data sheet, 700 W), for bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "float32": 67e12}
# fused bottleneck shapes: (H, W, Cin, Cmid, Cout, projection)
FB_SHAPES = {
    "slow-s2 proj": (56, 56, 80, 64, 256, True),
    "slow-s2": (56, 56, 256, 64, 256, False),
    "slow-s3": (28, 28, 512, 128, 512, False),
    "ragged proj": (7, 9, 24, 16, 32, True),
}
FB_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}  # bf16: of the scale
FB_FRAMES_TPU = "benchmarks/probe_fused_bottleneck.py:108"
FB_MULTI_TPU = "benchmarks/micro4.py:84"
FUSED_BLOCKS = ("s2_slow.block_0", "s2_slow.block_1", "s2_slow.block_2",
                "s3_slow.block_1", "s3_slow.block_2", "s3_slow.block_3")
# the C entry each takes: the wgmma kernel at 256 -> 64 -> 256; s2 block 0
# (projection from 80 channels) and s3 (Cmid 128) stay on the first kernel
FUSED_BLOCK_ENTRY = {name: "fused_bottleneck_frames" + (
    "_wgmma" if name in ("s2_slow.block_1", "s2_slow.block_2") else "")
    for name in FUSED_BLOCKS}
# SRL decode at beam 5: 16 segments x 5 events x 5 beams, 3 decoder layers
BEAM, EVENTS, HEADS, HEAD_DIM, LAYERS = 5, 80, 8, 128, 3
SELF_LENS = (65, 129, 201)  # the segmented cache: 64, 128, then 200 + 1
REAL_VOCAB = 50257 + 1 + 2 * 11 + 1  # GPT-2 + <EV_SEP> + <ArgX>/</ArgX> + pad
# ancestry vs reorder in float32, share of events with equal top-beam tokens.
# The routes sum in other orders (cuBLAS takes a gemv for the reorder
# route's one query per row, a gemm for ancestry's five), and with seeded
# weights the 427-way output distributions are flat, so a near-tie among
# the 10 candidates flips now and then: 396 of 400 events agreed over 5
# batches on the H100. A broken route disagrees on most events.
ROUTE_AGREEMENT = 0.95
QUEUED = 10  # calls queued between two CUDA events: device time per call
# the backward check's tolerance, relative to each gradient's scale
BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
VB_BS = 4  # videos a train step of phase 17 (20 clips)
NL_BLOCKS = 5  # i3d_r50_nl_8x8: s3 blocks 1, 3 and s4 blocks 1, 3, 5
BWD_TPU = "vidsitu_tpu/ops/attention.py:121"  # jax.grad of _einsum_attention
DP_RANKS = 2  # phase 25: ranks on the one card
EVALB_KEYS = ("Per_Ev_Top_1", "Per_Ev_Top_5", "recall_macro_1_th_9")
# phase 24 against phase 17: two of the 40 events a metric counts may flip
# (the updates differ by rounding: the backward's sums run in other orders)
DP_METRIC_ATOL = 0.05


T0 = time.perf_counter()


def log(*a):
    """Print; a phase's line (``[n name] ...``) ends with the seconds since
    the script started."""
    text = " ".join(str(x) for x in a)
    if text.startswith("["):
        text += f"  @{time.perf_counter() - T0:.0f}s"
    print(text, flush=True)


def bound(n_bytes: float, n_ops: float, kind: str = "bf16"):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of bytes over its memory rate and operations over its peak rate."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def attn_limit(dtype, ref):
    """The attention check's tolerance: ATOL, and for bf16 no less than one
    bf16 step at the largest output. A dot_product over few keys gives
    outputs beyond 6.4, where one rounding step of the bf16 output itself
    (2**-4 from 8 on) exceeds 5e-2, for any kernel and the plain version."""
    if dtype != torch.bfloat16:
        return ATOL[dtype]
    top = ref.abs().max().item()
    return max(ATOL[dtype], 2.0 ** (math.floor(math.log2(top)) - 7))


def seeded_qkv(rng, b, sq, sk, d, dtype, dev):
    return [torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))
            .to(dev, dtype) for s in (sq, sk, sk)]


def phase_build():
    """Phases 1, 6 and 11: every kernel from the checkout's source, one nvcc
    per source, all started together."""
    from vidsitu_tpu_torch.ops import _build

    def timed(name):
        t0 = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - t0

    for name in KERNELS:
        _build.library_path(name).unlink(missing_ok=True)
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        secs = dict(zip(KERNELS, pool.map(timed, KERNELS)))
    _build.load_nonlocal_attn()
    _build.load_beam_gather()
    _build.load_fused_bottleneck()
    _build.load_copy_probe()
    for name, phase in BUILD_PHASE.items():
        log(f"[{phase} build] {name}.cu -> {_build.library_path(name).name} "
            f"in {secs[name]:.2f} s")
        for line in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "Used" in line or "spill" in line:
                log("    ptxas:", line.strip())


def phase_kernel(dev):
    """Phase 2: every entry that takes the input against the plain version,
    then the four ways to compute the attention timed in turns."""
    from vidsitu_tpu_torch.ops import attention as A

    rng = np.random.default_rng(0)
    worst = {name: 0.0 for name in A.ENTRIES}  # bf16, by entry
    for name, b, (sq, sk, d) in ATTN_CHECKS:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = seeded_qkv(rng, b, sq, sk, d, dtype, dev)
            # the routed entry, and the wmma entry where it is another
            entries = dict.fromkeys((A.kernel_entry(dtype, d), V1_ENTRY))
            for kind in ("softmax", "dot_product"):
                ref = A.attention_reference(q, k, v, kind, d ** -0.5)
                limit = attn_limit(dtype, ref)
                for entry in entries:
                    out = A.fused_attention(q, k, v, kind, d ** -0.5,
                                            entry=entry)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    ok = out.shape == ref.shape and out.dtype == dtype and (
                        err <= limit)
                    tiled = ""
                    if entry != V1_ENTRY:
                        til = A.attention_tiled_reference(
                            q, k, v, kind, d ** -0.5, A.wgmma_block_k(d))
                        err_t = (out.float() - til.float()).abs().max().item()
                        tiled = f" vs tiled plain {err_t:.3e}"
                        ok = ok and err_t <= limit
                    log(f"[2 kernel] {entry} {name} B={b} Sq={sq} Sk={sk} "
                        f"d={d} {str(dtype)[6:]} {kind}: max_abs_err="
                        f"{err:.3e} (limit {limit:g}){tiled} "
                        f"{'ok' if ok else 'FAIL'}")
                    assert ok, "kernel disagrees with the plain version"
                    if dtype == torch.bfloat16:
                        worst[entry] = max(worst[entry], err)
    times = {}
    for name, (sq, sk, d) in (("s3", S3), ("s4", S4)):
        q, k, v = seeded_qkv(rng, 32, sq, sk, d, torch.bfloat16, dev)
        routed = A.kernel_entry(torch.bfloat16, d)
        ref = A.attention_reference(q, k, v, "softmax", d ** -0.5)
        for entry in dict.fromkeys((routed, V1_ENTRY)):
            out = A.fused_attention(q, k, v, "softmax", d ** -0.5, entry=entry)
            err = (out.float() - ref.float()).abs().max().item()
            assert err <= ATOL[torch.bfloat16], f"{entry} {name} B=32: {err}"
            worst[entry] = max(worst[entry], err)
        # the library's fused attention, timed as a yardstick only
        q4, k4, v4 = (t.unsqueeze(1) for t in (q, k, v))
        ms, v1_ms, plain_ms, lib_ms = medians_in_turns([
            lambda: A.fused_attention(q, k, v, "softmax", d ** -0.5),
            lambda: A.fused_attention(q, k, v, "softmax", d ** -0.5,
                                      entry=V1_ENTRY),
            lambda: A.attention_reference(q, k, v, "softmax", d ** -0.5),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, scale=d ** -0.5)], 20)
        # where the routed kernel's time goes: the same products without the
        # softmax (dot_product), and 5 clips, whose blocks fit the card's SMs
        # at once (the time of one block)
        dot_ms, wave_ms = (float(np.median(cuda_ms(fn, 20))) for fn in (
            lambda: A.fused_attention(q, k, v, "dot_product", d ** -0.5),
            lambda: A.fused_attention(q[:5], k[:5], v[:5], "softmax",
                                      d ** -0.5)))
        flops = 4 * 32 * sq * sk * d
        moved = sum(t.numel() * t.element_size() for t in (q, k, v, out))
        bound_ms, bound_by = bound(moved, flops)
        times[name] = {"entry": routed, "ms": ms, "v1_ms": v1_ms,
                       "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "dot_product_ms": dot_ms, "five_clips_ms": wave_ms}
        log(f"[2 kernel] time {name} B=32 bf16 softmax: {routed} {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), {V1_ENTRY} {v1_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, scaled_dot_product_attention "
            f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}; {routed} "
            f"dot_product {dot_ms:.4f} ms, softmax on 5 clips {wave_ms:.4f} ms")
    return worst, times


def smoke_cfg(paths, root, preset):
    from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

    return get_cfg_with_overrides("chip_smoke", **{
        **paths,
        "mdl.sf_mdl_name": preset,
        "train.dtype": "bfloat16",
        "misc.tmp_path": str(root / "tmp"),
    })


def seeded_state_dict(cfg):
    from vidsitu_tpu_torch.convert.from_flax import (
        flax_to_state_dict,
        seeded_variables,
    )
    from vidsitu_tpu_torch.models.vb_models import build_feat_extractor

    return flax_to_state_dict(seeded_variables(build_feat_extractor(cfg), 0))


def phase_main_path(cfg, state_dict, out_dir):
    from vidsitu_tpu_torch.data.comm import build_comm
    from vidsitu_tpu_torch.extract import extract_features
    from vidsitu_tpu_torch.ops import attention as A

    comm = build_comm(cfg)
    timings = []
    A.reset_launches()
    t0 = time.perf_counter()
    counts = extract_features(
        cfg, comm, state_dict=state_dict, splits=["valid"], out_dir=out_dir,
        batch_size=4, num_threads=8, clip_batch=32, device="cuda",
        timings=timings)
    wall = time.perf_counter() - t0
    launches, by_entry = A.LAUNCHES, dict(A.LAUNCHES_BY_ENTRY)
    files = sorted(Path(out_dir).glob("*_feats.npy"))
    arrs = [np.load(f) for f in files]
    log(f"[3 main] counts={counts} files={len(files)} dispatches="
        f"{len(timings)} nl_launches={launches} by entry {by_entry} "
        f"wall={wall:.2f} s")
    assert counts == {"valid": 8} and len(files) == 8, counts
    assert len(timings) == 2, f"expected 2 dispatches, got {len(timings)}"
    assert all(a.shape == (5, 2048) and a.dtype == np.float32
               and np.isfinite(a).all() for a in arrs), "bad feature files"
    assert launches == 5 * 2, f"NL kernel launches {launches} != 5 x 2"
    routed = {A.kernel_entry(torch.bfloat16, d) for d in (256, 512)}
    assert len(routed) == 1 and by_entry[routed.pop()] == launches, (
        f"launches off the routed entry: {by_entry}")
    # excluding the first dispatch: from its fetch to the second's fetch
    # (the second batch was queued before the first fetch, so the interval
    # is shorter than a whole forward)
    dt = timings[1] - timings[0]
    log(f"[3 main] after the first dispatch: {dt * 1e3:.1f} ms to the "
        f"second fetch (32 clips on the device, 8 real) -> {32 / dt:.1f} "
        f"device clips/s, {8 / dt:.1f} real clips/s")
    return launches, by_entry


def phase_paths_agree(cfg, state_dict, dev):
    from vidsitu_tpu_torch.data.comm import build_comm
    from vidsitu_tpu_torch.data.loader import fold_frame_events, stack_collate
    from vidsitu_tpu_torch.extract import FramesOnlyDS
    from vidsitu_tpu_torch.models.vb_models import build_feat_extractor
    from vidsitu_tpu_torch.models.video_backbone import NonLocalBlock
    from vidsitu_tpu_torch.ops import attention as A

    ds = FramesOnlyDS(cfg, build_comm(cfg), "valid")
    batch = fold_frame_events(stack_collate([ds[i] for i in range(7)]))
    frames = torch.from_numpy(batch["frms_ev_fast_tensor"][:32]).to(dev)
    model = build_feat_extractor(cfg)
    model.load_state_dict(state_dict, strict=True)
    model.to(device=dev, memory_format=torch.channels_last_3d)
    nl = [m for m in model.modules() if isinstance(m, NonLocalBlock)]
    assert len(nl) == 5, len(nl)

    def run(attn):
        for m in nl:
            m.attention = attn
        with torch.inference_mode():
            return model.clip_features({"frms_ev_fast_tensor": frames})

    feats_k = run(A.fused_attention).float()
    feats_p = run(A.attention_reference).float()
    torch.cuda.synchronize()
    scale = feats_p.abs().max().item()
    diff = (feats_k - feats_p).abs().max().item()
    ok = bool(torch.isfinite(feats_k).all()) and diff <= FEATURE_RTOL * scale
    log(f"[4 paths] kernel vs plain features (32, 2048): max_abs_diff="
        f"{diff:.4e}, feature scale {scale:.4e}, ratio {diff / scale:.3e} "
        f"(limit {FEATURE_RTOL:g}) {'ok' if ok else 'FAIL'}")
    assert ok, "kernel path and plain path disagree"
    v1 = functools.partial(A.fused_attention, entry=V1_ENTRY)
    ms_k, ms_v1, ms_p = medians_in_turns(
        [lambda: run(A.fused_attention), lambda: run(v1),
         lambda: run(A.attention_reference)], 5)
    log(f"[4 paths] i3d_r50_nl_8x8 forward, 32 clips bf16: routed kernel "
        f"{ms_k:.2f} ms = {32e3 / ms_k:.1f} clips/s, {V1_ENTRY} forced "
        f"{ms_v1:.2f} ms = {32e3 / ms_v1:.1f} clips/s, plain attention "
        f"{ms_p:.2f} ms = {32e3 / ms_p:.1f} clips/s")
    return {"routed_ms": ms_k, "v1_ms": ms_v1, "plain_ms": ms_p}


def phase_default_cfg(paths, root, dev):
    from vidsitu_tpu_torch.models.vb_models import build_feat_extractor

    cfg = smoke_cfg(paths, root, "slow_fast_nl_r50_8x8")
    model = build_feat_extractor(cfg)
    model.load_state_dict(seeded_state_dict(cfg), strict=True)
    model.to(device=dev, memory_format=torch.channels_last_3d)
    rng = np.random.default_rng(1)
    t = cfg.vid_mdl.num_frames
    inp = {
        "frms_ev_fast_tensor": rng.integers(0, 256, (8, t, 224, 224, 3),
                                            dtype=np.uint8),
        "frms_ev_slow_tensor": rng.integers(
            0, 256, (8, t // cfg.vid_mdl.slowfast.alpha, 224, 224, 3),
            dtype=np.uint8),
    }
    with torch.inference_mode():
        out = model.clip_features(
            {k: torch.from_numpy(v).to(dev) for k, v in inp.items()})
    torch.cuda.synchronize()
    ok = tuple(out.shape) == (8, 2304) and bool(torch.isfinite(out).all())
    log(f"[5 default] slow_fast_nl_r50_8x8 8 clips -> {tuple(out.shape)} "
        f"{out.dtype} finite={bool(torch.isfinite(out).all())} "
        f"{'ok' if ok else 'FAIL'}")
    assert ok
    return model, {k: torch.from_numpy(v).to(dev) for k, v in inp.items()}


def beam_rows(gen, dev):
    """Source rows of one beam-5 reorder: each event's 5 new beams drawn
    from its own 5 old ones (repeated parents included)."""
    beam_idx = torch.randint(0, BEAM, (EVENTS, BEAM), generator=gen,
                             device=dev)
    return (torch.arange(EVENTS, device=dev)[:, None] * BEAM
            + beam_idx).reshape(-1)


def cache_leaves(gen, length, dtype, dev, heads=HEADS):
    """The reorder-mode cache's 12 float leaves, in cache order: per layer
    self K/V (rows, H, L, Dh) and cross K/V (rows, H, 1, Dh); ``heads``
    (H) is a rank's under tensor parallelism."""
    rows = EVENTS * BEAM
    shapes = [(rows, heads, n, HEAD_DIM) for n in (length, length, 1, 1)]
    return [torch.randn(sh, generator=gen, device=dev).to(dtype)
            for _ in range(LAYERS) for sh in shapes]


def phase_gather_kernel(dev):
    from vidsitu_tpu_torch.ops import beam_gather as B

    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for length in SELF_LENS:
            leaves = cache_leaves(gen, length, dtype, dev)
            idx = beam_rows(gen, dev)
            out = B.beam_gather_rows(leaves, idx)
            ref = B.beam_gather_rows_reference(leaves, idx)
            torch.cuda.synchronize()
            ok = all(torch.equal(o, r) for o, r in zip(out, ref))
            err = max((o.float() - r.float()).abs().max().item()
                      for o, r in zip(out, ref))
            log(f"[7 gather] 12 leaves, 400 rows, L={length} "
                f"{str(dtype)[6:]}: bit-identical={ok} max_abs_err={err:g} "
                f"{'ok' if ok else 'FAIL'}")
            assert ok, "row-gather kernel disagrees with index_select"
            worst = max(worst, err)
            del leaves, out, ref
    times = {}
    for length in SELF_LENS:
        leaves = cache_leaves(gen, length, torch.bfloat16, dev)
        idx = beam_rows(gen, dev)

        def queued(fn, calls):
            def run():
                for _ in range(calls):
                    fn(leaves, idx)
            return run

        moved = 2 * sum(x.numel() * x.element_size() for x in leaves)
        for calls in (QUEUED, 1):
            ms, plain_ms = medians_in_turns(
                [queued(B.beam_gather_rows, calls),
                 queued(B.beam_gather_rows_reference, calls)], 10)
            ms, plain_ms = ms / calls, plain_ms / calls
            times[(length, calls)] = (ms, plain_ms)
            what = ("device time, calls queued" if calls > 1
                    else "one call per event pair, host time included")
            times[(length, calls)] += bound(moved, 0)
            log(f"[7 gather] time 12 leaves L={length} bf16 ({moved / 2e9:.3f}"
                f" GB each way), {what}: kernel {ms:.4f} ms "
                f"({moved / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms "
                f"({moved / plain_ms / 1e6:.1f} GB/s)")
        del leaves
    return worst, times[(SELF_LENS[-1], QUEUED)]


def srl_args(paths, root, feats_dir, *extra):
    return ["chip_smoke_srl", "--task_type=vb_arg",
            "--mdl.mdl_name=sfpret_txe_txd_vbarg", "--train.dtype=bfloat16",
            f"--misc.tmp_path={root / 'tmp'}",
            *[f"--{k}={v}" for k, v in paths.items()],
            f"--ds.vsitu.vsit_frm_feats_dir={feats_dir}",
            "--device=cuda", "--allow_random_weights=True", *extra]


def device_batch(cfg, dev):
    """The valid split's first eval batch, padded like the evaluator's."""
    from vidsitu_tpu_torch.data import get_data
    from vidsitu_tpu_torch.evaluation.evaluators import pad_batch_to

    batch = pad_batch_to(next(iter(get_data(cfg).valid_dl)),
                         int(cfg.train.bsv))
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def phase_srl_main(paths, root, feats_dir):
    from vidsitu_tpu_torch import main as port_main
    from vidsitu_tpu_torch.ops import beam_gather as B

    B.LAUNCHES = 0
    t0 = time.perf_counter()
    res = port_main.main(srl_args(paths, root, feats_dir, "--only_val=True",
                                  "--gen.beam_size=5",
                                  "--tpu.ancestry_beam=False"))
    wall = time.perf_counter() - t0
    launches = B.LAUNCHES
    ev, cfg = res["evaluator"], res["cfg"]
    steps = ev.generate_fn.steps
    _, acc = res["results"]["valid"]
    with open(res["pred_dir"] / "valid_0.pkl", "rb") as f:
        preds = pickle.load(f)
    log(f"[8 srl] entries={len(preds)} batches={len(ev.batch_seconds)} "
        f"steps={steps} gather_launches={launches} metrics={acc} "
        f"wall={wall:.2f} s")
    assert len(preds) == 8 and sorted(p["ann_idx"] for p in preds) == list(
        range(8)), "one pkl entry per real segment"
    assert all(set(p["vb_output"]) == {f"Ev{i}" for i in range(1, 6)}
               for p in preds), "5 events per entry"
    assert set(acc) == set(ev.met_keys) and all(
        np.isfinite(v) for v in acc.values()), acc
    assert launches == sum(steps) > 0, (
        f"row-gather launches {launches} != decode steps {sum(steps)}")
    # the forced verb: every event's text starts with its verb id
    batch = device_batch(cfg, "cpu")
    wvoc = ev.comm.gpt2_hf_tok
    verbs = batch["seq_out_by_ev"][:, :, 0, 0].numpy()
    by_idx = {int(i): row for i, row in zip(batch["vseg_idx"], verbs)}
    for p in preds:
        for ev_ix in range(5):
            want = wvoc.decode([int(by_idx[p["ann_idx"]][ev_ix])])
            got = p["vb_output"][f"Ev{ev_ix + 1}"].get("vb_id", "")
            assert got.startswith(want), (p["ann_idx"], ev_ix, got, want)
    sec = ev.batch_seconds[0]
    log(f"[8 srl] batch of 16 segments (80 events, 400 beam rows), first "
        f"call: {sec:.3f} s, {sec * 1e3 / steps[0]:.3f} ms/step over "
        f"{steps[0]} steps, {80 / sec:.1f} events/s")
    return launches, ev.generate_fn, cfg, preds


def phase_srl_profile(gen, batch):
    """One more decode of the main path's batch under torch.profiler: device
    time by kernel, and the busy share against the same decode unprofiled
    (the profiler slows the host several times over)."""
    from torch.profiler import ProfilerActivity, profile

    _, wall = timed_search(gen, batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, prof_wall = timed_search(gen, batch)
    rows = kernel_rows(prof)
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
    per_step = sum(e.count for e in rows) / out.steps
    log(f"[8 profile] reorder route, {out.steps} steps: device kernels "
        f"{dev_ms:.1f} ms = {dev_ms / out.steps:.3f} ms/step, {per_step:.1f} "
        f"kernels/step; unprofiled "
        f"wall {wall * 1e3:.1f} ms (device busy {100 * dev_ms / wall / 1e3:.1f}"
        f" %); profiled wall {prof_wall * 1e3:.1f} ms")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms "
            f"{100 * e.self_device_time_total / 1e3 / dev_ms:5.1f} % "
            f"{e.count:6d}x  {e.key[:80]}")


def timed_search(gen, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = gen.search(batch)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def generator_for(model, cfg, comm, beam_size=BEAM, ancestry=False):
    """The entry point's generator over ``model``, for cfg with the beam
    size and ``tpu.ancestry_beam`` given."""
    from vidsitu_tpu_torch.models.selector import build_srl_generate_fn

    cfg = cfg.clone().defrost()
    cfg.gen.beam_size = beam_size
    cfg.tpu.ancestry_beam = ancestry
    return build_srl_generate_fn(cfg, comm, model)


def phase_routes(gen, cfg, dev):
    from vidsitu_tpu_torch.data import build_comm
    from vidsitu_tpu_torch.gates import plain_gather
    from vidsitu_tpu_torch.models.selector import build_model

    comm = build_comm(cfg)
    batch = device_batch(cfg, dev)
    model = gen.model
    reorder = generator_for(model, cfg, comm)
    runs = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel") * 2:  # in turns
        if name == "plain":
            with plain_gather():
                runs[name].append(timed_search(reorder, batch))
        else:
            runs[name].append(timed_search(reorder, batch))
    out_k, out_p = runs["kernel"][0][0], runs["plain"][0][0]
    t_k = float(np.median([t for _, t in runs["kernel"]]))
    t_p = float(np.median([t for _, t in runs["plain"]]))
    same = all(torch.equal(o.seqs, out_k.seqs)
               and torch.equal(o.scores, out_k.scores)
               for o, _ in runs["kernel"] + runs["plain"])
    spread = {n: " ".join(f"{t:.3f}" for _, t in r) for n, r in runs.items()}
    log(f"[9 routes] reorder route, kernel vs plain gather: identical tokens "
        f"and scores={same}; {t_k:.3f} s vs {t_p:.3f} s per batch (median "
        f"of 4 each, in turns; {out_k.steps} steps: "
        f"{t_k * 1e3 / out_k.steps:.3f} vs {t_p * 1e3 / out_p.steps:.3f} "
        f"ms/step; runs: kernel {spread['kernel']}, plain {spread['plain']})")
    assert same, "kernel and plain gather routes disagree"
    verbs = batch["seq_out_by_ev"][:, :, 0, 0].reshape(-1)
    assert torch.equal(out_k.seqs[:, 0, 0], verbs), "verb not forced"
    out_a, t_a = timed_search(generator_for(model, cfg, comm, ancestry=True),
                              batch)
    out_g, t_g = timed_search(generator_for(model, cfg, comm, beam_size=1),
                              batch)
    assert torch.equal(out_g.seqs[:, 0, 0], verbs), "greedy: verb not forced"
    log(f"[9 routes] bf16 per batch: ancestry {t_a:.3f} s "
        f"({t_a * 1e3 / out_a.steps:.3f} ms/step, {80 / t_a:.1f} events/s), "
        f"reorder+kernel {t_k:.3f} s ({80 / t_k:.1f} events/s), greedy "
        f"{t_g:.3f} s ({t_g * 1e3 / out_g.steps:.3f} ms/step, "
        f"{80 / t_g:.1f} events/s)")
    # ancestry vs reorder in float32, same weights
    f32_cfg = cfg.clone().defrost()
    f32_cfg.train.dtype = "float32"
    m32 = build_model(f32_cfg, comm)
    m32.load_state_dict(model.state_dict(), strict=True)
    m32.to(dev).eval()
    out_r32, t_r32 = timed_search(generator_for(m32, f32_cfg, comm), batch)
    out_a32, t_a32 = timed_search(
        generator_for(m32, f32_cfg, comm, ancestry=True), batch)
    equal = (out_r32.seqs[:, 0] == out_a32.seqs[:, 0]).all(-1)
    share = equal.float().mean().item()
    log(f"[9 routes] float32 ancestry vs reorder: top-beam tokens equal on "
        f"{int(equal.sum())}/{equal.numel()} events ({100 * share:.2f} %, "
        f"limit {100 * ROUTE_AGREEMENT:g} %); {t_a32:.3f} s vs {t_r32:.3f} s")
    assert share >= ROUTE_AGREEMENT, "ancestry and reorder routes disagree"


def phase_real_vocab(cfg, dev):
    """Phase 10: the generator alone at the real vocabulary size."""
    from vidsitu_tpu_torch.convert.from_flax import (
        flax_to_state_dict,
        seeded_variables,
    )
    from vidsitu_tpu_torch.gen.beam import GenConfig
    from vidsitu_tpu_torch.gen.generate import make_srl_generator
    from vidsitu_tpu_torch.models.srl_models import SRLModel
    from vidsitu_tpu_torch.models.transformer import TxConfig
    from vidsitu_tpu_torch.ops import beam_gather as B

    t0 = time.perf_counter()
    dec = TxConfig.from_cfg(cfg.tx_dec, REAL_VOCAB, REAL_VOCAB - 1,
                            dtype=torch.bfloat16)
    enc = TxConfig.from_cfg(cfg.tx_dec, REAL_VOCAB, REAL_VOCAB - 1,
                            side="encoder", dtype=torch.bfloat16)
    model = SRLModel("sfpret_txe_txd_vbarg", dec, enc, "old", 2048)
    model.load_state_dict(flax_to_state_dict(seeded_variables(model, 7)),
                          strict=True)
    model.to(dev).eval()
    rng = np.random.default_rng(10)
    seq = np.full((16, 5, 3, 60), REAL_VOCAB - 1, np.int64)
    seq[:, :, :, 0] = rng.integers(256, 50256, (16, 5, 1))  # forced
    batch = {
        "seq_out_by_ev": torch.from_numpy(seq).to(dev),
        "frm_feats": torch.from_numpy(
            rng.standard_normal((16, 5, 2048)).astype(np.float32)).to(dev),
    }
    log(f"[10 vocab] model with V={REAL_VOCAB} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    times = {}
    outs = {}
    for name, ancestry in (("reorder+kernel", False), ("ancestry", True)):
        gen = make_srl_generator(
            model, GenConfig(beam_size=BEAM, max_len_b=int(cfg.gen.max_len_b)),
            vocab_size=REAL_VOCAB, pad_id=REAL_VOCAB - 1, bos_id=50256,
            eos_id=50256, ancestry=ancestry, seg_min=64)
        B.LAUNCHES = 0
        out, sec = timed_search(gen, batch)
        launches = B.LAUNCHES
        assert launches == (0 if ancestry else out.steps), launches
        assert out.seqs.shape == (80, BEAM, gen.max_len + 1) and bool(
            torch.isfinite(out.scores).all())
        assert torch.equal(out.seqs[:, 0, 0],
                           batch["seq_out_by_ev"][:, :, 0, 0].reshape(-1))
        times[name], outs[name] = sec, out
        log(f"[10 vocab] {name}: {sec:.3f} s per batch, {out.steps} steps, "
            f"{sec * 1e3 / out.steps:.3f} ms/step, {80 / sec:.1f} events/s, "
            f"gather launches {launches}")
    same = (outs["reorder+kernel"].seqs[:, 0] == outs["ancestry"].seqs[:, 0]
            ).all(-1).float().mean().item()
    log(f"[10 vocab] bf16 routes: top-beam tokens equal on "
        f"{100 * same:.2f} % of events (bf16 rounding differs by route)")


def fb_operands(rng, cin, cmid, cout, proj, dtype, dev):
    """Seeded folded weights (std fan_in**-0.5) and non-zero float32 shifts
    in the fused bottleneck's layouts."""
    def weight(*shape):
        fan_in = int(np.prod(shape[:-1]))
        return torch.from_numpy((rng.standard_normal(shape) * fan_in ** -0.5)
                                .astype(np.float32)).to(dev, dtype)

    def shift(n):
        return torch.from_numpy((0.1 * rng.standard_normal((1, n)))
                                .astype(np.float32)).to(dev)

    ops = [weight(cin, cmid), shift(cmid), weight(3, 3, cmid, cmid),
           shift(cmid), weight(cmid, cout), shift(cout)]
    return ops + ([weight(cin, cout), shift(cout)] if proj else [None, None])


def folded_chain(x, wa, ba, wb, bb, wc, bc):
    """The library yardstick on the folded weights: three ``F.conv2d`` calls
    (cuDNN, bf16, channels-last) with shift, relu and the identity residual
    as elementwise calls. ``x`` (B, H, W, C) frames; timed only, the port
    never calls it."""
    from torch.nn.functional import conv2d

    def oihw(w_hwio):
        return w_hwio.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

    wa4, wb4, wc4 = oihw(wa[None, None]), oihw(wb), oihw(wc[None, None])
    sa, sb, sc = (t.to(x.dtype).reshape(1, -1, 1, 1) for t in (ba, bb, bc))
    xn = x.permute(0, 3, 1, 2)  # NCHW view of channels-last memory

    def run():
        h = conv2d(xn, wa4).add_(sa).relu_()
        h = conv2d(h, wb4, padding=1).add_(sb).relu_()
        return conv2d(h, wc4).add_(sc).add_(xn).relu_()

    return run


def phase_fused_kernel(dev):
    """Phase 12: every entry point, routed and forced, against the plain
    version (the wgmma entries also against the plain version that repeats
    their walk), then timed."""
    from vidsitu_tpu_torch import gates
    from vidsitu_tpu_torch.ops import fused_bottleneck as FB

    rng = np.random.default_rng(12)
    worst = {name: 0.0 for name in FB.LAUNCHES_BY_ENTRY}  # bf16, by C entry
    frames_v1, multi_v1 = (FB.ENTRIES[name][1] for name in (
        "fused_bottleneck_frames", "fused_bottleneck_multi"))
    for name, (h, w, cin, cmid, cout, proj) in FB_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            ops = fb_operands(rng, cin, cmid, cout, proj, dtype, dev)
            x = torch.from_numpy(rng.standard_normal((8, h, w, cin)).astype(
                np.float32)).to(dev, dtype)
            want = FB.fused_bottleneck_plain(x, *ops).float()
            scale = want.abs().max().item()
            limit = FB_TOL[dtype] * (scale if dtype == torch.bfloat16 else 1.0)
            # (C entry, frames per step) -> run; the routed entry first, then
            # the first kernel's where the routed one is another
            runs = {}
            for entry in dict.fromkeys((FB.kernel_entry(
                    dtype, cin, cmid, cout, proj, w), frames_v1)):
                runs[entry, 1] = lambda entry=entry: (
                    FB.fused_bottleneck_frames(x, *ops, entry=entry))
            if not proj:
                for entry in dict.fromkeys((FB.kernel_entry(
                        dtype, cin, cmid, cout, proj, w, multi=True),
                        multi_v1)):
                    for fps in (2, 4):
                        runs[entry, fps] = lambda entry=entry, fps=fps: (
                            FB.fused_bottleneck_multi(
                                x, *ops[:6], frames_per_step=fps, entry=entry))
            for (entry, fps), fn in runs.items():
                got = fn()
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                ok = got.shape == want.shape and got.dtype == dtype and (
                    err <= limit)
                more = ""
                if entry.endswith("_wgmma"):
                    tiled = FB.fused_bottleneck_tiled_reference(
                        x, *ops, frames_per_step=fps).float()
                    err_t = (got.float() - tiled).abs().max().item()
                    more = f" vs tiled plain {err_t:.3e}"
                    ok = ok and err_t <= limit
                elif entry == multi_v1:
                    more = f" staged(wa,wb,wc)={FB.LAST_STAGED}"
                log(f"[12 fused] {name} 8x{h}x{w} {cin}->{cmid}->{cout} "
                    f"{str(dtype)[6:]} {entry} fps={fps}: max_abs_err="
                    f"{err:.3e} (limit {limit:.3e}, scale {scale:.3f}){more} "
                    f"{'ok' if ok else 'FAIL'}")
                assert ok, "fused bottleneck disagrees with the plain version"
                if dtype == torch.bfloat16:
                    worst[entry] = max(worst[entry], err)
    # the wgmma kernel's walk with more steps than blocks: every block's run
    # crosses from one group of frames into the next (an odd number of steps
    # a group at 2 and 3 frames) and most runs start inside a group
    h, w, cin, cmid, cout, _ = FB_SHAPES["slow-s2"]
    ops = fb_operands(rng, cin, cmid, cout, False, torch.bfloat16, dev)
    x = torch.from_numpy(rng.standard_normal((67, h, w, cin)).astype(
        np.float32)).to(dev, torch.bfloat16)
    want = FB.fused_bottleneck_plain(x, *ops).float()
    limit = FB_TOL[torch.bfloat16] * want.abs().max().item()
    entry = FB.ENTRIES["fused_bottleneck_multi"][0]
    for fps in (1, 2, 3, 7):
        errs = []
        for _ in range(3):  # a race would show in some launches only
            got = FB.fused_bottleneck_multi(x, *ops[:6], frames_per_step=fps)
            assert FB.LAUNCHES_BY_ENTRY[entry] > 0
            torch.cuda.synchronize()
            errs.append((got.float() - want).abs().max().item())
        ok = max(errs) <= limit
        log(f"[12 fused] slow-s2 67 frames bf16 {entry} fps={fps} x3: "
            f"max_abs_err={max(errs):.3e} (limit {limit:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        assert ok, "the wgmma kernel's walk disagrees with the plain version"
        worst[entry] = max(worst[entry], *errs)
    del x, want
    # the two block shapes that stay on the first kernel, timed at 256 frames
    others = {}
    for name in ("slow-s2 proj", "slow-s3"):
        h, w, cin, cmid, cout, proj = FB_SHAPES[name]
        ops = fb_operands(rng, cin, cmid, cout, proj, torch.bfloat16, dev)
        x = torch.randn((256, h, w, cin), device=dev).to(torch.bfloat16)
        ms = float(np.median(cuda_ms(
            lambda: FB.fused_bottleneck_frames(x, *ops), 5)))
        flops = 2 * 256 * h * w * (cin * cmid + 9 * cmid * cmid + cmid * cout
                                   + (cin * cout if proj else 0))
        bound_ms, bound_by = bound(2 * 256 * h * w * (cin + cout), flops)
        entry = FB.kernel_entry(torch.bfloat16, cin, cmid, cout, proj, w)
        log(f"[12 fused] {name} 256 frames bf16 on {entry}: {ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms by {bound_by}")
        others[name] = {"entry": entry, "ms": ms, "bound_ms": bound_ms}
        del x
    timed = gates.gate_fused_bottleneck(dev)
    timed["others"] = others
    # beside the gate's unfused chain (the model's block, BatchNorm unfolded):
    # the library on the folded weights, the routed kernel with calls queued
    # back to back (device time without the wrapper's host time), and the
    # plain version at 256 frames (float32 convs on the bf16 operands: it
    # repeats the kernel's arithmetic, it is no yardstick)
    block = gates.s2_block(dev)
    folded = FB.fold_bottleneck(block, torch.bfloat16)
    for n_frames in gates.FRAME_COUNTS:
        x = torch.randn((n_frames, 56, 56, 256), device=dev).to(torch.bfloat16)
        chain = folded_chain(x, *folded[:6])
        want = FB.fused_bottleneck_plain(x[:8], *folded).float()
        err = (chain()[:8].permute(0, 2, 3, 1).float() - want).abs().max()
        assert err.item() <= FB_TOL[torch.bfloat16] * want.abs().max().item()

        def queued(fn):
            return lambda: [fn() for _ in range(QUEUED)]

        ms, chain_ms, q_frames, q_multi4, q_chain = medians_in_turns([
            lambda: FB.fused_bottleneck_frames(x, *folded), chain,
            queued(lambda: FB.fused_bottleneck_frames(x, *folded)),
            queued(lambda: FB.fused_bottleneck_multi(
                x, *folded[:6], frames_per_step=4)),
            queued(chain)], 5)
        timed[str(n_frames)].update(
            folded_library_ms=chain_ms, frames_queued_ms=q_frames / QUEUED,
            multi4_queued_ms=q_multi4 / QUEUED,
            folded_library_queued_ms=q_chain / QUEUED)
        log(f"[12 fused] slow-s2 {n_frames} frames bf16: routed frames entry "
            f"{ms:.3f} ms a call, {q_frames / QUEUED:.3f} ms queued x{QUEUED}"
            f" | multi fps=4 queued {q_multi4 / QUEUED:.3f} | three conv2d on "
            f"the folded weights + elementwise {chain_ms:.3f} ms a call, "
            f"{q_chain / QUEUED:.3f} queued")
        if n_frames == 256:
            plain_ms = float(np.median(cuda_ms(
                lambda: FB.fused_bottleneck_plain(x, *folded), 3)))
            log(f"[12 fused] plain version, slow-s2 256 frames bf16: "
                f"{plain_ms:.3f} ms")
        del x, chain
    return worst, timed, plain_ms


def phase_fused_in_model(model, inp, dev):
    """Phase 13: the fused block on the six eligible slow-pathway blocks'
    real inputs, captured in one SlowFast forward, against the blocks' own
    outputs; which C entry each block took."""
    from vidsitu_tpu_torch.ops import fused_bottleneck as FB

    blocks = dict(model.backbone.named_modules())
    captured = {}
    hooks = [blocks[name].register_forward_hook(
        lambda mod, args, out, name=name: captured.__setitem__(
            name, (args[0], out))) for name in FUSED_BLOCKS]
    with torch.inference_mode():
        feats = model.clip_features(inp)
    for h in hooks:
        h.remove()
    assert bool(torch.isfinite(feats).all()) and set(captured) == set(
        FUSED_BLOCKS)
    before = FB.LAUNCHES["fused_bottleneck_frames"]
    worst = 0.0
    for name in FUSED_BLOCKS:
        x, want = captured[name]
        want = want.permute(0, 2, 3, 4, 1).float()
        by_entry = dict(FB.LAUNCHES_BY_ENTRY)
        got = FB.run_fused_block(blocks[name], x.permute(0, 2, 3, 4, 1),
                                 dtype=torch.bfloat16).float()
        torch.cuda.synchronize()
        took = [e for e, n in FB.LAUNCHES_BY_ENTRY.items() if n != by_entry[e]]
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        ok = got.shape == want.shape and err <= FEATURE_RTOL * scale
        log(f"[13 model] {name} {tuple(x.shape)} -> {tuple(want.shape)} on "
            f"{took}: fused vs the block's output max_abs_diff={err:.4e}, "
            f"scale {scale:.4e}, ratio {err / scale:.3e} (limit "
            f"{FEATURE_RTOL:g}) {'ok' if ok else 'FAIL'}")
        assert ok, f"fused block disagrees with {name}"
        assert took == [FUSED_BLOCK_ENTRY[name]], (name, took)
        worst = max(worst, err / scale)
    launches = FB.LAUNCHES["fused_bottleneck_frames"] - before
    assert launches == len(FUSED_BLOCKS), launches
    log(f"[13 model] {launches} fused-bottleneck launches for "
        f"{len(FUSED_BLOCKS)} blocks")
    return worst


def phase_copy_probes(dev):
    """Phase 14: every copy probe bit-identical at every block shape (the
    gate asserts it), rates beside clone() and one elementwise op."""
    from vidsitu_tpu_torch import gates

    res = gates.gate_copy_floor(dev)
    assert sorted(map(tuple, res["refused_blocks"])) == sorted(
        gates.REFUSED_BLOCKS), "a VMEM-sized block was not refused"
    log(f"[14 copy] bit-identical at blocks {list(res['staged_gbps'])}, "
        f"pipelined and direct; refused {res['refused_blocks']}")
    return res


def phase_bench(dev):
    """Phase 15: the measuring entry point in process."""
    from vidsitu_tpu_torch import bench

    name = torch.cuda.get_device_name(dev)
    (gates_res,) = bench.main(["gates"])
    assert gates_res["device"] == name
    assert gates_res["beam_gather"]["pass"], gates_res["beam_gather"]
    assert isinstance(gates_res["copy_floor"]["flip"], bool)
    assert all(isinstance(v["flip"], bool)
               for v in gates_res["fused_bottleneck"].values())
    (featext,) = bench.main(["featext", "32"])
    (decode,) = bench.main(["decode5_real"])
    for res, metric in ((featext, "slowfast_r50_8x8_featext"),
                        (decode, "srl_beam5_decode_latency_d1024")):
        assert res["metric"] == metric and res["device"] == name, res
        assert np.isfinite(res["value"]) and res["value"] > 0, res
        assert name in res["roofline_of"] and res["roofline_frac"] > 0, res
    log(f"[15 bench] gates, featext 32 ({featext['value']} clips/s, "
        f"{featext['tflops']} TFLOP/s) and decode5_real "
        f"({decode['value']} ms/video over {decode['steps']} steps) ok")
    return gates_res, featext, decode


def grad_limit(dtype, ref):
    """The backward check's tolerance for one gradient, relative to its
    scale (the largest |value|): 2e-4 in float32; in bf16 5e-2, or one bf16
    step of the largest gradient where that is more."""
    top = ref.float().abs().max().item()
    if dtype != torch.bfloat16:
        return BWD_TOL[dtype] * top
    return max(BWD_TOL[dtype] * top, 2.0 ** (math.floor(math.log2(top)) - 7))


def backward_ms(out, inputs, dout):
    """A function that runs the backward of ``out`` alone (the forward stays
    outside the timed window)."""
    return lambda: torch.autograd.grad(out, inputs, dout, retain_graph=True)


def phase_backward_kernel(dev):
    """Phase 16: each backward entry that takes the input (the routed one,
    and the first kernel's forced in bf16) against the plain backward and
    the plain version that repeats its own tiles, the wgmma entry twice
    (bitwise equal), the forward's log-sum-exp against the plain one, at
    every listed shape, both kinds and dtypes; then both entries, autograd
    of the plain attention and the library's fused attention's backward
    timed in turns at B = 80."""
    from torch.profiler import ProfilerActivity, profile

    from vidsitu_tpu_torch.attn_probe import ptxas_lines
    from vidsitu_tpu_torch.ops import attention as A

    log("[16 build] the backward entries are built with the forward entries "
        "from nonlocal_attn.cu in phase 1 (one source); ptxas of their "
        "kernels:")
    for kernel, line in ptxas_lines():
        log(f"    {kernel}: {line}")
    rng = np.random.default_rng(16)
    # bf16, by entry: absolute, and relative to each gradient's scale
    worst = {name: 0.0 for name in A.BWD_ENTRIES}
    worst_rel = dict(worst)
    for name, b, (sq, sk, d) in ATTN_CHECKS:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = seeded_qkv(rng, b, sq, sk, d, dtype, dev)
            do = seeded_qkv(rng, b, sq, sq, d, dtype, dev)[0]
            routed = A.bwd_kernel_entry(dtype, d)
            for kind in ("softmax", "dot_product"):
                scale = d ** -0.5
                out, lse = A.fused_attention(q, k, v, kind, scale,
                                             with_lse=True)
                want_lse = None
                if kind == "softmax":
                    _, want_lse = A.attention_tiled_reference(
                        q, k, v, kind, scale, A.wgmma_block_k(d),
                        return_lse=True)
                ref = A.attention_backward_reference(q, k, v, out, do, kind,
                                                     scale)
                lse_err = 0.0
                if want_lse is not None:
                    lse_err = (lse - want_lse).abs().max().item()
                for entry in dict.fromkeys((routed, A.BWD_ENTRY)):
                    got = A.fused_attention_backward(
                        q, k, v, out, do, lse, kind, scale,
                        entry=None if entry == routed else entry)
                    again = (A.fused_attention_backward(
                        q, k, v, out, do, lse, kind, scale)
                        if entry == A.WGMMA_BWD_ENTRY else got)
                    til = A.attention_backward_tiled_reference(
                        q, k, v, out, do, lse, kind, scale, entry=entry)
                    torch.cuda.synchronize()
                    same = all(torch.equal(x, y) for x, y in zip(got, again))
                    ok = same and lse_err <= 1e-3
                    errs = []
                    for g, r, t in zip(got, ref, til):
                        lim = grad_limit(dtype, r)
                        e = (g.float() - r.float()).abs().max().item()
                        et = (g.float() - t.float()).abs().max().item()
                        ok = ok and g.shape == r.shape and g.dtype == dtype \
                            and e <= lim and et <= lim
                        top = r.float().abs().max().item()
                        errs.append(f"{e / top:.2e}/{et / top:.2e}")
                        if dtype == torch.bfloat16:
                            worst[entry] = max(worst[entry], e)
                            worst_rel[entry] = max(worst_rel[entry], e / top)
                    forced = "" if entry == routed else " (forced)"
                    repeat = "; two calls bitwise equal" if again is not got \
                        else ""
                    log(f"[16 backward] {entry}{forced} {name} B={b} Sq={sq} "
                        f"Sk={sk} d={d} {str(dtype)[6:]} {kind}: dq/dk/dv "
                        f"error / scale vs plain/tiled {' '.join(errs)}; lse "
                        f"{lse_err:.2e}{repeat} {'ok' if ok else 'FAIL'}")
                    assert ok, f"{entry} disagrees with the plain version"
    times = {}
    for name, (sq, sk, d) in (("s3", S3), ("s4", S4)):
        b = 80
        scale = d ** -0.5
        q, k, v = seeded_qkv(rng, b, sq, sk, d, torch.bfloat16, dev)
        out, lse = A.fused_attention(q, k, v, "softmax", scale, with_lse=True)
        do = torch.randn_like(out)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        plain_out = A.attention_reference(*leaves, "softmax", scale)
        l4 = [t.detach().unsqueeze(1).requires_grad_() for t in (q, k, v)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            *l4, scale=scale)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(lib_out, l4, do.unsqueeze(1),
                                retain_graph=True)
            torch.cuda.synchronize()
        lib_kernels = sorted((e for e in prof.key_averages()
                              if e.self_device_time_total > 0),
                             key=lambda e: -e.self_device_time_total)
        backend = lib_kernels[0].key[:90] if lib_kernels else "not measured"
        routed = A.bwd_kernel_entry(torch.bfloat16, d)
        ms, v1_ms, plain_ms, lib_ms = medians_in_turns([
            lambda: A.fused_attention_backward(q, k, v, out, do, lse,
                                               "softmax", scale),
            lambda: A.fused_attention_backward(q, k, v, out, do, lse,
                                               "softmax", scale,
                                               entry=A.BWD_ENTRY),
            backward_ms(plain_out, leaves, do),
            backward_ms(lib_out, l4, do.unsqueeze(1))], 5)
        flops = 5 * 2 * b * sq * sk * d
        moved = (sum(t.numel() * t.element_size() for t in (q, k, v, out, do))
                 * 2 - out.numel() * out.element_size()
                 - do.numel() * do.element_size() + lse.numel() * 4)
        bound_ms, bound_by = bound(moved, flops)
        times[name] = {"entry": routed, "ms": ms, "v1_ms": v1_ms,
                       "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_backend": backend}
        log(f"[16 backward] time {name} B={b} Sq={sq} Sk={sk} d={d} bf16 "
            f"softmax: {routed} {ms:.4f} ms ({flops / ms / 1e9:.1f} "
            f"TFLOP/s, {100 * bound_ms / ms:.1f} % of the bound), "
            f"{A.BWD_ENTRY} {v1_ms:.4f} ms ({v1_ms / ms:.2f}x), autograd of "
            f"the plain attention {plain_ms:.4f} ms, scaled_dot_product_"
            f"attention backward {lib_ms:.4f} ms (its top kernel: {backend}), "
            f"bound {bound_ms:.4f} ms by {bound_by}")
        del leaves, plain_out, l4, lib_out
        torch.cuda.empty_cache()
    return worst, worst_rel, times


def vb_train_args(paths, root, *extra):
    return ["chip_smoke_vb", "--task_type=vb", "--mdl.mdl_name=sf_base",
            "--mdl.sf_mdl_name=i3d_r50_nl_8x8", "--train.dtype=bfloat16",
            f"--train.bs={VB_BS}", f"--train.bsv={VB_BS}", "--train.nw=4",
            "--train.nwv=4", "--train.epochs=2", "--train.lr=1e-4",
            "--train.save_mdl_epochs=True",
            f"--misc.tmp_path={root / 'tmp'}",
            *[f"--{k}={v}" for k, v in paths.items()], "--device=cuda",
            *extra]


def phase_vb_train_main(paths, root):
    """Phase 17: vb training through the entry point, I3D-NL R50 at full
    width and depth on the synthetic 224 px split: two epochs, the best
    model validated once more, then a second call that resumes the
    checkpoint of epoch 2 for one more epoch. Exact kernel launches."""
    from vidsitu_tpu_torch import main as port_main
    from vidsitu_tpu_torch.data import build_comm
    from vidsitu_tpu_torch.models.selector import (
        build_model,
        init_model_variables,
    )
    from vidsitu_tpu_torch.ops import attention as A

    n_train = len(json.loads(Path(paths["ds.vsitu.split_files_lb.train"])
                             .read_text()))
    steps = n_train // VB_BS
    assert steps == 2, f"{n_train} train segments: {steps} steps an epoch"
    fwd = A.kernel_entry(torch.bfloat16, 256)
    bwd = A.bwd_kernel_entry(torch.bfloat16, 256)
    assert fwd == A.kernel_entry(torch.bfloat16, 512)
    assert bwd == A.bwd_kernel_entry(torch.bfloat16, 512) == A.WGMMA_BWD_ENTRY
    A.reset_launches()
    t0 = time.perf_counter()
    with recorded_step_losses() as step_losses:
        res = port_main.main(vb_train_args(paths, root))
    wall = time.perf_counter() - t0
    launches = dict(A.LAUNCHES_BY_ENTRY)
    learner, cfg = res["learner"], res["cfg"]
    n_nl = len(nl_blocks(learner.model))
    eval_batches = -(-8 // VB_BS)  # the valid split's 8 segments
    want_fwd = n_nl * (2 * steps + 2 * eval_batches + eval_batches)
    want_bwd = n_nl * 2 * steps
    log(f"[17 train] main --task_type=vb i3d_r50_nl_8x8 bf16, {n_train} "
        f"segments ({steps} steps of {VB_BS} videos = {5 * VB_BS} clips), 2 "
        f"epochs + final validation in {wall:.1f} s; launches {launches} "
        f"(want {fwd} {want_fwd}, {bwd} {want_bwd})")
    assert n_nl == NL_BLOCKS and launches == {
        **dict.fromkeys(launches, 0), fwd: want_fwd,
        bwd: want_bwd}, (n_nl, launches)
    tdir = (Path(cfg.misc.tmp_path) / "tracking"
            / f"{cfg.expm.exp_name}_vb" / cfg.uid)
    recs = [json.loads(x) for x in (tdir / "metrics.jsonl").read_text()
            .splitlines()]
    losses = [r["trn_loss"] for r in recs]
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert learner.model_file.is_file(), learner.model_file
    with open(res["pred_dir"] / "valid_0.pkl", "rb") as f:
        preds = pickle.load(f)
    assert len(preds) == 8 and all(
        len(p["pred_vbs_ev"]) == 5 and all(len(e) == 5 for e in p["pred_vbs_ev"])
        and np.isfinite(np.asarray(p["pred_scores_ev"])).all()
        for p in preds), "5 events x 5 verbs per segment"
    _, acc = res["results"]["valid"]
    # the weights moved from flax's initial values
    fresh = init_model_variables(build_model(cfg, build_comm(cfg)),
                                 int(cfg.train.seed)).state_dict()
    ep2 = torch.load(learner.model_epoch_dir / "mdl_ep_2.ckpt",
                     map_location="cpu", weights_only=True)
    trained = ep2["model_state_dict"]
    moved = {k: not torch.equal(trained[k], fresh[k]) for k in fresh
             if not k.endswith("num_batches_tracked")}
    nl = [k for k in moved if ".nl_" in k and k.endswith(
        (".weight", "running_var"))]
    assert nl and all(moved[k] for k in nl), [k for k in nl if not moved[k]]
    log(f"[17 train] train losses {losses}, valid metrics {acc}; "
        f"{sum(moved.values())}/{len(moved)} tensors moved from the initial "
        f"values (every non-local weight and BN statistic among them); "
        f"{len(preds)} segments x 5 events x 5 verbs in valid_0.pkl")
    # resume the epoch-2 checkpoint by uid for one more epoch
    A.reset_launches()
    res2 = port_main.main(vb_train_args(
        paths, root, "--train.resume=True", "--train.epochs=1",
        f"--train.resume_path={learner.model_epoch_dir / 'mdl_ep_2.ckpt'}",
        "--run_final_val=False"))
    l2 = res2["learner"]
    opt_steps = int(l2.optimizer.state_dict()["state"][0]["step"])
    log(f"[17 train] resumed at epoch 2 it {2 * steps}: now epoch "
        f"{l2.num_epoch}, it {l2.num_it}, Adam step {opt_steps}; launches "
        f"{dict(A.LAUNCHES_BY_ENTRY)}")
    assert l2.num_epoch == 3 and l2.num_it == 3 * steps, (l2.num_epoch,
                                                          l2.num_it)
    assert opt_steps == 3 * steps, "optimizer state not restored"
    assert A.LAUNCHES_BY_ENTRY[bwd] == n_nl * steps
    return launches, wall, {"step_losses": step_losses, "epochs": recs,
                            "fwd": fwd, "bwd": bwd}


def nl_blocks(model):
    from vidsitu_tpu_torch.models.video_backbone import NonLocalBlock

    return {n: m for n, m in model.named_modules()
            if isinstance(m, NonLocalBlock)}


def phase_train_step(dev):
    """Phase 18: one I3D-NL R50 train step at the config's batch (16 videos
    = 80 clips) on device tensors, with the kernels and with the plain
    attention under autograd: loss and non-local gradients compared, the
    step timed in turns, peak memory, a profile of one step."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from vidsitu_tpu_torch.bench import make_vb_train
    from vidsitu_tpu_torch.convert.from_flax import (
        flax_to_state_dict,
        seeded_variables,
    )
    from vidsitu_tpu_torch.ops import attention as A

    videos, accum = 16, 1
    model, opt, batch, _ = make_vb_train("i3d_r50_nl_8x8", videos, dev)
    # seeded non-zero gammas: at flax's init the non-local blocks are
    # identities and their gradients zero
    sd = flax_to_state_dict(seeded_variables(model, 0))
    model.load_state_dict(sd, strict=True)
    blocks = nl_blocks(model)
    assert len(blocks) == NL_BLOCKS

    def use(attn):
        for m in blocks.values():
            m.attention = attn

    captured = {}  # block -> [its input, the gradient at its output]

    def full_step(attn, capture=False):
        use(attn)
        hooks = []
        if capture:
            def keep(mod, args, out, name):
                captured[name] = [args[0].detach()]
                out.register_hook(
                    lambda g: captured[name].append(g.detach()))
            hooks = [m.register_forward_hook(functools.partial(keep, name=n))
                     for n, m in blocks.items()]
        opt.zero_grad(set_to_none=True)
        loss = model(batch)["loss"]
        loss.backward()
        for h in hooks:
            h.remove()
        return loss.detach().float()

    try:
        torch.cuda.reset_peak_memory_stats(dev)
        loss_k = full_step(A.nonlocal_attention, capture=True)
        peak = torch.cuda.max_memory_allocated(dev)
    except torch.cuda.OutOfMemoryError:
        videos, accum = 8, 2
        log("[18 step] 80 clips do not fit: 8 videos with grad_accum 2")
        del model, opt, batch
        captured.clear()
        torch.cuda.empty_cache()
        model, opt, batch, _ = make_vb_train("i3d_r50_nl_8x8", videos, dev)
        model.load_state_dict(sd, strict=True)
        blocks = nl_blocks(model)
        torch.cuda.reset_peak_memory_stats(dev)
        loss_k = full_step(A.nonlocal_attention, capture=True)
        peak = torch.cuda.max_memory_allocated(dev)
    loss_p = full_step(A.attention_reference)
    torch.cuda.synchronize()
    loss_err = abs(loss_k.item() - loss_p.item())
    loss_ok = np.isfinite(loss_k.item()) and loss_err <= 5e-2 * max(
        abs(loss_p.item()), 1.0)
    log(f"[18 step] i3d_r50_nl_8x8 train step, {videos} videos = "
        f"{5 * videos} clips bf16: loss kernel {loss_k.item():.5f} vs plain "
        f"{loss_p.item():.5f} (diff {loss_err:.2e}, limit 5e-2 of the loss) "
        f"{'ok' if loss_ok else 'FAIL'}")
    assert loss_ok, "kernel and plain train steps disagree on the loss"

    # Each non-local block on its own, on the input and the output gradient
    # it had in the step above. In bf16, the training path's own precision:
    # the backward kernel's dq / dk / dv against both plain backwards on the
    # attention's own tensors. In float32 (the block, its input and its
    # output gradient cast up; both kernel entries take float32): theta /
    # phi / g / out weight gradients with the backward kernel and with the
    # plain backward, the forward kernel in both (with the plain forward too,
    # printed). The bf16 weight gradients are printed, not held to 5e-2: a
    # weight's gradient sums its input's gradient over 62,720 (s3) or 15,680
    # (s4) positions, and dO sums to about zero over them (it leaves a
    # BatchNorm), so the sum cancels to a small part of its terms and one
    # bf16 rounding of dv more or less moves it by percents; and with the
    # plain forward too, one rounding of an attention output passes through
    # the BatchNorm after it, whose batch deviation is small at seeded
    # weights (whole steps agree on the loss only).
    def recording(store):
        def attn(q, k, v, kind, scale):
            out = A.nonlocal_attention(q, k, v, kind, scale)
            store.update(q=q.detach(), k=k.detach(), v=v.detach(),
                         o=out.detach(), kind=kind, scale=scale)
            out.register_hook(lambda g: store.__setitem__("do", g.detach()))
            for key, t in (("dq", q), ("dk", k), ("dv", v)):
                t.register_hook(
                    lambda g, key=key: store.__setitem__(key, g.detach()))
            return out
        return attn

    def block_grads(m, x, g_out, attn):
        m.attention = attn
        m.zero_grad(set_to_none=True)
        m(x.clone().requires_grad_()).backward(g_out)
        return {c: getattr(m, c).weight.grad.float().clone()
                for c in ("theta", "phi", "g", "out")}

    def rel(a, b):
        return (a.float() - b.float()).abs().max().item() / max(
            b.float().abs().max().item(), 1e-30)

    def plain_backward(q, k, v, out, dout, lse, kind, scale):
        return A.attention_backward_reference(q, k, v, out, dout, kind, scale)

    def with_plain_backward(m, x, g_out):
        kernel_backward = A.NonLocalAttnFn.backward_impl
        A.NonLocalAttnFn.backward_impl = staticmethod(plain_backward)
        try:
            return block_grads(m, x, g_out, A.nonlocal_attention)
        finally:
            A.NonLocalAttnFn.backward_impl = kernel_backward

    worst = worst_attn = 0.0
    for name, m in blocks.items():
        x, g_out = captured[name]
        store = {}
        g_k = block_grads(m, x, g_out, recording(store))
        g_p = block_grads(m, x, g_out, A.attention_reference)
        args = [store[key] for key in ("q", "k", "v", "o", "do")]
        want = A.attention_backward_reference(*args, store["kind"],
                                              store["scale"])
        _, lse = A.fused_attention(*args[:3], store["kind"], store["scale"],
                                   with_lse=True)
        want_t = A.attention_backward_tiled_reference(
            *args, lse, store["kind"], store["scale"],
            entry=A.bwd_kernel_entry(args[0].dtype, args[0].shape[-1]))
        attn_errs = {key: max(rel(store[key], w), rel(store[key], wt))
                     for key, w, wt in zip(("dq", "dk", "dv"), want, want_t)}
        del store, args, want, want_t
        x32, g32 = x.float(), g_out.float()
        g_k32 = block_grads(m, x32, g32, A.nonlocal_attention)
        g_pb32 = with_plain_backward(m, x32, g32)
        g_p32 = block_grads(m, x32, g32, A.attention_reference)
        torch.cuda.synchronize()
        errs = {c: rel(g_k32[c], g_pb32[c]) for c in g_k32}
        ok = (all(e <= 5e-2 for e in errs.values())
              and all(e <= 5e-2 for e in attn_errs.values())
              and all(g_pb32[c].abs().max().item() > 0 for c in g_pb32))
        log(f"[18 step] {name} {tuple(x.shape)}: bf16 dq/dk/dv vs both plain "
            f"backwards on the block's tensors, error / scale "
            + " ".join(f"{c} {e:.2e}" for c, e in attn_errs.items())
            + "; float32 theta/phi/g/out weight gradients, backward kernel "
            "vs plain backward " + " ".join(f"{c} {e:.2e}"
                                             for c, e in errs.items())
            + f" (limit 5e-2) {'ok' if ok else 'FAIL'}; printed only: "
            "float32 with the plain forward too " + " ".join(
                f"{c} {rel(g_k32[c], g_p32[c]):.2e}" for c in g_k32)
            + ", bf16 kernels vs plain " + " ".join(
                f"{c} {rel(g_k[c], g_p[c]):.2e}" for c in g_k))
        assert ok, f"{name}: kernel and plain gradients disagree"
        worst = max(worst, *errs.values())
        worst_attn = max(worst_attn, *attn_errs.values())
    captured.clear()

    def step(attn):
        def run():
            use(attn)
            for _ in range(accum):
                (model(batch)["loss"] / accum).backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
        return run

    use(A.nonlocal_attention)
    with FlopCounterMode(display=False) as counter:
        model(batch)["loss"].backward()
    opt.zero_grad(set_to_none=True)
    flops = float(counter.get_total_flops()) * accum
    ms, plain_ms = medians_in_turns([step(A.nonlocal_attention),
                                     step(A.attention_reference)], 3)
    step_videos = videos * accum
    log(f"[18 step] update of {step_videos} videos: kernels {ms:.1f} ms = "
        f"{step_videos * 1e3 / ms:.2f} videos/s, "
        f"{flops / ms / 1e9:.1f} TFLOP/s ({flops:.4g} FLOP by "
        f"FlopCounterMode, {100 * flops / ms / 1e9 / 989:.1f} % of the bf16 "
        f"peak); plain attention {plain_ms:.1f} ms = "
        f"{step_videos * 1e3 / plain_ms:.2f} videos/s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    # where a step's time goes
    run = step(A.nonlocal_attention)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    dev_ms = max(sum(e.self_device_time_total for e in rows) / 1e3, 1e-9)
    attn_ms = sum(e.self_device_time_total for e in rows
                  if "nl_attn" in e.key) / 1e3
    log(f"[18 profile] one update: device kernels {dev_ms:.1f} ms against "
        f"{wall * 1e3:.1f} ms unprofiled wall (device busy "
        f"{100 * dev_ms / wall / 1e3:.1f} %); non-local attention kernels "
        f"{attn_ms:.2f} ms ({100 * attn_ms / dev_ms:.1f} %)")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms "
            f"{100 * e.self_device_time_total / 1e3 / dev_ms:5.1f} % "
            f"{e.count:6d}x  {e.key[:80]}")
    del model, opt, batch
    torch.cuda.empty_cache()
    return {"videos": step_videos, "accum": accum, "ms": ms,
            "loss": loss_k.item(), "plain_ms": plain_ms,
            "tflops": flops / ms / 1e9,
            "peak_gib": peak / 2**30, "grad_rel_err": worst,
            "attn_grad_rel_err": worst_attn,
            "device_busy": dev_ms / wall / 1e3, "attn_share": attn_ms / dev_ms}


def phase_bench_train(dev):
    """Phase 19: ``vidsitu_tpu_torch.bench`` vbtrain and vbtrain16 in
    process (SlowFast R50 8x8, no kernel of the port on that path)."""
    from vidsitu_tpu_torch import bench

    name = torch.cuda.get_device_name(dev)
    out = []
    for mode, metric in (("vbtrain", "slowfast_vb_train_throughput"),
                         ("vbtrain16",
                          "slowfast_vb_train_throughput_bs16_accum2")):
        (res,) = bench.main([mode])
        assert res["metric"] == metric and res["device"] == name, res
        assert np.isfinite(res["value"]) and res["value"] > 0, res
        assert name in res["roofline_of"] and res["roofline_frac"] > 0, res
        out.append(res)
        torch.cuda.empty_cache()
    log(f"[19 bench] vbtrain {out[0]['value']} videos/s "
        f"({out[0]['tflops']} TFLOP/s), vbtrain16 {out[1]['value']} videos/s")
    return out


# SRL (vb_arg) and evrel training: phases 20-23
LANG_BS = {"vb_arg": 16, "evrel": 8}  # train.bs of phases 20 and 22
# bf16 against float32 on one step, dropout off: the loss relative to
# itself, each gradient relative to the larger of its leaf's scale and
# 1e-3 of the largest gradient of the model (GRAD_FLOOR; a leaf whose
# gradient is zero in exact arithmetic, such as the key projection's bias
# under the softmax, holds rounding noise only). A gradient is held to
# STEP_GRAD_TOL where it is well-conditioned: where the float32 step's own
# gradient moves by less than WELL_COND of its scale when only the batch's
# float inputs are rounded to bf16. At flax's initial values the SRL video
# encoder's attention is saturated (its inputs are scaled by sqrt(d)), and
# that one rounding alone moves those float32 gradients by tens of percents,
# so no bf16 step can meet a per-leaf limit there; those are printed.
# Gradients that are zero in exact arithmetic hold rounding noise only and
# are not compared: a key bias adds the same q.b to every logit of a query,
# which the softmax cancels; the SRL decoders cross-attend to one memory
# slot, so the cross-attention's q / k projections get none.
STEP_LOSS_TOL, STEP_GRAD_TOL, GRAD_FLOOR, WELL_COND = 1e-2, 5e-2, 1e-3, 1e-2
ZERO_GRAD = re.compile(r"k_proj\.bias$|cross_attn\.[qk]_proj\.")


def lang_train_args(uid, task, mdl, paths, root, *extra):
    bs = LANG_BS[task]
    return [uid, f"--task_type={task}", f"--mdl.mdl_name={mdl}",
            "--train.dtype=bfloat16", f"--train.bs={bs}",
            f"--train.bsv={bs}", "--train.nw=0", "--train.nwv=0",
            "--train.epochs=2", "--train.lr=1e-4",
            "--train.save_mdl_epochs=True",
            f"--misc.tmp_path={root / 'tmp'}",
            *[f"--{k}={v}" for k, v in paths.items()], "--device=cuda",
            *extra]


def gen_offset(state) -> int:
    """A CUDA generator state's Philox offset (the state is the seed, then
    the offset): it grows by the same amount every epoch of the same
    shapes."""
    return int(state.view(torch.int64)[1])


def fit_and_resume(uid, task, mdl, paths, root, *extra):
    """``main.py`` in process: two epochs (each validated, the best model
    validated again), then a second call that resumes the epoch-2
    checkpoint by uid for a third. Asserts finite losses, weights moved
    from flax's initial values, ``{uid}.ckpt``, the optimizer's step count
    and the dropout generator continued, not restarted. Returns both
    results and the wall time of the first call."""
    from vidsitu_tpu_torch import main as port_main
    from vidsitu_tpu_torch.data import build_comm
    from vidsitu_tpu_torch.models.selector import (
        build_model,
        init_model_variables,
    )

    n_train = len(json.loads(Path(paths["ds.vsitu.split_files_lb.train"])
                             .read_text()))
    steps = n_train // LANG_BS[task]
    t0 = time.perf_counter()
    res = port_main.main(lang_train_args(uid, task, mdl, paths, root, *extra))
    wall = time.perf_counter() - t0
    learner, cfg = res["learner"], res["cfg"]
    recs = [json.loads(x) for x in (
        Path(cfg.misc.tmp_path) / "tracking" / f"{cfg.expm.exp_name}_{task}"
        / uid / "metrics.jsonl").read_text().splitlines()]
    losses = [r["trn_loss"] for r in recs]
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert learner.model_file.is_file(), learner.model_file
    fresh = init_model_variables(build_model(cfg, build_comm(cfg)),
                                 int(cfg.train.seed)).state_dict()
    trained = torch.load(learner.model_epoch_dir / "mdl_ep_2.ckpt",
                         map_location="cpu", weights_only=True)
    moved = {k: not torch.equal(trained["model_state_dict"][k], v)
             for k, v in fresh.items()}
    # the SRL decoders cross-attend to one memory slot per event: the
    # softmax over one key is 1, so the cross-attention's q / k projections
    # get zero gradients and stay where they started
    stayed = [k for k, v in moved.items() if not v and fresh[k].dim() == 2
              and not (mdl == "sfpret_txe_txd_vbarg" and re.search(
                  r"cross_attn\.[qk]_proj", k))]
    assert not stayed, f"weights that did not move: {stayed[:5]}"
    off2 = gen_offset(trained["dropout_rng"])
    res2 = port_main.main(lang_train_args(
        uid, task, mdl, paths, root, *extra, "--train.resume=True",
        "--train.epochs=1",
        f"--train.resume_path={learner.model_epoch_dir / 'mdl_ep_2.ckpt'}",
        "--run_final_val=False"))
    l2 = res2["learner"]
    opt_steps = int(l2.optimizer.state_dict()["state"][0]["step"])
    off3 = gen_offset(l2.dropout_gen.get_state())
    log(f"[{'20' if task == 'vb_arg' else '22'} {task}] main {mdl} bf16, "
        f"{n_train} segments ({steps} steps of {LANG_BS[task]} videos), 2 "
        f"epochs + final validation in {wall:.1f} s; train losses {losses}; "
        f"{sum(moved.values())}/{len(moved)} tensors moved from the initial "
        f"values (every weight matrix with a gradient among them); resumed: "
        f"epoch {l2.num_epoch}, it {l2.num_it}, Adam step {opt_steps}, "
        f"dropout generator offset {off2} after 2 epochs, {off3} after 3")
    assert l2.num_epoch == 3 and l2.num_it == 3 * steps, (l2.num_epoch,
                                                          l2.num_it)
    assert opt_steps == 3 * steps, "optimizer state not restored"
    assert off2 > 0 and 2 * off3 == 3 * off2, "dropout generator restarted"
    return res, res2, wall


def phase_srl_train_main(paths, root):
    """Phase 20: SRL training through the entry point,
    ``sfpret_txe_txd_vbarg`` at full width in bf16 on the synthetic split's
    seeded (5, 2048) features, each validation at beam 5 on the reorder
    route: one row-gather launch per decode step, one pkl entry a segment
    whose events start with their verbs."""
    from vidsitu_tpu_torch.ops import beam_gather as B

    B.LAUNCHES = 0
    res, res2, wall = fit_and_resume(
        "chip_smoke_srl_train", "vb_arg", "sfpret_txe_txd_vbarg", paths,
        root, "--gen.beam_size=5", "--tpu.ancestry_beam=False")
    ev, cfg = res["evaluator"], res["cfg"]
    steps = ev.generate_fn.steps + res2["evaluator"].generate_fn.steps
    launches = B.LAUNCHES
    _, acc = res["results"]["valid"]
    with open(res["pred_dir"] / "valid_0.pkl", "rb") as f:
        preds = pickle.load(f)
    n_valid = len(json.loads(Path(paths["ds.vsitu.split_files_lb.valid"])
                             .read_text()))
    log(f"[20 vb_arg] validations: {len(steps)} decode batches, steps "
        f"{steps}, gather launches {launches} (the resumed epoch's included); "
        f"valid metrics {acc}")
    assert launches == sum(steps) > 0, (
        f"row-gather launches {launches} != decode steps {sum(steps)}")
    assert len(preds) == n_valid and sorted(
        p["ann_idx"] for p in preds) == list(range(n_valid))
    assert set(acc) == set(ev.met_keys) and all(
        np.isfinite(v) for v in acc.values()), acc
    batch = device_batch(cfg, "cpu")
    wvoc = ev.comm.gpt2_hf_tok
    verbs = batch["seq_out_by_ev"][:, :, 0, 0].numpy()
    by_idx = {int(i): row for i, row in zip(batch["vseg_idx"], verbs)}
    for p in preds:
        assert set(p["vb_output"]) == {f"Ev{i}" for i in range(1, 6)}
        for ev_ix in range(5):
            want = wvoc.decode([int(by_idx[p["ann_idx"]][ev_ix])])
            got = p["vb_output"][f"Ev{ev_ix + 1}"].get("vb_id", "")
            assert got.startswith(want), (p["ann_idx"], ev_ix, got, want)
    return launches, wall


def step_check(tag, task, mdl, bs, dev, extra=None):
    """One train step of ``bs`` videos on device tensors in bf16 and in
    float32 from the same flax initial values, dropout off (``eval()``):
    loss and gradients compared (see STEP_GRAD_TOL); a third float32 step
    on the batch's float inputs rounded to bf16 tells the well-conditioned
    gradients apart. Then the bf16 step with dropout on timed (median of
    10 by CUDA events), peak memory, FLOPs by ``FlopCounterMode`` and a
    ``torch.profiler`` breakdown of one step."""
    from torch.utils.flop_counter import FlopCounterMode

    from vidsitu_tpu_torch.bench import (
        REAL_TX,
        make_lang_train,
        profile_step,
        train_step_fn,
    )

    extra = REAL_TX if extra is None else extra
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_step_") as tmp:
        for key, dtype in (("f32", "float32"), ("f32_rounded", "float32"),
                           ("bf16", "bfloat16")):
            model, opt, batch, _ = make_lang_train(
                task, mdl, bs, dev, Path(tmp), extra,
                {"train.dtype": dtype})
            if key == "f32_rounded":
                batch = {k: v.to(torch.bfloat16).float()
                         if v.is_floating_point() else v
                         for k, v in batch.items()}
            model.eval()
            loss = model(batch)["loss"]
            loss.backward()
            runs[key] = (loss.item(), {n: p.grad.float() for n, p in
                                       model.named_parameters()
                                       if p.grad is not None})
            if key != "bf16":
                del model, opt, batch
                torch.cuda.empty_cache()
    l32, g32 = runs["f32"]
    l16, g16 = runs["bf16"]
    g_rnd = runs["f32_rounded"][1]
    assert set(g16) == set(g32) == set(g_rnd) and g32
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in g32.values())

    def rel(g, n):
        return (g[n] - g32[n]).abs().max().item() / max(
            g32[n].abs().max().item(), floor)

    names = [n for n in g32 if not ZERO_GRAD.search(n)]
    errs = {n: rel(g16, n) for n in names}
    cond = {n: rel(g_rnd, n) for n in names}
    held = [n for n in names if cond[n] < WELL_COND]
    worst = max(held, key=errs.get)
    loose = sorted((n for n in names if n not in held),
                   key=lambda n: -errs[n])
    loss_err = abs(l16 - l32) / abs(l32)
    log(f"[{tag} step] {mdl}, {bs} videos, dropout off: loss bf16 {l16:.5f} "
        f"vs float32 {l32:.5f} (rel {loss_err:.2e}, limit {STEP_LOSS_TOL:g}); "
        f"{len(held)} of {len(errs)} gradients well-conditioned "
        f"({len(g32) - len(names)} zero in exact arithmetic left out), worst "
        f"{errs[worst]:.2e} of its scale at {worst} (limit "
        f"{STEP_GRAD_TOL:g}); the other {len(loose)}: bf16 error up to "
        f"{max([errs[n] for n in loose], default=0):.2e}, float32 moved by "
        f"rounding the inputs alone up to "
        f"{max([cond[n] for n in loose], default=0):.2e}")
    for n in loose[:6]:
        log(f"    {errs[n]:.2e} bf16, {cond[n]:.2e} rounded inputs: {n}")
    assert np.isfinite(l16) and loss_err <= STEP_LOSS_TOL
    assert errs[worst] <= STEP_GRAD_TOL, worst
    model.train()
    step = train_step_fn(model, opt, batch,
                         torch.Generator(device=dev).manual_seed(7))
    with FlopCounterMode(display=False) as counter:
        step()
    flops = float(counter.get_total_flops())
    torch.cuda.reset_peak_memory_stats(dev)
    ms = float(np.median(cuda_ms(step, 10)))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    rows, wall = profile_step(step, dev)
    dev_ms = max(sum(e.self_device_time_total for e in rows) / 1e3, 1e-9)
    n_kernels = sum(e.count for e in rows)
    log(f"[{tag} step] bf16 with dropout: {ms:.2f} ms = {bs * 1e3 / ms:.2f} "
        f"videos/s, {flops / ms / 1e9:.1f} TFLOP/s ({flops:.4g} FLOP by "
        f"FlopCounterMode, {100 * flops / ms / 1e9 / 989:.1f} % of the bf16 "
        f"peak), peak memory {peak:.2f} GiB")
    log(f"[{tag} profile] one step: device kernels {dev_ms:.2f} ms, "
        f"{n_kernels} launches, against {wall * 1e3:.2f} ms unprofiled wall "
        f"(device busy {100 * dev_ms / wall / 1e3:.1f} %)")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms "
            f"{100 * e.self_device_time_total / 1e3 / dev_ms:5.1f} % "
            f"{e.count:6d}x  {e.key[:80]}")
    del model, opt, batch
    torch.cuda.empty_cache()
    return {"videos": bs, "ms": ms, "tflops": flops / ms / 1e9,
            "peak_gib": peak, "device_busy": dev_ms / wall / 1e3,
            "loss_rel_err": loss_err, "grad_rel_err": errs[worst],
            "grads_held": len(held), "grads": len(errs),
            "grad_rel_err_rest": max([errs[n] for n in loose], default=0.0)}


def phase_evrel_main(paths, root):
    """Phase 22: evrel training through the entry point for ``rob_evrel``
    and ``sfpret_evrel`` at roberta-base dims: the top-1 relation per pair
    and annotator in ``valid_0.pkl``, finite metrics."""
    out = {}
    for mdl in ("rob_evrel", "sfpret_evrel"):
        res, _, wall = fit_and_resume(f"chip_smoke_{mdl}", "evrel", mdl,
                                      paths, root)
        loss, acc = res["results"]["valid"]
        with open(res["pred_dir"] / "valid_0.pkl", "rb") as f:
            preds = pickle.load(f)
        opp = set(res["evaluator"].comm.evrel_dct_opp.values())
        assert preds and all(
            len(p["pred_evrels_ev"]) == 4 and all(
                r in opp for row in p["pred_evrels_ev"] for r in row)
            for p in preds), "top-1 relation per pair"
        assert set(acc) == {"Macro_Top_1", "Top_1"} and all(
            np.isfinite(v) for v in acc.values()) and np.isfinite(
            loss["loss"]), (loss, acc)
        log(f"[22 evrel] {mdl}: {len(preds)} segments x 4 pairs in "
            f"valid_0.pkl, valid loss {loss['loss']:.4f}, metrics {acc}")
        out[mdl] = wall
    return out


def phase_bench_lang(dev):
    """Phase 23: ``vidsitu_tpu_torch.bench`` srl, srl_real at the synthetic
    and at GPT-2's vocabulary, evrel_real, in process."""
    from vidsitu_tpu_torch import bench

    name = torch.cuda.get_device_name(dev)
    out = []
    for args, metric in ((["srl"], "srl_train_throughput"),
                         (["srl_real"], "srl_train_throughput_d1024"),
                         (["srl_real", f"--vocab={REAL_VOCAB}"],
                          f"srl_train_throughput_d1024_v{REAL_VOCAB}"),
                         (["evrel_real"], "evrel_train_throughput_robbase")):
        (res,) = bench.main(args)
        assert res["metric"] == metric and res["device"] == name, res
        assert np.isfinite(res["value"]) and res["value"] > 0, res
        assert 0 < res["device_busy"] and res["peak_gib"] > 0, res
        out.append(res)
        torch.cuda.empty_cache()
    log("[23 bench] " + ", ".join(
        f"{r['metric']} {r['value']} videos/s ({r['tflops']} TFLOP/s, busy "
        f"{100 * r['device_busy']:.1f} %)" for r in out))
    return out


# -- several processes (phases 24-25) ---------------------------------------
DP_TIMEOUT_S = 300  # one torchrun launch, its processes' start included
DP_LOSS_RTOL = 1e-4  # 2 ranks against 1 process: the first step's loss, f32
# bf16 products against another process's: cuDNN may take other algorithms
# (the workspace it finds free differs), which round other bf16 outputs
DP_BF16_RTOL = 1e-3


@contextlib.contextmanager
def recorded_step_losses():
    """Every ``Learner.train_step``'s loss, as a float, in call order."""
    from vidsitu_tpu_torch.train.learner import Learner

    losses, step = [], Learner.train_step

    def train_step(self, batch):
        loss = step(self, batch)
        losses.append(float(loss))
        return loss

    Learner.train_step = train_step
    try:
        yield losses
    finally:
        Learner.train_step = step


def tracker_rows(cfg):
    path = (Path(cfg.misc.tmp_path) / "tracking"
            / f"{cfg.expm.exp_name}_{cfg.task_type}" / cfg.uid
            / "metrics.jsonl")
    return [json.loads(x) for x in path.read_text().splitlines()]


def torchrun(task, nproc, spec, root):
    """``python -m torch.distributed.run`` of this script in child mode on
    ``nproc`` ranks; every rank's result, in rank order. A failed rank or a
    launch past DP_TIMEOUT_S raises (the launcher's process group is
    killed). The children's output goes to ``root/{task}.log``."""
    import os
    import signal

    out = Path(root) / f"dp_{task}"
    out.mkdir(parents=True, exist_ok=True)
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps({**spec, "out": str(out)}))
    logf = Path(root) / f"{task}.log"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", str(Path(__file__).resolve()),
           "--dist-child", task, str(spec_path)]
    t0 = time.perf_counter()
    with open(logf, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                cwd=str(REPO), start_new_session=True)
        try:
            rc = proc.wait(timeout=DP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    wall = time.perf_counter() - t0
    text = logf.read_text(errors="replace")
    if rc != 0:
        log(text[-6000:])
        raise RuntimeError(f"torchrun {task} on {nproc} ranks: rc {rc} "
                           f"after {wall:.1f} s")
    res = [json.loads((out / f"rank{r}.json").read_text())
           for r in range(nproc)]
    for r in res:
        log(f"[dp {task}] rank {r['rank']}/{r['world']}: launches "
            f"{r['launches']}, kernel vs plain {r['checks']}, wall in the "
            f"rank {r['wall_s']:.1f} s")
    log(f"[dp {task}] {nproc} rank(s): torchrun wall {wall:.1f} s")
    return res, wall


def child_fit(spec, dev):
    """vb training through main.py; then, when asked, one float32 step of a
    fresh Learner on this rank's first batch (the global loss)."""
    from vidsitu_tpu_torch import main as port_main
    from vidsitu_tpu_torch.data.loader import fold_frame_events
    from vidsitu_tpu_torch.ops import attention as A
    from vidsitu_tpu_torch.parallel.collectives import is_main_process
    from vidsitu_tpu_torch.train.build import build_learner
    from vidsitu_tpu_torch.train.learner import batch_to_device
    from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

    with recorded_step_losses() as losses:
        res = port_main.main(spec["argv"])
    cfg = res["cfg"]
    out = {"step_losses": losses,
           "epochs": tracker_rows(cfg) if is_main_process() else None}
    if spec.get("f32_step"):
        fit_launches = dict(A.LAUNCHES_BY_ENTRY)
        uid, overrides, _ = port_main.parse_cli(spec["argv"])
        cfg32 = get_cfg_with_overrides(uid + "_f32", **{
            **overrides, "train.dtype": "float32",
            "misc.tmp_path": cfg.misc.tmp_path + "_f32"})
        learner = build_learner(cfg32, uid + "_f32", dev)
        learner.prepare_optimizer(float(cfg32.train.lr))
        batch = next(iter(learner.data.train_dl))
        out["f32_loss"] = float(learner.train_step(
            batch_to_device(fold_frame_events(batch), dev)))
        out["f32_launches"] = {k: v - fit_launches[k]
                               for k, v in A.LAUNCHES_BY_ENTRY.items()}
        A.LAUNCHES_BY_ENTRY.update(fit_launches)
        del learner
    return out


def child_srl(spec, dev):
    from vidsitu_tpu_torch import main as port_main

    res = port_main.main(spec["argv"])
    return {"steps": res["evaluator"].generate_fn.steps,
            "results": res["results"]["valid"]}


def child_extract(spec, dev):
    from vidsitu_tpu_torch import extract

    extract.main(spec["argv"])
    return {}


def child_checks(task, dev, rank, dtype=torch.bfloat16):
    """Each kernel of this task's path against its plain version once, at
    this rank's shapes and the run's dtype (launches not counted)."""
    from vidsitu_tpu_torch.ops import attention as A
    from vidsitu_tpu_torch.ops import beam_gather as B

    errs = {}
    rng = np.random.default_rng(24 + rank)
    if task in ("fit", "extract", "fsdp"):
        # a train step's or an eval batch's clips on this rank: 5 a video;
        # extraction: one dispatch of clip_batch clips; phase 30's update
        b = {"fit": 5 * VB_BS // 2, "extract": 32,
             "fsdp": 5 * FSDP_VIDEOS}[task]
        for name, (sq, sk, d) in (("s3", S3), ("s4", S4)):
            q, k, v = seeded_qkv(rng, b, sq, sk, d, dtype, dev)
            scale = d ** -0.5
            out, lse = A.fused_attention(q, k, v, "softmax", scale,
                                         with_lse=True)
            ref = A.attention_reference(q, k, v, "softmax", scale)
            err = (out.float() - ref.float()).abs().max().item()
            assert err <= attn_limit(dtype, ref), (name, err)
            errs[f"{A.kernel_entry(dtype, d)} {name} B={b}"] = err
            if task in ("fit", "fsdp"):
                do = seeded_qkv(rng, b, sq, sq, d, dtype, dev)[0]
                got = A.fused_attention_backward(q, k, v, out, do, lse,
                                                 "softmax", scale)
                want = A.attention_backward_reference(q, k, v, out, do,
                                                      "softmax", scale)
                e = 0.0
                for g, r in zip(got, want):
                    eg = (g.float() - r.float()).abs().max().item()
                    assert eg <= grad_limit(dtype, r), (name, eg)
                    e = max(e, eg)
                errs[f"{A.bwd_kernel_entry(dtype, d)} {name} "
                     f"B={b}"] = e
    else:
        # a rank of phase 32's model axis holds half the heads
        heads = HEADS // TP_RANKS if task == "tp" else HEADS
        gen = torch.Generator(device=dev).manual_seed(24 + rank)
        leaves = cache_leaves(gen, SELF_LENS[-1], torch.bfloat16, dev, heads)
        idx = beam_rows(gen, dev)
        out = B.beam_gather_rows(leaves, idx)
        ref = B.beam_gather_rows_reference(leaves, idx)
        assert all(torch.equal(o, r) for o, r in zip(out, ref))
        errs[f"beam_gather_rows {EVENTS * BEAM} rows L={SELF_LENS[-1]} "
             f"H={heads}"] = 0.0
    torch.cuda.synchronize()
    return errs


def dist_child(task, spec_path) -> int:
    """One rank of a torchrun launch (phases 24-25, 28-33): join the process
    group, run ``task`` through the port's entry point with every kernel
    count at 0, then check the task's kernels against their plain versions
    at this rank's shapes; write the rank's JSON result."""
    import os

    sys.path.insert(0, str(REPO))
    from vidsitu_tpu_torch.ops import _build
    from vidsitu_tpu_torch.ops import attention as A
    from vidsitu_tpu_torch.ops import beam_gather as B
    from vidsitu_tpu_torch.parallel import collectives as C
    from vidsitu_tpu_torch.parallel.mesh import init_distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    spec = json.loads(Path(spec_path).read_text())
    dtype = getattr(torch, spec.get("dtype", "bfloat16"))
    dev = init_distributed(spec["device"], spec["backend"])
    rank, world = C.get_rank(), C.get_world_size()
    for name in ("nonlocal_attn", "beam_gather"):  # built by the parent
        assert _build.library_path(name).is_file(), name
    kind = "fit" if task.startswith("elastic") else task
    A.reset_launches()
    B.LAUNCHES = 0
    t0 = time.perf_counter()
    # phase 28 repeats a run bitwise
    with (deterministic_algorithms() if spec.get("deterministic")
          else contextlib.nullcontext()):
        res = {"fit": child_fit, "srl": child_srl, "extract": child_extract,
               "drop": child_drop, "fsdp": child_fsdp, "tp": child_tp,
               "resize": child_resize}[kind](spec, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**{k: v for k, v in A.LAUNCHES_BY_ENTRY.items() if v},
                "beam_gather_rows": B.LAUNCHES}
    # phase 29's SRL training launches no kernel
    checks = child_checks("fit" if kind == "resize" else kind, dev, rank,
                          dtype) if kind != "drop" else {}
    out = {"task": task, "rank": rank, "world": world,
           "local_rank": int(os.environ["LOCAL_RANK"]), "device": str(dev),
           "backend": torch.distributed.get_backend(), "wall_s": wall,
           "launches": launches, "checks": checks, **res}
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    assert not leaked, f"jax was imported: {leaked[:5]}"
    Path(spec["out"], f"rank{rank}.json").write_text(json.dumps(out))
    C.synchronize()
    torch.distributed.destroy_process_group()
    return 0


def phase_dp_fit_one_rank(paths, root, p17):
    """Phase 24: the vb fit of phase 17 (one epoch and its validation, same
    size, width and data) on one rank of a NCCL process group: the
    several-process code path (gradient all-reduce, rank 0's metrics
    broadcast, the evaluator's merge) with one rank. Its first step's loss
    and its epoch agree with phase 17's first epoch."""
    res, wall = torchrun("fit", 1, {
        "device": "cuda", "backend": "nccl",
        "argv": vb_train_args(paths, root, "--train.epochs=1",
                              "--run_final_val=False",
                              "--dist_backend=nccl")}, root)
    (r,) = res
    ep, ep17 = r["epochs"][0], p17["epochs"][0]
    fwd = r["launches"].get(p17["fwd"], 0)
    bwd = r["launches"].get(p17["bwd"], 0)
    first, first17 = r["step_losses"][0], p17["step_losses"][0]
    log(f"[24 dp] 1 rank (nccl, {r['device']}): first-step loss {first!r} "
        f"(phase 17: {first17!r}), epoch 1 train loss {ep['trn_loss']!r} "
        f"({ep17['trn_loss']!r}), metrics "
        f"{ {k: ep[k] for k in EVALB_KEYS} } "
        f"({ {k: ep17[k] for k in EVALB_KEYS} }); launches {fwd} forward, "
        f"{bwd} backward")
    assert r["backend"] == "nccl" and r["device"] == "cuda:0", r
    assert abs(first - first17) <= DP_BF16_RTOL * abs(first17), (
        first, first17)
    assert abs(ep["trn_loss"] - ep17["trn_loss"]) <= (
        DP_BF16_RTOL * abs(ep17["trn_loss"])), (ep, ep17)
    assert all(abs(ep[k] - ep17[k]) <= DP_METRIC_ATOL for k in EVALB_KEYS)
    steps, eval_batches = 2, -(-8 // VB_BS)
    assert (fwd, bwd) == (NL_BLOCKS * (steps + eval_batches),
                          NL_BLOCKS * steps), r["launches"]
    return res, wall


def f32_first_step_loss(paths, root):
    """One process: the float32 loss of the first step of phase 25's fit
    (the same first global batch, flax's initial values)."""
    from vidsitu_tpu_torch import main as port_main
    from vidsitu_tpu_torch.data.loader import fold_frame_events
    from vidsitu_tpu_torch.train.build import build_learner
    from vidsitu_tpu_torch.train.learner import batch_to_device
    from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

    uid, overrides, _ = port_main.parse_cli(vb_train_args(paths, root))
    cfg = get_cfg_with_overrides(uid, **{
        **overrides, "train.dtype": "float32",
        "misc.tmp_path": str(Path(root) / "tmp_f32")})
    learner = build_learner(cfg, uid, "cuda")
    learner.prepare_optimizer(float(cfg.train.lr))
    batch = next(iter(learner.data.train_dl))
    loss = float(learner.train_step(batch_to_device(
        fold_frame_events(batch), learner.device)))
    del learner
    torch.cuda.empty_cache()
    return loss


def phase_dp_two_ranks(vb_paths, vb_root, main_paths, main_root, feats_dir,
                       p17, srl_preds):
    """Phase 25: two ranks on the one card (gloo on CUDA tensors; NCCL
    refuses two ranks on one GPU), full width: the vb fit with the global
    batch split in two (and a float32 first step against one process's),
    SRL validation at beam 5 on the reorder route (rank 0's merged pickle
    against phase 8's), and I3D-NL R50 extraction (the files against phase
    3's). Every rank's launches of #1, #1b and #2, and each kernel against
    its plain version at that rank's shapes."""
    loss32 = f32_first_step_loss(vb_paths, vb_root)
    gloo = {"device": "cuda:0", "backend": "gloo"}
    dp = ("--device=cuda:0", "--dist_backend=gloo")
    fit, fit_wall = torchrun("fit", DP_RANKS, {**gloo, "f32_step": True,
                             "argv": vb_train_args(
                                 vb_paths, vb_root, "--train.epochs=1",
                                 "--run_final_val=False",
                                 f"--misc.tmp_path={vb_root / 'tmp_dp2'}",
                                 *dp)}, vb_root)
    first = [r["step_losses"][0] for r in fit]
    f32 = [r["f32_loss"] for r in fit]
    ep = fit[0]["epochs"][0]
    fwd = [r["launches"].get(p17["fwd"], 0) for r in fit]
    bwd = [r["launches"].get(p17["bwd"], 0) for r in fit]
    rel = abs(f32[0] - loss32) / abs(loss32)
    rel16 = abs(first[0] - p17["step_losses"][0]) / abs(
        p17["step_losses"][0])
    log(f"[25 dp] vb fit on 2 ranks (gloo, cuda:0): float32 first-step loss "
        f"{f32} against one process's {loss32!r} (relative {rel:.2e}, limit "
        f"{DP_LOSS_RTOL:g}); bf16 first-step loss {first} against phase "
        f"17's {p17['step_losses'][0]!r} (relative {rel16:.2e}); epoch 1 "
        f"train loss {ep['trn_loss']!r}, metrics "
        f"{ {k: ep[k] for k in EVALB_KEYS} }; launches by rank: forward "
        f"{fwd}, backward {bwd}; float32 step "
        f"{[r['f32_launches'] for r in fit]}")
    steps, eval_batches = 2, -(-8 // VB_BS)
    assert all(r["backend"] == "gloo" and r["device"] == "cuda:0"
               for r in fit), fit
    assert f32[0] == f32[1] and first[0] == first[1], (f32, first)
    assert rel <= DP_LOSS_RTOL, (f32, loss32)
    assert rel16 <= 1e-2, (first, p17["step_losses"][0])
    assert fwd == [NL_BLOCKS * (steps + eval_batches)] * DP_RANKS, fwd
    assert bwd == [NL_BLOCKS * steps] * DP_RANKS, bwd
    assert all(r["f32_launches"] == {V1_ENTRY: NL_BLOCKS,
                                     BWD_V1_ENTRY: NL_BLOCKS, **{
                                         k: 0 for k in r["f32_launches"]
                                         if k not in (V1_ENTRY,
                                                      BWD_V1_ENTRY)}}
               for r in fit), [r["f32_launches"] for r in fit]

    srl_tmp = main_root / "tmp_dp2"
    srl, srl_wall = torchrun("srl", DP_RANKS, {**gloo, "argv": srl_args(
        main_paths, main_root, feats_dir, "--only_val=True",
        "--gen.beam_size=5", "--tpu.ancestry_beam=False",
        f"--train.bsv={16 * DP_RANKS}", f"--misc.tmp_path={srl_tmp}", *dp)},
        main_root)
    with open(srl_tmp / "predictions" / "chip_smoke_srl" / "valid_0.pkl",
              "rb") as f:
        merged = pickle.load(f)
    gathers = [r["launches"]["beam_gather_rows"] for r in srl]
    steps = [sum(r["steps"]) for r in srl]
    log(f"[25 dp] SRL validation on 2 ranks: {len(merged)} merged entries, "
        f"equal to phase 8's: {merged == srl_preds}; metrics "
        f"{srl[0]['results'][1]}; row-gather launches by rank {gathers}, "
        f"decode steps {steps}")
    assert merged == srl_preds, "merged pickle differs from phase 8's"
    assert srl[0]["results"] == srl[1]["results"]
    assert gathers == steps and all(n > 0 for n in gathers), (gathers, steps)

    feats = main_root / "feats_dp2"
    ext, ext_wall = torchrun("extract", DP_RANKS, {**gloo, "argv": [
        *dp, "--allow_random_weights", "--split=valid",
        f"--out_dir={feats}", "--batch_size=4", "--clip_batch=32",
        "--num_threads=4", "--mdl.sf_mdl_name=i3d_r50_nl_8x8",
        "--train.dtype=bfloat16", f"--misc.tmp_path={main_root / 'tmp_ex'}",
        *[f"--{k}={v}" for k, v in main_paths.items()]]}, main_root)
    one = sorted((main_root / "feats").glob("*_feats.npy"))
    two = sorted(feats.glob("*_feats.npy"))
    worst = 0.0
    for a, b in zip(one, two):
        x, y = np.load(a), np.load(b)
        worst = max(worst, float(np.abs(x - y).max() / np.abs(x).max()))
    ext_launches = [r["launches"].get(p17["fwd"], 0) for r in ext]
    log(f"[25 dp] extraction on 2 ranks: {len(two)} files (phase 3: "
        f"{len(one)}), largest difference {worst:.2e} of the feature scale "
        f"(limit {FEATURE_RTOL:g}); attention launches by rank "
        f"{ext_launches}")
    assert [p.name for p in one] == [p.name for p in two] and len(two) == 8
    assert worst <= FEATURE_RTOL, worst
    assert ext_launches == [NL_BLOCKS] * DP_RANKS, ext_launches
    return {"fit": fit, "srl": srl, "extract": ext,
            "walls": {"fit": fit_wall, "srl": srl_wall, "extract": ext_wall}}


# -- the release surfaces and a resize (phases 26-28) ----------------------
FIT_TIMEOUT_S = 600  # phase 26's subprocess: three tiny fits on the card
FIT_EPOCHS = 2  # verify_release's default --fit_epochs, which phase 26 takes
STEP_MODELS = (("vb", "sf_base", None),
               ("vb_arg", "tx_only", None),
               ("vb_arg", "sfpret_txe_txd_vbarg", "i3d_synth"),
               ("evrel", "rob_evrel", None))
# phase 28: the epoch-2 loss, relative; and the resized run's parameters and
# its BatchNorm statistics against the straight run's, each over the whole
# model, relative to how far the straight run's epoch 2 moved them. In
# float32 the 2-rank and 1-process runs differ by rounding (the BatchNorm
# sums and the gradients add in other orders), which Adam turns into steps
# that differ by up to lr where a gradient is near zero (the non-local
# biases part by 2.25x of their largest value). On the H100 the sound resume
# read 1.11e-6 / 4.45e-2 / 1.79e-4; resumes without Adam's state or with
# another data order (the controls) at least 2.67e-3 / 0.491 / 2.56e-3. Each
# limit lies near the geometric middle, 3x or more from either side.
ELASTIC_RTOL = 1e-4
ELASTIC_DRIFT = {"params": 0.15, "stats": 7e-4}


def phase_fit_cli(root):
    """Phase 26: ``python -m vidsitu_tpu_torch.verify_release --fit
    --device=cuda`` in a subprocess, at the module's defaults: the training
    lifecycle of the three tasks at the JAX module's tiny dims. Every task
    ``[ok]``, rc 0; from
    the receipt, each task's loss drops, its resume epoch is at least 1
    (the check itself holds it to the best epoch), its prediction pickle
    exists and every metric is finite."""
    work = Path(root) / "fit"
    logf = Path(root) / "fit.log"
    cmd = [sys.executable, "-m", "vidsitu_tpu_torch.verify_release", "--fit",
           "--device=cuda", f"--fit_dir={work}"]
    t0 = time.perf_counter()
    with open(logf, "w") as f:
        rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                            cwd=str(REPO), timeout=FIT_TIMEOUT_S).returncode
    wall = time.perf_counter() - t0
    text = logf.read_text(errors="replace")
    lines = [ln for ln in text.splitlines() if ln.startswith("[")]
    receipt = json.loads(text.split("FIT_RECEIPT ", 1)[1].splitlines()[0]) \
        if "FIT_RECEIPT " in text else None
    for ln in lines:
        log(f"[26 fit] {ln}")
    if rc != 0 or receipt is None:
        log(text[-6000:])
        raise RuntimeError(f"verify_release --fit: rc {rc} after {wall:.1f} s")
    assert [ln.split("]", 1)[0] + "]" for ln in lines] == ["[ok]"] * 3, lines
    from vidsitu_tpu_torch.verify_release import FIT_TASKS

    assert [(t["task"], t["mdl"]) for t in receipt["tasks"]] == list(
        FIT_TASKS) and receipt["epochs"] == FIT_EPOCHS, receipt
    assert receipt["platform"] == "gpu" and receipt["device"] == (
        torch.cuda.get_device_name(0)), receipt
    for t in receipt["tasks"]:
        assert t["loss_drop"] > 0 and t["resume_epoch"] >= 1, t
        assert Path(t["pred_pkl"]).is_file(), t["pred_pkl"]
        assert all(np.isfinite(v) for v in t["val_metrics"].values()), t
        log(f"[26 fit] {t['task']}/{t['mdl']}: train loss {t['trn_loss']}, "
            f"resumed at epoch {t['resume_epoch']}, continued "
            f"{t['continued_loss']}, metrics {t['val_metrics']}, wall "
            f"{t['wall_s']} s")
    log(f"[26 fit] receipt {json.dumps(receipt)}; subprocess wall "
        f"{wall:.1f} s")
    return {"wall_s": wall, "receipt": receipt}


def phase_release_full_width(paths, root):
    """Phase 27: ``train_step_check`` at the config's own widths on a
    synthetic tree with 224 px frames (phase 17's), its vocab dirs as the
    release's converted ones: SlowFast R50 8x8 (``vb/sf_base``, bf16),
    ``vb_arg/tx_only``, ``vb_arg/sfpret_txe_txd_vbarg`` (d 1024, features
    2048) and ``evrel/rob_evrel`` (roberta-base widths), each ``[ok]``,
    with the step's ms and peak GiB; then ``--weights`` through ``main`` on
    a SFBase .pth in PySlowFast's layout made from the port's seeded R50
    model (``[ok]``, and loaded back equal to it) and an unrecognised .pt
    (``[skip]``)."""
    import io

    from vidsitu_tpu_torch import verify_release as VR
    from vidsitu_tpu_torch.convert.from_flax import (
        flax_to_state_dict,
        seeded_variables,
    )
    from vidsitu_tpu_torch.convert.slowfast_torch import (
        convert_sfbase_checkpoint,
    )
    from vidsitu_tpu_torch.convert.to_pyslowfast import pysf_state_dict
    from vidsitu_tpu_torch.data import build_comm
    from vidsitu_tpu_torch.models.selector import build_model

    data = Path(paths["ds.vsitu.split_files_lb.train"]).parents[2]
    vocab_dirs = {
        "verb": paths["ds.vsitu.vocab_files.verb_id_vocab"],
        "gpt2": paths["ds.vsitu.vocab_files.new_gpt2_vb_arg_vocab"],
        "roberta": paths["ds.vsitu.vocab_files.roberta_vocab"]}
    rep = VR.Report()
    steps = {}
    for task, mdl, feats in STEP_MODELS:
        res = VR.train_step_check(data, vocab_dirs, task, mdl, rep, feats,
                                  device="cuda")
        torch.cuda.empty_cache()
        if res is None:
            raise RuntimeError(f"train step[{task}/{mdl}]: {rep.failed}")
        steps[f"{task}/{mdl}"] = res
        log(f"[27 release] train step[{task}/{mdl}] at the config's widths: "
            f"loss {res['loss']!r}, {res['moved']}/{res['n_params']} tensors "
            f"moved, {res['ms']:.1f} ms (the first step), peak "
            f"{res['peak_gib']:.2f} GiB")
    assert not rep.failed and len(rep.passed) == len(STEP_MODELS), rep.failed

    wdir = Path(root) / "weights"
    wdir.mkdir()
    cfg = VR._release_cfg(data, vocab_dirs, "vb", "sf_base")
    model = build_model(cfg, build_comm(cfg))
    model.load_state_dict(flax_to_state_dict(seeded_variables(model, 27)),
                          strict=True)
    sd = pysf_state_dict(model.state_dict())
    name = "vb_slow_fast_nl_r50_8x8_model.pth"
    torch.save({"model_state_dict": sd, "num_it": 7}, wdir / name)
    torch.save({"mystery.weight": torch.zeros(3)}, wdir / "unknown.pt")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = VR.main(["--weights", str(wdir), "--device=cuda"])
    wall = time.perf_counter() - t0
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("[")]
    for ln in lines:
        log(f"[27 release] {ln}")
    assert rc == 0 and sorted(ln.split(":", 1)[0] for ln in lines) == [
        f"[ok]   weights[{name}]", "[skip] weights[unknown.pt]"], lines
    loaded = VR.load_video_tree(convert_sfbase_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, "slowfast", strict=True),
        "slowfast").state_dict()
    want = model.state_dict()
    assert loaded.keys() == want.keys() and all(
        torch.equal(loaded[k], want[k]) for k in want
        if not k.endswith("num_batches_tracked"))
    log(f"[27 release] --weights: {len(sd)} PySlowFast tensors of the seeded "
        f"R50 SFBase converted and loaded back equal to the model; "
        f"{wall:.1f} s")
    return {"steps": steps, "weights_wall_s": wall}


def ckpt_leaves(path):
    return torch.load(path, map_location="cpu",
                      weights_only=True)["model_state_dict"]


def drift(got, want, new, old, part):
    """||got - want|| over the parameters (``part`` "params") or the
    BatchNorm statistics ("stats"), relative to the update ||new - old||;
    and the five leaves whose largest difference is the largest part of the
    leaf's largest value."""
    keys = [k for k, v in want.items() if v.is_floating_point()
            and k.endswith(("running_mean", "running_var")) == (
                part == "stats")]
    num = sum(float((got[k].double() - want[k].double()).square().sum())
              for k in keys)
    den = sum(float((new[k].double() - old[k].double()).square().sum())
              for k in keys)
    leaves = sorted(((k, float((got[k] - want[k]).abs().max())
                      / max(float(want[k].abs().max()), 1e-30))
                     for k in keys), key=lambda kv: -kv[1])
    return math.sqrt(num / den), leaves[:5]


def phase_elastic(paths, root, p17, keep=None):
    """Phase 28: resume on another number of processes, with the kernels.
    Phase 17's I3D-NL R50 fit in float32 (the nl_attn_fwd / nl_attn_bwd
    entries): 2 gloo ranks on cuda:0 fit epoch 1 and save; one NCCL rank
    resumes that checkpoint for epoch 2; against a straight 2-epoch run in
    this process. The epoch-2 loss within ELASTIC_RTOL, the parameters and
    the statistics each within ELASTIC_DRIFT of the epoch's update; 20
    forward and 10 backward launches an epoch in every run; two wrong
    resumes (controls) outside every limit. ``keep`` takes the straight
    run's epoch-1 and epoch-2 parameters and its epoch-2 loss (phases 31
    and 33's reference), the resumed run's epoch-2 parameters and step
    losses (phase 33 repeats them bitwise) and the 2-rank run (phase 33's
    launch: it saves epoch 1, then resizes)."""
    from vidsitu_tpu_torch import main as port_main
    from vidsitu_tpu_torch.ops import attention as A

    f32 = ("--train.dtype=float32", "--run_final_val=False")
    uid = "chip_smoke_vb"
    fwd = A.kernel_entry(torch.float32, 256)
    bwd = A.bwd_kernel_entry(torch.float32, 256)
    assert (fwd, bwd) == (V1_ENTRY, BWD_V1_ENTRY)
    steps, eval_batches = 2, -(-8 // VB_BS)
    per_epoch = (NL_BLOCKS * (steps + eval_batches), NL_BLOCKS * steps)
    walls, launches = {}, {}

    # the 2-rank run is phase 33's launch: its ranks save epoch 1, then
    # resize to one rank
    two, walls["save_2rank"] = resize_launch(paths, root)
    ckpt = root / "tmp_rsz" / "model_epochs" / uid / "mdl_ep_1.ckpt"
    launches["save_2rank"] = [(r["launches_by_epoch"][0].get(fwd, 0),
                               r["launches_by_epoch"][0].get(bwd, 0))
                              for r in two]
    res, walls["resume"] = torchrun("elastic_resume", 1, {
        "device": "cuda", "backend": "nccl", "deterministic": True,
        "dtype": "float32", "argv": vb_train_args(
            paths, root, "--train.epochs=1", *f32, "--train.resume=True",
            f"--train.resume_path={ckpt}",
            f"--misc.tmp_path={root / 'tmp_el1_resume'}",
            "--dist_backend=nccl")}, root)
    launches["resume"] = [(r["launches"].get(fwd, 0),
                           r["launches"].get(bwd, 0)) for r in res]
    r1 = res[0]
    path1 = root / "tmp_el1_resume" / "model_epochs" / uid / "mdl_ep_2.ckpt"
    A.reset_launches()
    t0 = time.perf_counter()
    with deterministic_algorithms():
        straight = port_main.main(vb_train_args(
            paths, root, "--train.epochs=2", *f32,
            f"--misc.tmp_path={root / 'tmp_el_straight'}"))
    walls["straight_1proc"] = time.perf_counter() - t0
    launches["straight_1proc"] = [(A.LAUNCHES_BY_ENTRY[fwd],
                                   A.LAUNCHES_BY_ENTRY[bwd])]
    s_rows = tracker_rows(straight["cfg"])
    s_dir = straight["learner"].model_epoch_dir
    s_sd, s_sd1 = (ckpt_leaves(s_dir / f"mdl_ep_{e}.ckpt") for e in (2, 1))
    if keep is not None:
        keep.update(s_sd=s_sd, s_sd1=s_sd1, want2=s_rows[1]["trn_loss"])
    del straight
    torch.cuda.empty_cache()

    # controls: the 2-rank checkpoint resumed the wrong way in this process,
    # without Adam's state (a resume that does not load the optimizer), and
    # with another data order for epoch 2 (the sampler's seed)
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    payload["optimizer_state_dict"] = None
    no_adam = root / "tmp_rsz" / "no_adam.ckpt"
    torch.save(payload, no_adam)
    controls = {}
    for tag, path, extra in (("no_adam", no_adam, ()),
                             ("other_order", ckpt, ("--train.seed=43",))):
        with deterministic_algorithms():
            ctl = port_main.main(vb_train_args(
                paths, root, "--train.epochs=1", *f32, "--train.resume=True",
                f"--train.resume_path={path}", *extra,
                f"--misc.tmp_path={root / ('tmp_ctl_' + tag)}"))
        c_loss = tracker_rows(ctl["cfg"])[-1]["trn_loss"]
        c_sd = ckpt_leaves(ctl["learner"].model_epoch_dir / "mdl_ep_2.ckpt")
        del ctl
        torch.cuda.empty_cache()
        controls[tag] = {p: drift(c_sd, s_sd, s_sd, s_sd1, p)[0]
                         for p in ELASTIC_DRIFT}
        controls[tag]["loss"] = (abs(c_loss - s_rows[1]["trn_loss"])
                                 / abs(s_rows[1]["trn_loss"]))

    loss2, want2 = r1["epochs"][-1]["trn_loss"], s_rows[1]["trn_loss"]
    rel_loss = abs(loss2 - want2) / abs(want2)
    sd1 = ckpt_leaves(path1)
    if keep is not None:
        keep.update(resumed_sd=sd1, resumed_losses=r1["step_losses"],
                    resize=(two, walls["save_2rank"]))
    rel = {p: drift(sd1, s_sd, s_sd, s_sd1, p)[0] for p in ELASTIC_DRIFT}
    worst = drift(sd1, s_sd, s_sd, s_sd1, "params")[1]
    rel1 = {p: drift(ckpt_leaves(ckpt), s_sd1, s_sd, s_sd1, p)[0]
            for p in ELASTIC_DRIFT}
    log(f"[28 elastic] I3D-NL R50 float32: 2 gloo ranks fit epoch 1 and "
        f"save it (phase 33's launch, its resize and rank 0's epoch 2 "
        f"included: {walls['save_2rank']:.1f} s), 1 NCCL rank resumes it "
        f"for epoch 2 "
        f"({walls['resume']:.1f} s), "
        f"straight 2 epochs on 1 process ({walls['straight_1proc']:.1f} s)")
    log(f"[28 elastic] epoch-2 train loss: resumed {loss2!r}, straight "
        f"{want2!r} (relative {rel_loss:.2e}, limit {ELASTIC_RTOL:g}); "
        f"epoch 1: 2 ranks {two[0]['epochs'][0]['trn_loss']!r}, straight "
        f"{s_rows[0]['trn_loss']!r}; step losses resumed "
        f"{r1['step_losses']}")
    log(f"[28 elastic] parameters and statistics after epoch 2, resumed vs "
        f"straight, of the straight run's epoch-2 update: {rel} (limits "
        f"{ELASTIC_DRIFT}; after epoch 1, 2 ranks vs 1 process: {rel1}); "
        f"largest parameter differences of the leaf's largest value "
        f"{worst}")
    log(f"[28 elastic] controls, resumed the wrong way (the same readings, "
        f"each above its limit): {controls}")
    log(f"[28 elastic] launches ({fwd}, {bwd}) by run and rank: {launches} "
        f"(want {per_epoch} an epoch); kernel vs plain "
        f"{[r['checks'] for r in two + [r1]]}")
    assert "resumed a 2-process checkpoint on 1 processes" in (
        root / "tmp_el1_resume" / "txt_logs" / f"{uid}.txt").read_text()
    assert launches["save_2rank"] == [per_epoch] * DP_RANKS, launches
    assert launches["resume"] == [per_epoch], launches
    assert launches["straight_1proc"] == [(2 * per_epoch[0],
                                           2 * per_epoch[1])], launches
    assert rel_loss <= ELASTIC_RTOL, (loss2, want2)
    assert all(rel[p] <= lim for p, lim in ELASTIC_DRIFT.items()), rel
    limits = {**ELASTIC_DRIFT, "loss": ELASTIC_RTOL}
    assert all(c[p] > lim for c in controls.values()
               for p, lim in limits.items()), controls
    return {"walls_s": walls, "launches": launches, "loss_rel_err": rel_loss,
            "drift": rel, "drift_epoch1": rel1, "worst_leaf": worst[0],
            "controls": controls}


# phase 29: 2 gloo ranks against one process, SRL at full width in float32
# with dropout 0.1. The first step's global loss within DP_LOSS_RTOL (the
# ranks draw the one-process masks); with the ranks' generators seeded apart
# (the control) the loss must part by more. A grad_accum=2 cycle saved in
# flight on 2 ranks after 3 steps and resumed on one process for 3 more:
# the parameters against 6 straight steps, relative to those steps'
# last 3-step update (as phase 28's drift), within DROP_DRIFT; the same
# checkpoint resumed without its cycle (the control) parts by more. On the
# H100 the sound resume read 6.51e-2 (its largest leaves the attention key
# biases, whose gradients are zero in exact arithmetic and which Adam turns
# into steps of lr: the 2-rank sums round otherwise), the control 0.572;
# the limit lies near their geometric middle, 2.9x from either.
DROP_BS = 16  # phase 20's train.bs: 8 videos a rank
DROP_DRIFT = 0.19
# phase 30: the fsdp update (one NCCL rank on a (1, 1) data x fsdp mesh)
# against one process's from the same weights, bf16: the loss within
# DP_BF16_RTOL, the parameters and statistics within ELASTIC_DRIFT of the
# update
FSDP_VIDEOS = 16  # 80 clips, phase 18's update
FSDP_TIMED = 3  # timed updates of each variant, in turns


def drop_steps(argv, dev, steps, start=0, resume=None, saves=None,
               seed_apart=False, local_masks=False):
    """Phase 29's runs: a Learner of ``argv`` (build_learner) takes
    ``steps`` train steps on this rank's share of the global batches
    ``start``, ``start + 1``, ... of epoch 0, after resuming ``resume``
    (optimizer and grad_accum cycle included) when given, saving after step
    n where ``saves`` names a path for n. ``seed_apart`` seeds each rank's
    dropout generator from (train.seed + rank): the control. ``local_masks``
    (phase 32's control) has each rank of a model axis draw a dropout mask
    of its own slice's shape instead of its slice of the whole mask."""
    from itertools import islice

    from vidsitu_tpu_torch import main as port_main
    from vidsitu_tpu_torch.train.build import build_learner
    from vidsitu_tpu_torch.train.learner import batch_to_device
    from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

    saves = {int(n): path for n, path in (saves or {}).items()}  # JSON keys
    uid, overrides, _ = port_main.parse_cli(argv)
    cfg = get_cfg_with_overrides(uid, **overrides)
    learner = build_learner(cfg, uid, dev)
    learner.prepare_optimizer(float(cfg.train.lr))
    if resume:
        learner.load_model_dict(resume, load_opt=True)
    if seed_apart:
        learner.dropout_gen.manual_seed(int(cfg.train.seed) + learner.rank)
    losses = []
    with local_dropout_masks(local_masks):
        for batch in islice(learner.data.train_dl, start, start + steps):
            losses.append(float(learner.train_step(
                batch_to_device(batch, learner.device))))
            learner.num_it += 1
            if len(losses) in saves:
                learner.save_model_dict(saves[len(losses)])
    out = {"losses": losses, "accum_count": learner._accum_count}
    del learner
    torch.cuda.empty_cache()
    return out


def child_drop(spec, dev):
    return {"runs": [drop_steps(spec["argv"], dev, **run)
                     for run in spec["runs"]]}


def phase_dropout_ranks(root):
    """Phase 29: dropout that does not depend on the number of ranks, and a
    grad_accum cycle carried through a checkpoint, on the card at full
    width (sfpret_txe_txd_vbarg, d 1024, dropout 0.1, float32 products)."""
    from vidsitu_tpu_torch.data.synth import make_synth_dataset

    paths = make_synth_dataset(root / "data", n_train=6 * DROP_BS,
                               n_valid=8, n_test=1, seed=37)
    argv = lang_train_args(
        "chip_smoke_drop", "vb_arg", "sfpret_txe_txd_vbarg", paths, root,
        "--train.dtype=float32", "--train.grad_accum=2",
        f"--train.bs={DROP_BS}", f"--train.bsv={DROP_BS}",
        f"--misc.tmp_path={root / 'tmp'}")
    ck = {n: str(root / f"{n}.ckpt") for n in ("s3", "s6", "two3")}
    t0 = time.perf_counter()
    straight = drop_steps(argv, "cuda", 6, saves={3: ck["s3"], 6: ck["s6"]})
    two, wall = torchrun("drop", DP_RANKS, {
        "device": "cuda:0", "backend": "gloo",
        "argv": argv + ["--device=cuda:0", "--dist_backend=gloo"],
        "runs": [{"steps": 3, "saves": {3: ck["two3"]}},
                 {"steps": 1, "seed_apart": True}]}, root)
    resumed = drop_steps(argv, "cuda", 3, start=3, resume=ck["two3"],
                         saves={3: str(root / "resumed.ckpt")})
    payload = torch.load(ck["two3"], map_location="cpu", weights_only=True)
    assert payload["accum_count"] == 1 and payload["world_size"] == 2
    del payload["accum_grads"]
    payload["accum_count"] = 0
    torch.save(payload, root / "no_cycle.ckpt")
    control = drop_steps(argv, "cuda", 3, start=3,
                         resume=str(root / "no_cycle.ckpt"),
                         saves={3: str(root / "control.ckpt")})
    one = straight["losses"][0]
    firsts = [r["runs"][0]["losses"][0] for r in two]
    apart = [r["runs"][1]["losses"][0] for r in two]
    rel = abs(firsts[0] - one) / abs(one)
    rel_apart = abs(apart[0] - one) / abs(one)
    s3, s6 = ckpt_leaves(ck["s3"]), ckpt_leaves(ck["s6"])
    got = drift(ckpt_leaves(root / "resumed.ckpt"), s6, s6, s3, "params")
    ctl = drift(ckpt_leaves(root / "control.ckpt"), s6, s6, s3, "params")
    later = [abs(a - b) / abs(b) for a, b in zip(resumed["losses"],
                                                 straight["losses"][3:])]
    later_ctl = [abs(a - b) / abs(b) for a, b in zip(control["losses"],
                                                     straight["losses"][3:])]
    log(f"[29 drop] sfpret_txe_txd_vbarg d 1024, dropout 0.1, float32, "
        f"global batch {DROP_BS}: first-step loss on 2 gloo ranks {firsts} "
        f"against one process's {one!r} (relative {rel:.2e}, limit "
        f"{DP_LOSS_RTOL:g}); ranks seeded apart (control) {apart} (relative "
        f"{rel_apart:.2e}); grad_accum=2 cycle saved in flight on 2 ranks "
        f"after step 3, resumed on 1 process for steps 4-6: parameter drift "
        f"{got[0]:.3e} of the straight run's steps 4-6 update (limit "
        f"{DROP_DRIFT:g}; largest leaves {got[1][:3]}), losses 4-6 relative "
        f"{[f'{x:.1e}' for x in later]}; resumed without the cycle "
        f"(control) {ctl[0]:.3e}, its losses 4-6 relative "
        f"{[f'{x:.1e}' for x in later_ctl]}; walls: 2-rank launch "
        f"{wall:.1f} s, phase "
        f"{time.perf_counter() - t0:.1f} s")
    assert firsts[0] == firsts[1] and apart[0] == apart[1], (firsts, apart)
    assert rel <= DP_LOSS_RTOL < rel_apart, (firsts, apart, one)
    assert got[0] <= DROP_DRIFT < ctl[0], (got[0], ctl[0])
    assert max(later) <= DP_LOSS_RTOL, later
    return {"first_loss_rel_err": rel, "control_rel_err": rel_apart,
            "accum_drift": got[0], "accum_control_drift": ctl[0],
            "later_loss_rel_err": max(later), "wall_s": wall}


def fsdp_args(paths, root, *extra):
    return vb_train_args(paths, root, "--tpu.mesh_shape=[1, 1]",
                         "--tpu.mesh_axis_names=['data', 'fsdp']",
                         "--dist_backend=nccl", *extra)


def child_fsdp(spec, dev):
    """Phase 30 on one NCCL rank: the I3D-NL R50 update at 80 clips (bf16
    products) through a Learner whose model build_learner sharded over a
    (1, 1) data x fsdp mesh, against one process's update from the same
    weights (a plain copy, contiguous as FSDP2 keeps its parameters, and
    one in channels_last_3d, the one-process default); each timed in
    turns, with its peak memory; the layout a sharded convolution gets."""
    import copy

    from vidsitu_tpu_torch import main as port_main
    from vidsitu_tpu_torch.convert.from_flax import (
        flax_to_state_dict,
        seeded_variables,
    )
    from vidsitu_tpu_torch.ops import attention as A
    from vidsitu_tpu_torch.train.build import build_learner
    from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

    uid, overrides, _ = port_main.parse_cli(spec["argv"])
    cfg = get_cfg_with_overrides(uid, **{
        **overrides, "train.bs": str(FSDP_VIDEOS)})
    learner = build_learner(cfg, uid, dev)
    assert learner.sharded and learner.eval_model is not learner.model
    # seeded non-zero gammas: at flax's init the non-local blocks are
    # identities and their attention gradients zero (phase 18)
    sd = flax_to_state_dict(seeded_variables(learner.eval_model, 0))
    target = learner.model.state_dict()
    learner.model.load_state_dict({k: learner._shard_like(k, v, target[k])
                                   for k, v in sd.items()}, strict=True)
    learner.prepare_optimizer(float(cfg.train.lr))
    plain = copy.deepcopy(learner.eval_model)
    plain.load_state_dict(sd, strict=True)
    plain.train()
    chl = copy.deepcopy(plain).to(memory_format=torch.channels_last_3d)
    opts = {m: torch.optim.Adam(m.parameters(), lr=float(cfg.train.lr),
                                betas=(0.9, 0.99), eps=1e-8)
            for m in (plain, chl)}
    gen = torch.Generator(device=dev).manual_seed(30)
    vm = cfg.vid_mdl
    batch = {"frms_ev_fast_tensor": torch.randn(
        (5 * FSDP_VIDEOS, int(vm.num_frames), int(vm.crop_size),
         int(vm.crop_size), 3), generator=gen, device=dev).to(torch.bfloat16),
        "label_tensor": torch.randint(0, 10, (FSDP_VIDEOS, 5), generator=gen,
                                      device=dev)}
    seen = {}
    conv = learner.model.backbone.s3.block_0.b.conv

    def record(mod, args):
        w, x = mod.weight, args[0]
        seen.update(
            weight_channels_last=w.is_contiguous(
                memory_format=torch.channels_last_3d),
            weight_contiguous=w.is_contiguous(),
            input_channels_last=x.is_contiguous(
                memory_format=torch.channels_last_3d))

    hook = conv.register_forward_pre_hook(record)

    def plain_update(m):
        opts[m].zero_grad(set_to_none=True)
        loss = m(batch)["loss"]
        loss.backward()
        opts[m].step()
        return loss.detach()

    updates = {"fsdp": lambda: learner.train_step(batch),
               "plain": lambda: plain_update(plain),
               "channels_last": lambda: plain_update(chl)}
    old = {k: v.detach().cpu().clone() for k, v in plain.state_dict().items()}
    # the first update of each: the fsdp one's launches, its loss and
    # weights against one process's (the contiguous copy); peak memory
    peak, first = {}, {}
    for name, fn in updates.items():
        A.reset_launches()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        first[name] = float(fn())
        torch.cuda.synchronize(dev)
        peak[name] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if name == "fsdp":
            launches = {k: v for k, v in A.LAUNCHES_BY_ENTRY.items() if v}
            got = learner._model_state(full=True)
    hook.remove()
    want = {k: v.detach().cpu() for k, v in plain.state_dict().items()}
    rel = {p: drift(got, want, want, old, p)[0] for p in ELASTIC_DRIFT}
    ms = {name: [] for name in updates}
    for _ in range(FSDP_TIMED):
        for name, fn in updates.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(dev)
            ms[name].append(a.elapsed_time(b))
    out = {"loss": first, "loss_rel_err": abs(first["fsdp"] - first["plain"])
           / abs(first["plain"]), "drift": rel, "layout": seen,
           "fsdp_launches": launches, "peak_gib": peak,
           "ms": {k: float(np.median(v)) for k, v in ms.items()},
           "ms_all": ms}
    del learner, plain, chl, opts
    torch.cuda.empty_cache()
    return out


def phase_fsdp_update(paths, root):
    """Phase 30: fsdp on the card. gloo does not carry FSDP2's
    reduce-scatter on CUDA tensors (PREMUL_SUM refused; with a plain sum
    the ranks die of SIGSEGV), and NCCL refuses two ranks on one card: one
    NCCL rank on a (1, 1) data x fsdp mesh runs fully_shard's DTensor path
    here; the multi-rank parity is held on the CPU
    (tests/test_torch_fsdp.py)."""
    res, wall = torchrun("fsdp", 1, {
        "device": "cuda", "backend": "nccl",
        "argv": fsdp_args(paths, root / "fsdp",
                          f"--misc.tmp_path={root / 'tmp_fsdp'}")}, root)
    (r,) = res
    fwd, bwd = bf16_update_entries()
    log(f"[30 fsdp] I3D-NL R50 update at {5 * FSDP_VIDEOS} clips, bf16, one "
        f"NCCL rank, (1, 1) data x fsdp mesh: first-update loss {r['loss']} "
        f"(fsdp against plain relative {r['loss_rel_err']:.2e}, limit "
        f"{DP_BF16_RTOL:g}); drift against the plain update {r['drift']} "
        f"(limits {ELASTIC_DRIFT}); ms an update (median of {FSDP_TIMED}, "
        f"in turns) {r['ms']} (all {r['ms_all']}); peak GiB {r['peak_gib']}; "
        f"a sharded s3 convolution sees {r['layout']}; fsdp launches in one "
        f"update {r['fsdp_launches']}; kernel vs plain {r['checks']}; "
        f"torchrun wall {wall:.1f} s")
    assert r["loss_rel_err"] <= DP_BF16_RTOL, r["loss"]
    assert all(r["drift"][p] <= lim for p, lim in ELASTIC_DRIFT.items())
    assert r["fsdp_launches"] == {fwd: NL_BLOCKS, bwd: NL_BLOCKS}, r
    assert not r["layout"]["weight_channels_last"]
    return {k: r[k] for k in ("loss", "loss_rel_err", "drift", "ms",
                              "peak_gib", "layout", "fsdp_launches")}


def bf16_update_entries():
    """The routed bf16 entries of the I3D-NL update (d 256 and 512)."""
    from vidsitu_tpu_torch.ops import attention as A

    return (A.kernel_entry(torch.bfloat16, 256),
            A.bwd_kernel_entry(torch.bfloat16, 256))


def phase_fsdp_orbax(paths, root, straight):
    """Phase 31: phase 28's fit (float32, deterministic algorithms) epoch 1
    under fsdp (one NCCL rank, (1, 1) data x fsdp) saved through
    ckpt_backend=orbax (DcpBackend: each rank's shards, async, generations
    behind LIVE); epoch 2 resumed from it on one NCCL rank without fsdp;
    against phase 28's straight run within phase 28's limits."""
    from vidsitu_tpu_torch.ops import attention as A
    from vidsitu_tpu_torch.train.checkpoint import DcpBackend

    f32 = ("--train.dtype=float32", "--run_final_val=False",
           "--train.ckpt_backend=orbax")
    uid = "chip_smoke_vb"
    fwd = A.kernel_entry(torch.float32, 256)
    bwd = A.bwd_kernel_entry(torch.float32, 256)
    steps, eval_batches = 2, -(-8 // VB_BS)
    per_epoch = (NL_BLOCKS * (steps + eval_batches), NL_BLOCKS * steps)
    nccl = {"device": "cuda", "backend": "nccl", "deterministic": True,
            "dtype": "float32"}
    save, save_wall = torchrun("elastic_fsdp_save", 1, {**nccl, "argv":
                               fsdp_args(paths, root, "--train.epochs=1",
                                         *f32, "--misc.tmp_path="
                                         f"{root / 'tmp_fo'}")}, root)
    ckpt = root / "tmp_fo" / "model_epochs" / uid / "mdl_ep_1.ckpt"
    res, wall = torchrun("elastic_fsdp_resume", 1, {**nccl, "argv":
                         vb_train_args(paths, root, "--train.epochs=1", *f32,
                                       "--train.resume=True",
                                       f"--train.resume_path={ckpt}",
                                       f"--misc.tmp_path={root / 'tmp_fr'}",
                                       "--dist_backend=nccl")}, root)
    (s,), (r,) = save, res
    path2 = root / "tmp_fr" / "model_epochs" / uid / "mdl_ep_2.ckpt"
    sd2 = DcpBackend().load(path2)["model"]
    sd1 = DcpBackend().load(ckpt)["model"]
    s_sd, s_sd1, want2 = straight["s_sd"], straight["s_sd1"], straight["want2"]
    loss2 = r["epochs"][-1]["trn_loss"]
    rel_loss = abs(loss2 - want2) / abs(want2)
    rel = {p: drift(sd2, s_sd, s_sd, s_sd1, p)[0] for p in ELASTIC_DRIFT}
    rel1 = {p: drift(sd1, s_sd1, s_sd, s_sd1, p)[0] for p in ELASTIC_DRIFT}
    launches = {"fsdp_save": (s["launches"].get(fwd, 0),
                              s["launches"].get(bwd, 0)),
                "resume": (r["launches"].get(fwd, 0),
                           r["launches"].get(bwd, 0))}
    gens = sorted(p.name for p in ckpt.iterdir())
    log(f"[31 fsdp orbax] epoch 1 under fsdp saved through orbax "
        f"({save_wall:.1f} s; {gens}), epoch 2 resumed on 1 NCCL rank "
        f"({wall:.1f} s): epoch-2 loss {loss2!r} against phase 28's straight "
        f"{want2!r} (relative {rel_loss:.2e}, limit {ELASTIC_RTOL:g}); "
        f"drift after epoch 2 {rel}, after epoch 1 {rel1} (limits "
        f"{ELASTIC_DRIFT}); launches {launches} (want {per_epoch}); kernel "
        f"vs plain {[s['checks'], r['checks']]}")
    assert gens == ["LIVE", "tree.g0"], gens
    assert all(v == per_epoch for v in launches.values()), launches
    assert rel_loss <= ELASTIC_RTOL, (loss2, want2)
    assert all(rel[p] <= lim for p, lim in ELASTIC_DRIFT.items()), rel
    return {"walls_s": {"fsdp_save": save_wall, "resume": wall},
            "launches": launches, "loss_rel_err": rel_loss, "drift": rel,
            "drift_epoch1": rel1}


# -- tensor parallelism (phase 32) --------------------------------------------
TP_RANKS = 2  # the model axis: 2 gloo ranks on cuda:0, mesh [1, 2]
TP_BS = 16  # phase 29's global batch: one step an epoch
TP_MESH = ("--tpu.mesh_shape=[1, 2]",
           "--tpu.mesh_axis_names=['data', 'model']")
# the SRL configs' attention and activation dropout are 0: at 0.1 the sites
# inside the split region draw too, and the control can part
TP_RATES = ("--tx_dec.attention_dropout=0.1",
            "--tx_dec.activation_dropout=0.1")
# the split leaves' first-step gradients, of the largest: the geometric
# middle of the first readings on the card, 1.961e-3 (the saturated video
# encoder's self-attention q / k, where float32 reduction order moves the
# gradient most; the decoder's leaves 3.8e-4 at most) and the local-mask
# control's 0.602 (a guess of 1e-3 before any reading failed)
TP_GRAD_RTOL = 0.034
TP_TIMED = 5  # bf16 steps timed, each way


@contextlib.contextmanager
def local_dropout_masks(on):
    """With ``on``, ``models.common.dropout`` ignores its ``split``: each
    rank of a model axis draws a mask of its slice's shape."""
    from vidsitu_tpu_torch.models import common

    plain = common.dropout
    if on:
        common.dropout = (lambda x, rate, training, split=None:
                          plain(x, rate, training))
    try:
        yield
    finally:
        common.dropout = plain


@contextlib.contextmanager
def first_update_grads(out):
    """Fills ``out`` (name -> tensor on the CPU) with the gradients that the
    first update of a Learner made in the block uses, for the leaves that a
    model axis of TP_RANKS splits, whole (gathered over the model group)."""
    from vidsitu_tpu_torch.parallel.tensor import tp_plan
    from vidsitu_tpu_torch.train.learner import Learner

    prep = Learner.prepare_optimizer

    def prepare_optimizer(self, lr):
        prep(self, lr)
        step = self.optimizer.step
        names = set(self.split.dims if self.split
                    else tp_plan(self.model, TP_RANKS))

        def first_step(*a, **kw):
            if not out:
                out.update({n: self._whole(n, p.grad, True) for n, p in
                            zip(self._param_names, self._params)
                            if n in names and p.grad is not None})
            return step(*a, **kw)

        self.optimizer.step = first_step

    Learner.prepare_optimizer = prepare_optimizer
    try:
        yield out
    finally:
        Learner.prepare_optimizer = prep


@contextlib.contextmanager
def checked_reorders(out):
    """Every beam reorder of the block through the row-gather kernel (the
    launch the count sees), then held bitwise against ``index_select`` on
    the same cache (not counted): ``out`` gets the reorders, the heads seen
    and the largest difference."""
    from vidsitu_tpu_torch.gen import beam
    from vidsitu_tpu_torch.ops import beam_gather as B

    plain = beam.gather_rows
    out.update(reorders=0, heads=set(), max_abs_err=0.0)

    def gather_rows(leaves, rows):
        got = plain(leaves, rows)
        ref = B.beam_gather_rows_reference(leaves, rows)
        out["reorders"] += 1
        out["heads"] |= {x.shape[1] for x in leaves if x.dim() == 4}
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            out["max_abs_err"] = max(out["max_abs_err"], max(
                (g.float() - r.float()).abs().max().item()
                for g, r in zip(got, ref)))
            out["max_abs_err"] = max(out["max_abs_err"], 1e-30)
        return got

    beam.gather_rows = gather_rows
    try:
        yield out
    finally:
        beam.gather_rows = plain
        out["heads"] = sorted(out["heads"])


def timed_learner_step(argv, dev):
    """The Learner step of ``argv`` (build_learner; dropout on) on its first
    batch: the median ms of TP_TIMED by CUDA events, and the device-busy
    share of one more step (``torch.profiler``: this process's kernels over
    its wall time)."""
    from vidsitu_tpu_torch import main as port_main
    from vidsitu_tpu_torch.bench import profile_step
    # a torchrun child has not run main(), which sets the module's timers
    from vidsitu_tpu_torch.timing import cuda_ms
    from vidsitu_tpu_torch.train.build import build_learner
    from vidsitu_tpu_torch.train.learner import batch_to_device
    from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

    uid, overrides, _ = port_main.parse_cli(argv)
    cfg = get_cfg_with_overrides(uid, **overrides)
    learner = build_learner(cfg, uid, dev)
    learner.prepare_optimizer(float(cfg.train.lr))
    batch = batch_to_device(next(iter(learner.data.train_dl)),
                            learner.device)

    def step():
        return learner.train_step(batch)

    ms = float(np.median(cuda_ms(step, TP_TIMED)))
    rows, wall = profile_step(step, learner.device)
    busy = sum(e.self_device_time_total for e in rows) / 1e6 / wall
    del learner, batch
    torch.cuda.empty_cache()
    return ms, busy


def child_tp(spec, dev):
    """Phase 32 on one rank of the model axis: the SRL fit through the
    entry point (its first update's split gradients held against one
    process's on rank 0), the one-step pair and its control, the evrel
    step, the timed bf16 step."""
    from vidsitu_tpu_torch import main as port_main
    from vidsitu_tpu_torch.ops import beam_gather as B
    from vidsitu_tpu_torch.parallel import collectives as C

    grads, reorders = {}, {}
    with recorded_step_losses() as losses, first_update_grads(grads), \
            checked_reorders(reorders):
        res = port_main.main(spec["main"])
    out = {"launches_main": B.LAUNCHES, "first_loss": losses[0],
           "steps": res["evaluator"].generate_fn.steps,
           "pred": str(res["pred_dir"] / "valid_0.pkl"), **reorders}
    del res
    torch.cuda.empty_cache()
    drop, ctl = {}, {}
    with first_update_grads(drop):
        out["drop_loss"] = drop_steps(spec["drop"], dev, 1)["losses"][0]
    with first_update_grads(ctl):
        out["local_masks_loss"] = drop_steps(spec["drop"], dev, 1,
                                             local_masks=True)["losses"][0]
    if C.get_rank() == 0:
        ref = torch.load(spec["ref_grads"], weights_only=True)
        for key, got in (("grad", grads), ("drop_grad", drop),
                         ("control_grad", ctl)):
            assert set(ref) == set(got), sorted(set(ref) ^ set(got))[:5]
            out[f"{key}_rel_err"], out[f"{key}_worst"] = split_grad_err(
                got, ref)
        out["grad_leaves"] = len(ref)
        del ref
    del grads, drop, ctl
    out["evrel_loss"] = drop_steps(spec["evrel"], dev, 1)["losses"][0]
    out["bf16_ms"], out["bf16_busy"] = timed_learner_step(spec["bf16"], dev)
    return out


def split_grad_err(got, ref):
    """The largest difference of the split leaves' gradients over the
    largest reference gradient (model-wide), and the three leaves that
    differ most, each with its difference and its own scale (both of the
    model-wide scale)."""
    scale = max(float(v.abs().max()) for v in ref.values())
    errs = {n: float((got[n] - ref[n]).abs().max()) / scale for n in ref}
    worst = sorted(errs, key=lambda n: -errs[n])[:3]
    return max(errs.values()), [
        (n, errs[n], float(ref[n].abs().max()) / scale) for n in worst]


def pkl_events(path):
    with open(path, "rb") as f:
        return {(p["ann_idx"], ev): out for p in pickle.load(f)
                for ev, out in p["vb_output"].items()}


def phase_tp(root, dev):
    """Phase 32: tensor parallelism on the card (see the module docstring):
    one process's runs here on ``dev``, then one torchrun launch of 2 gloo
    ranks on ``dev`` on a [1, 2] data x model mesh."""
    from vidsitu_tpu_torch import main as port_main
    from vidsitu_tpu_torch.data.synth import make_synth_dataset
    from vidsitu_tpu_torch.ops import beam_gather as B

    t0 = time.perf_counter()
    paths = make_synth_dataset(root / "data", n_train=TP_BS, n_valid=8,
                               n_test=1, seed=37)

    def srl(tag, *extra):
        return lang_train_args(
            f"chip_smoke_tp_{tag}", "vb_arg", "sfpret_txe_txd_vbarg", paths,
            root, "--train.dtype=float32", f"--train.bs={TP_BS}",
            f"--train.bsv={TP_BS}", "--train.epochs=1",
            "--run_final_val=False", "--gen.beam_size=5",
            "--tpu.ancestry_beam=False", *TP_RATES,
            f"--misc.tmp_path={root / tag}", f"--device={dev}", *extra)

    def evrel(tag):
        return lang_train_args(
            f"chip_smoke_tp_ev_{tag}", "evrel", "rob_evrel", paths, root,
            "--train.dtype=float32", f"--misc.tmp_path={root / tag}",
            f"--device={dev}")

    def tp(argv):
        return argv + [*TP_MESH, "--dist_backend=gloo"]

    grads, reorders = {}, {}
    B.LAUNCHES = 0
    with recorded_step_losses() as losses, first_update_grads(grads), \
            checked_reorders(reorders):
        res = port_main.main(srl("one"))
    one = {"first_loss": losses[0], "launches": B.LAUNCHES,
           "steps": res["evaluator"].generate_fn.steps,
           "pred": res["pred_dir"] / "valid_0.pkl", **reorders}
    torch.save(grads, root / "one_grads.pt")
    del grads, res
    torch.cuda.empty_cache()
    one["drop_loss"] = drop_steps(srl("one_drop"), dev, 1)["losses"][0]
    one["evrel_loss"] = drop_steps(evrel("one_ev"), dev, 1)["losses"][0]
    one["bf16_ms"], one["bf16_busy"] = timed_learner_step(
        srl("one_bf16", "--train.dtype=bfloat16"), dev)
    one_wall = time.perf_counter() - t0
    ranks, wall = torchrun("tp", TP_RANKS, {
        "device": str(dev), "backend": "gloo", "main": tp(srl("tp")),
        "drop": tp(srl("tp_drop")), "evrel": tp(evrel("tp_ev")),
        "bf16": tp(srl("tp_bf16", "--train.dtype=bfloat16")),
        "ref_grads": str(root / "one_grads.pt")}, root)
    r0 = ranks[0]

    def rel(key):
        return abs(r0[key] - one[key]) / abs(one[key])

    want, got = pkl_events(one["pred"]), pkl_events(r0["pred"])
    agree = sum(got.get(k) == v for k, v in want.items()) / len(want)
    ctl = abs(r0["local_masks_loss"] - one["drop_loss"]) / abs(
        one["drop_loss"])
    log(f"[32 tp] sfpret_txe_txd_vbarg d 1024 on a [1, 2] data x model mesh "
        f"(2 gloo ranks on cuda:0, 4 of 8 heads and 1024 of 2048 hidden "
        f"columns a rank), float32, dropout 0.1 at every site, {TP_BS} "
        f"videos: first-step loss {[r['first_loss'] for r in ranks]} against "
        f"one process's {one['first_loss']!r} (relative "
        f"{rel('first_loss'):.2e}, limit {DP_LOSS_RTOL:g}); "
        f"{r0['grad_leaves']} split leaves' gradients gathered whole: "
        f"{r0['grad_rel_err']:.3e} of the largest (limit {TP_GRAD_RTOL:g}; "
        f"leaves that differ most, difference and own scale of the largest: "
        f"{r0['grad_worst']}); the same on build_learner "
        f"{r0['drop_grad_rel_err']:.3e}, its control "
        f"{r0['control_grad_rel_err']:.3e} ({r0['control_grad_worst']})")
    log(f"[32 tp] validation at beam 5, reorder route: decode steps "
        f"{[r['steps'] for r in ranks]} (one process {one['steps']}), "
        f"row-gather launches by rank {[r['launches_main'] for r in ranks]}"
        f" on caches of {[r['heads'] for r in ranks]} heads (one process "
        f"{one['launches']} on {one['heads']}), every reorder against "
        f"index_select: max abs diff "
        f"{[r['max_abs_err'] for r in ranks]}; events equal to one "
        f"process's {agree:.4f} (limit {ROUTE_AGREEMENT:g})")
    log(f"[32 tp] one step on build_learner: loss {r0['drop_loss']!r} "
        f"against {one['drop_loss']!r} (relative {rel('drop_loss'):.2e}); "
        f"each rank drawing its own slice's mask (control) "
        f"{r0['local_masks_loss']!r} (relative {ctl:.2e}); rob_evrel "
        f"(12 heads, ffn 3072) {r0['evrel_loss']!r} against "
        f"{one['evrel_loss']!r} (relative {rel('evrel_loss'):.2e})")
    log(f"[32 tp] bf16 step of {TP_BS} videos (dropout on), median of "
        f"{TP_TIMED}: 2 TP ranks on one card {[r['bf16_ms'] for r in ranks]}"
        f" ms, device busy {[r['bf16_busy'] for r in ranks]} (each rank's "
        f"own kernels); one process {one['bf16_ms']:.2f} ms, busy "
        f"{one['bf16_busy']:.3f}; walls: one process {one_wall:.1f} s, "
        f"torchrun {wall:.1f} s")
    for key in ("first_loss", "drop_loss", "evrel_loss"):
        assert len({r[key] for r in ranks}) == 1, (key, ranks)
        assert rel(key) <= DP_LOSS_RTOL, (key, r0[key], one[key])
    assert ctl > DP_LOSS_RTOL, (r0["local_masks_loss"], one["drop_loss"])
    for key in ("grad_rel_err", "drop_grad_rel_err"):
        assert r0[key] <= TP_GRAD_RTOL < r0["control_grad_rel_err"], (
            key, r0[key], r0["control_grad_rel_err"])
    for r in ranks:
        assert r["steps"] == r0["steps"] and sum(r["steps"]) > 0
        assert r["launches_main"] == r["reorders"] == sum(r["steps"]), r
        assert r["heads"] == [HEADS // TP_RANKS], r["heads"]
        assert r["max_abs_err"] == 0.0, r["max_abs_err"]
    assert one["heads"] == [HEADS] and one["launches"] == sum(one["steps"])
    assert agree >= ROUTE_AGREEMENT, agree
    return {"launches": [r["launches_main"] for r in ranks],
            "max_abs_err": [r["max_abs_err"] for r in ranks],
            "checks": [r["checks"] for r in ranks],
            "first_loss_rel_err": rel("first_loss"),
            "grad_rel_err": r0["grad_rel_err"],
            "control_grad_rel_err": r0["control_grad_rel_err"],
            "step_loss_rel_err": rel("drop_loss"), "control_rel_err": ctl,
            "evrel_loss_rel_err": rel("evrel_loss"),
            "events_agree": agree,
            "bf16_ms": [r["bf16_ms"] for r in ranks],
            "bf16_busy": [r["bf16_busy"] for r in ranks],
            "one_bf16_ms": one["bf16_ms"], "one_bf16_busy": one["bf16_busy"],
            "wall_s": wall}


# phase 34: the dry run's subprocess (two torchrun launches, one process's
# references)
DRYRUN_TIMEOUT_S = 600
DRYRUN_RANKS = 2


def child_resize(spec, dev):
    """Phase 33's rank: ``build_learner`` on the spec's argv (phase 28's
    float32 fit), ``request_resize(1)``, ``fit``. Returns the step losses,
    the kernel launches of each epoch this rank trained (counted up to the
    end of the epoch's validation) and whether the rank left; on the rank
    that fits to the end, the tracker's epochs, the txt log's resize line
    and the epoch-2 checkpoint."""
    from vidsitu_tpu_torch import main as port_main
    from vidsitu_tpu_torch.ops import attention as A
    from vidsitu_tpu_torch.train.build import build_learner
    from vidsitu_tpu_torch.utils.config import get_cfg_with_overrides

    uid, overrides, _ = port_main.parse_cli(spec["argv"])
    cfg = get_cfg_with_overrides(uid, **overrides)
    cfg.freeze()
    learner = build_learner(cfg, uid, dev)
    learner.request_resize(1)
    counts, validate = [{}], learner.validate

    def validate_and_count(*a, **kw):
        res = validate(*a, **kw)
        counts.append(dict(A.LAUNCHES_BY_ENTRY))
        return res

    learner.validate = validate_and_count
    with recorded_step_losses() as losses:
        learner.fit(cfg.train.epochs, cfg.train.lr)
    out = {"step_losses": losses, "left": learner.left,
           "launches_by_epoch": [{k: v - before.get(k, 0)
                                  for k, v in after.items()}
                                 for before, after in zip(counts, counts[1:])]}
    if not learner.left:
        out.update(epochs=tracker_rows(cfg), world_after=learner.world_size,
                   ckpt=str(learner.model_epoch_dir / "mdl_ep_2.ckpt"),
                   resize_line=[ln for ln in learner.txt_log_file.read_text()
                                .splitlines() if "elastic resize" in ln])
    return out


def resize_launch(paths, root):
    """Phase 33's launch (run in phase 28, whose 2-rank run it is): phase
    28's I3D-NL R50 fit in float32 (``nl_attn_fwd`` / ``nl_attn_bwd``) on
    2 gloo ranks on cuda:0 through ``build_learner``, ``request_resize(1)``
    before ``fit``: both ranks fit epoch 1 and save it, rank 1 leaves, rank
    0 fits epoch 2 alone. Every rank's result and the launch's wall."""
    return torchrun("resize", DP_RANKS, {
        "device": "cuda:0", "backend": "gloo", "deterministic": True,
        "dtype": "float32", "argv": vb_train_args(
            paths, root, "--train.epochs=2", "--train.dtype=float32",
            "--run_final_val=False", f"--misc.tmp_path={root / 'tmp_rsz'}",
            "--device=cuda:0", "--dist_backend=gloo")}, root)


def phase_resize(straight, controls):
    """Phase 33: the mid-run resize on the card (``resize_launch``, run in
    phase 28: ``straight["resize"]``). Against phase 28's straight run
    (``straight``): the epoch-2 loss within ELASTIC_RTOL, the parameters
    and the statistics within ELASTIC_DRIFT of the epoch's update, and
    bitwise phase 28's checkpoint resume; phase 28's two wrong resumes
    (``controls``) outside every limit; 20 forward and 10 backward launches
    an epoch on each rank that trained it."""
    from vidsitu_tpu_torch.ops import attention as A

    fwd = A.kernel_entry(torch.float32, 256)
    bwd = A.bwd_kernel_entry(torch.float32, 256)
    steps, eval_batches = 2, -(-8 // VB_BS)
    per_epoch = (NL_BLOCKS * (steps + eval_batches), NL_BLOCKS * steps)
    res, wall = straight["resize"]
    r0 = res[0]
    launches = [[(e.get(fwd, 0), e.get(bwd, 0)) for e in r["launches_by_epoch"]]
                for r in res]
    loss2, want2 = r0["epochs"][-1]["trn_loss"], straight["want2"]
    rel_loss = abs(loss2 - want2) / abs(want2)
    sd = ckpt_leaves(r0["ckpt"])
    s_sd, s_sd1 = straight["s_sd"], straight["s_sd1"]
    rel = {p: drift(sd, s_sd, s_sd, s_sd1, p)[0] for p in ELASTIC_DRIFT}
    worst = drift(sd, s_sd, s_sd, s_sd1, "params")[1]
    # the same epoch 1, then epoch 2 on one rank under deterministic
    # algorithms: phase 28's checkpoint resume, here the in-memory move
    bitwise = all(torch.equal(sd[k], v)
                  for k, v in straight["resumed_sd"].items())
    log(f"[33 resize] I3D-NL R50 float32, 2 gloo ranks on cuda:0 resized to "
        f"1 after epoch 1 ({wall:.1f} s): {r0['resize_line']}; rank 1 left: "
        f"{res[1]['left']}; epoch-2 train loss {loss2!r} against the "
        f"straight run's {want2!r} (relative {rel_loss:.2e}, limit "
        f"{ELASTIC_RTOL:g}); step losses rank 0 {r0['step_losses']}, rank 1 "
        f"{res[1]['step_losses']}")
    log(f"[33 resize] parameters and statistics after epoch 2 against the "
        f"straight run, of its epoch-2 update: {rel} (limits "
        f"{ELASTIC_DRIFT}); largest parameter differences of the leaf's "
        f"largest value {worst}; bitwise phase 28's checkpoint resume: "
        f"{bitwise}; phase 28's wrong resumes {controls}")
    log(f"[33 resize] launches ({fwd}, {bwd}) by rank and epoch: {launches} "
        f"(want {per_epoch} an epoch, rank 1 epoch 1 only); kernel vs plain "
        f"{[r['checks'] for r in res]}")
    assert not r0["left"] and res[1]["left"] and r0["world_after"] == 1
    assert r0["resize_line"] == [
        "elastic resize at epoch 1: {'data': 2} -> {'data': 1}"], r0
    assert launches == [[per_epoch] * 2, [per_epoch]], launches
    assert rel_loss <= ELASTIC_RTOL, (loss2, want2)
    assert all(rel[p] <= lim for p, lim in ELASTIC_DRIFT.items()), rel
    limits = {**ELASTIC_DRIFT, "loss": ELASTIC_RTOL}
    assert all(c[p] > lim for c in controls.values()
               for p, lim in limits.items()), controls
    assert bitwise and r0["step_losses"][2:] == straight["resumed_losses"]
    return {"wall_s": wall, "launches": launches, "loss_rel_err": rel_loss,
            "drift": rel, "worst_leaf": worst[0],
            "bitwise_phase28_resume": bitwise}


def phase_dryrun(root):
    """Phase 34: ``python -m vidsitu_tpu_torch.dryrun --n 2 --device cuda``
    in a subprocess (the port's counterpart of ``__graft_entry__``'s
    ``dryrun_multichip``): 2 gloo ranks sharing cuda:0 against one process
    at the JAX entry's tiny sizes, every line printed and passing, rc 0,
    its receipt printed."""
    receipt = Path(root) / "MULTICHIP_torch.json"
    logf = Path(root) / "dryrun.log"
    cmd = [sys.executable, "-m", "vidsitu_tpu_torch.dryrun", "--n",
           str(DRYRUN_RANKS), "--device", "cuda", "--receipt", str(receipt)]
    t0 = time.perf_counter()
    with open(logf, "w") as f:
        rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                            cwd=str(REPO), timeout=DRYRUN_TIMEOUT_S).returncode
    wall = time.perf_counter() - t0
    text = logf.read_text(errors="replace")
    lines = [ln for ln in text.splitlines() if ln.startswith("dryrun")]
    for ln in lines:
        log(f"[34 dryrun] {ln}")
    run = (json.loads(receipt.read_text())["runs"][0] if receipt.is_file()
           else None)
    log(f"[34 dryrun] receipt {json.dumps(run)}; subprocess wall "
        f"{wall:.1f} s")
    if rc != 0 or run is None or not run["ok"]:
        log(text[-6000:])
        raise RuntimeError(f"dryrun: rc {rc} after {wall:.1f} s")
    assert len(lines) == 8 and lines[-1] == (
        f"dryrun_multichip({DRYRUN_RANKS}) OK: vb_arg+vb+evrel verified"), lines
    assert run["mesh"] == {"steps": {"data": 2}, "tp": {"data": 1, "model": 2},
                           "resume": {"data": 1}}, run["mesh"]
    assert run["device"] == torch.cuda.get_device_name(0), run
    return {"wall_s": wall, "lines": lines, "receipt": run}


# The dtype surface: phase 35
F16_CHECKS = ATTN_CHECKS + (("d24", 8, (70, 33, 24)),)
F16_OUT_TOL, F16_GRAD_TOL = 2e-2, 5e-2  # of the output's / gradient's scale
F16_SMALL_DO = 2.0 ** -14  # a training step's output gradients: small dS
PARAM_LOSS_RTOL = 1e-2  # bf16 parameters against float32 ones, one update
PARAM_VIDEOS = 16  # phase 18's update: 80 clips
PARAM_TIMED = 3  # timed updates of phase 35 (c)


def f16_kernel_checks(dev):
    """Phase 35 (a), checks: every float16 entry that takes the input (the
    routed one, and the WMMA entry forced where it is another) against the
    plain version and the tiled plain version, forward and backward, both
    kinds, at phase 2's shapes and d = 24, with output gradients of scale 1
    and F16_SMALL_DO. Returns the worst absolute error of each entry
    against the plain version, and of each backward entry the worst
    relative to each gradient's scale."""
    from vidsitu_tpu_torch.ops import attention as A

    rng = np.random.default_rng(35)
    worst = {e: 0.0 for e in A.ENTRIES + A.BWD_ENTRIES}
    worst_rel = {e: 0.0 for e in A.BWD_ENTRIES}

    def rel(a, b):
        return (a.float() - b.float()).abs().max().item() / max(
            b.float().abs().max().item(), 1e-30)

    for name, b, (sq, sk, d) in F16_CHECKS:
        q, k, v = seeded_qkv(rng, b, sq, sk, d, torch.float16, dev)
        scale = d ** -0.5
        fwd = dict.fromkeys((A.kernel_entry(torch.float16, d), V1_ENTRY))
        bwd = dict.fromkeys((A.bwd_kernel_entry(torch.float16, d),
                             BWD_V1_ENTRY))
        for kind in ("softmax", "dot_product"):
            ref = A.attention_reference(q, k, v, kind, scale)
            til = A.attention_tiled_reference(q, k, v, kind, scale,
                                              A.wgmma_block_k(d))
            errs = []
            for entry in fwd:
                out, lse = A.fused_attention(q, k, v, kind, scale,
                                             entry=entry, with_lse=True)
                torch.cuda.synchronize()
                e = max(rel(out, ref), rel(out, til) if entry != V1_ENTRY
                        else 0.0)
                assert out.dtype == torch.float16 and e <= F16_OUT_TOL, (
                    f"[35 float16] {entry} {name} {kind}: {e:.3e}")
                worst[entry] = max(worst[entry], (
                    out.float() - ref.float()).abs().max().item())
                errs.append(f"{entry} {e:.2e}")
            for do_scale in (1.0, F16_SMALL_DO):
                do = (seeded_qkv(rng, b, sq, sq, d, torch.float32, dev)[0]
                      * do_scale).half()
                want = A.attention_backward_reference(q, k, v, out, do, kind,
                                                      scale)
                for entry in bwd:
                    got = A.fused_attention_backward(
                        q, k, v, out, do, lse, kind, scale, entry=entry)
                    want_t = A.attention_backward_tiled_reference(
                        q, k, v, out, do, lse, kind, scale, entry=entry)
                    torch.cuda.synchronize()
                    e = max(max(rel(g, w), rel(g, t))
                            for g, w, t in zip(got, want, want_t))
                    assert all(g.dtype == torch.float16 for g in got) and (
                        e <= F16_GRAD_TOL), (
                        f"[35 float16] {entry} {name} {kind} dO x "
                        f"{do_scale:g}: {e:.3e}")
                    worst_rel[entry] = max(worst_rel[entry], e)
                    worst[entry] = max(worst[entry], *(
                        (g.float() - w.float()).abs().max().item()
                        for g, w in zip(got, want)))
                    errs.append(f"{entry} dO x {do_scale:g} {e:.2e}")
        log(f"[35 float16] {name} B={b} Sq={sq} Sk={sk} d={d}: error / scale "
            f"vs plain and tiled plain: {'; '.join(errs)} (limits "
            f"{F16_OUT_TOL:g} / {F16_GRAD_TOL:g}) ok")
    return worst, worst_rel


def f16_kernel_times(dev):
    """Phase 35 (a), times: the float16 entries at the s3 / s4 shapes (the
    forward at B = 32, the backward at B = 80), in turns with the WMMA entry
    forced, the plain version and the library's fused attention in
    float16 (its backward for the backward), with the bound of the work."""
    from vidsitu_tpu_torch.ops import attention as A

    rng = np.random.default_rng(135)
    out_t = {}
    for name, (sq, sk, d) in (("s3", S3), ("s4", S4)):
        scale = d ** -0.5
        q, k, v = seeded_qkv(rng, 32, sq, sk, d, torch.float16, dev)
        q4, k4, v4 = (t.unsqueeze(1) for t in (q, k, v))
        ms, v1_ms, plain_ms, lib_ms = medians_in_turns([
            lambda: A.fused_attention(q, k, v, "softmax", scale),
            lambda: A.fused_attention(q, k, v, "softmax", scale,
                                      entry=V1_ENTRY),
            lambda: A.attention_reference(q, k, v, "softmax", scale),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, scale=scale)], 20)
        moved = 2 * (2 * q.numel() + k.numel() + v.numel())
        fwd = dict(zip(("bound_ms", "bound_by"),
                       bound(moved, 4 * 32 * sq * sk * d)))
        fwd.update(ms=ms, v1_ms=v1_ms, plain_ms=plain_ms, library_ms=lib_ms)
        del q, k, v, q4, k4, v4
        b = 80
        q, k, v = seeded_qkv(rng, b, sq, sk, d, torch.float16, dev)
        out, lse = A.fused_attention(q, k, v, "softmax", scale, with_lse=True)
        do = torch.randn_like(out)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        plain_out = A.attention_reference(*leaves, "softmax", scale)
        l4 = [t.detach().unsqueeze(1).requires_grad_() for t in (q, k, v)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            *l4, scale=scale)
        bms, bv1_ms, bplain_ms, blib_ms = medians_in_turns([
            lambda: A.fused_attention_backward(q, k, v, out, do, lse,
                                               "softmax", scale),
            lambda: A.fused_attention_backward(q, k, v, out, do, lse,
                                               "softmax", scale,
                                               entry=BWD_V1_ENTRY),
            backward_ms(plain_out, leaves, do),
            backward_ms(lib_out, l4, do.unsqueeze(1))], 5)
        # q, k, v, o, dO read, dq, dk, dv written; the rows' lse read
        moved = 2 * (4 * q.numel() + 4 * k.numel()) + lse.numel() * 4
        bwd = dict(zip(("bound_ms", "bound_by"),
                       bound(moved, 5 * 2 * b * sq * sk * d)))
        bwd.update(ms=bms, v1_ms=bv1_ms, plain_ms=bplain_ms,
                   library_ms=blib_ms)
        out_t[name] = {"fwd": fwd, "bwd": bwd}
        log(f"[35 float16] time {name} float16 softmax: forward B=32 "
            f"{A.kernel_entry(torch.float16, d)} {ms:.4f} ms, {V1_ENTRY} "
            f"{v1_ms:.4f} ms, plain {plain_ms:.4f} ms, scaled_dot_product_"
            f"attention {lib_ms:.4f} ms, bound {fwd['bound_ms']:.4f} ms by "
            f"{fwd['bound_by']}; backward B={b} "
            f"{A.bwd_kernel_entry(torch.float16, d)} {bms:.4f} ms, "
            f"{BWD_V1_ENTRY} {bv1_ms:.4f} ms, autograd of the plain attention "
            f"{bplain_ms:.4f} ms, scaled_dot_product_attention backward "
            f"{blib_ms:.4f} ms, bound {bwd['bound_ms']:.4f} ms by "
            f"{bwd['bound_by']}")
        del q, k, v, out, lse, do, leaves, plain_out, l4, lib_out
        torch.cuda.empty_cache()
    return out_t


def f16_main_path(paths, root, state_dict, p18, dev):
    """Phase 35 (b): ``train.dtype=float16`` on the I3D-NL R50 through the
    entry points: ``extract_features`` on phase 3's split (2 dispatches of
    32 clips, 5 float16 forward launches each), the 32-clip features with
    the kernels against the plain attention, and one 80-clip update through
    ``Learner.train_step`` on phase 18's weights and batch (5 + 5 float16
    launches). Counts set to 0 just before each, read just after."""
    from vidsitu_tpu_torch.bench import make_vb_train
    from vidsitu_tpu_torch.convert.from_flax import (
        flax_to_state_dict,
        seeded_variables,
    )
    from vidsitu_tpu_torch.data.comm import build_comm
    from vidsitu_tpu_torch.data.loader import fold_frame_events, stack_collate
    from vidsitu_tpu_torch.extract import FramesOnlyDS, extract_features
    from vidsitu_tpu_torch.models.vb_models import build_feat_extractor
    from vidsitu_tpu_torch.ops import attention as A
    from vidsitu_tpu_torch.train.learner import Learner

    cfg = smoke_cfg(paths, root, "i3d_r50_nl_8x8")
    cfg.defrost()
    cfg.train.dtype = "float16"
    comm = build_comm(cfg)
    A.reset_launches()
    counts = extract_features(
        cfg, comm, state_dict=state_dict, splits=["valid"],
        out_dir=root / "feats16", batch_size=4, num_threads=8,
        clip_batch=32, device="cuda")
    extract = dict(A.LAUNCHES_BY_DTYPE["float16"])
    files = sorted((root / "feats16").glob("*_feats.npy"))
    arrs = [np.load(f) for f in files]
    assert counts == {"valid": 8} and len(files) == 8, counts
    assert all(a.shape == (5, 2048) and np.isfinite(a).all() for a in arrs)
    assert extract["nl_attn_fwd_wgmma"] == A.LAUNCHES == 2 * NL_BLOCKS, (
        extract, A.LAUNCHES_BY_DTYPE)

    ds = FramesOnlyDS(cfg, comm, "valid")
    batch = fold_frame_events(stack_collate([ds[i] for i in range(7)]))
    frames = torch.from_numpy(batch["frms_ev_fast_tensor"][:32]).to(dev)
    model = build_feat_extractor(cfg)
    model.load_state_dict(state_dict, strict=True)
    model.to(device=dev, memory_format=torch.channels_last_3d)
    blocks = nl_blocks(model).values()

    def run(attn):
        for m in blocks:
            m.attention = attn
        with torch.inference_mode():
            return model.clip_features({"frms_ev_fast_tensor": frames})

    A.reset_launches()
    feats_k = run(A.nonlocal_attention).float()
    fwd_launches = dict(A.LAUNCHES_BY_DTYPE["float16"])
    plain_before = A.LAUNCHES
    feats_p = run(A.attention_reference).float()
    torch.cuda.synchronize()
    assert A.LAUNCHES == plain_before, "the plain path launched a kernel"
    feat_scale = feats_p.abs().max().item()
    feat_err = (feats_k - feats_p).abs().max().item() / feat_scale
    ms_k, ms_p = medians_in_turns([lambda: run(A.nonlocal_attention),
                                   lambda: run(A.attention_reference)], 5)
    ok = (bool(torch.isfinite(feats_k).all()) and feat_err <= FEATURE_RTOL
          and fwd_launches["nl_attn_fwd_wgmma"] == NL_BLOCKS)
    log(f"[35 float16] extract_features at train.dtype=float16: {counts}, "
        f"launches {extract}; 32-clip features kernel vs plain "
        f"{feat_err:.3e} of the feature scale {feat_scale:.3e} (limit "
        f"{FEATURE_RTOL:g}), {NL_BLOCKS} launches a forward {fwd_launches}; "
        f"forward {ms_k:.2f} ms with the kernels, {ms_p:.2f} ms plain "
        f"{'ok' if ok else 'FAIL'}")
    assert ok
    del model, frames, feats_k, feats_p
    torch.cuda.empty_cache()

    model, _, vbatch, vcfg = make_vb_train(
        "i3d_r50_nl_8x8", PARAM_VIDEOS, dev,
        overrides={"train.dtype": "float16",
                   "misc.tmp_path": str(root / "tmp35")})
    model.load_state_dict(flax_to_state_dict(seeded_variables(model, 0)),
                          strict=True)
    learner = Learner("chip_smoke_f16", vcfg, model, None, None, dev)
    learner.prepare_optimizer(1e-4)
    A.reset_launches()
    loss = learner.train_step(vbatch).item()
    torch.cuda.synchronize()
    step_launches = dict(A.LAUNCHES_BY_DTYPE["float16"])
    want = {"nl_attn_fwd_wgmma": NL_BLOCKS, "nl_attn_bwd_wgmma": NL_BLOCKS}
    ok = (np.isfinite(loss) and A.LAUNCHES == 2 * NL_BLOCKS
          and all(step_launches[e] == n for e, n in want.items()))
    log(f"[35 float16] Learner.train_step at train.dtype=float16, "
        f"{5 * PARAM_VIDEOS} clips: loss {loss:.5f} (bf16, phase 18: "
        f"{p18['loss']:.5f}), launches {step_launches} "
        f"{'ok' if ok else 'FAIL'}")
    assert ok
    del model, learner, vbatch
    torch.cuda.empty_cache()
    return {"extract_launches": extract, "forward_launches": fwd_launches,
            "step_launches": step_launches, "feature_rel_err": feat_err,
            "forward_ms": ms_k, "forward_plain_ms": ms_p, "step_loss": loss}


def bf16_param_update(root, p18, dev):
    """Phase 35 (c): one I3D-NL R50 update at 80 clips with
    ``train.dtype=train.param_dtype=bfloat16`` through ``Learner.train_step``
    (Adam in optax's bf16 arithmetic) on phase 18's weights and batch: the
    loss against phase 18's float32-parameter loss, the bf16 kernel launches
    (5 + 5), the update's ms and peak memory against phase 18's, the
    parameters, Adam's moments and the statistics' dtypes."""
    from vidsitu_tpu_torch.bench import make_vb_train
    from vidsitu_tpu_torch.convert.from_flax import (
        flax_to_state_dict,
        seeded_variables,
    )
    from vidsitu_tpu_torch.ops import attention as A
    from vidsitu_tpu_torch.train.adam import HalfAdam
    from vidsitu_tpu_torch.train.learner import Learner

    model, _, batch, cfg = make_vb_train(
        "i3d_r50_nl_8x8", PARAM_VIDEOS, dev,
        overrides={"train.dtype": "bfloat16",
                   "train.param_dtype": "bfloat16",
                   "misc.tmp_path": str(root / "tmp35")})
    model.load_state_dict(flax_to_state_dict(seeded_variables(model, 0)),
                          strict=True)
    learner = Learner("chip_smoke_bf16_params", cfg, model, None, None, dev)
    learner.prepare_optimizer(1e-4)
    assert isinstance(learner.optimizer, HalfAdam)
    torch.cuda.reset_peak_memory_stats(dev)
    A.reset_launches()
    loss = learner.train_step(batch).item()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    launches = dict(A.LAUNCHES_BY_DTYPE["bfloat16"])
    total = A.LAUNCHES
    dtypes = {str(v.dtype).removeprefix("torch.")
              for n, v in model.state_dict().items()
              if v.is_floating_point() and "running" not in n}
    stats = {str(v.dtype).removeprefix("torch.")
             for n, v in model.state_dict().items() if "running" in n}
    moments = {str(st["exp_avg"].dtype).removeprefix("torch.")
               for st in learner.optimizer.state.values()}
    ms = float(np.median(cuda_ms(lambda: learner.train_step(batch),
                                 PARAM_TIMED)))
    rel = abs(loss - p18["loss"]) / abs(p18["loss"])
    want = {"nl_attn_fwd_wgmma": NL_BLOCKS, "nl_attn_bwd_wgmma": NL_BLOCKS}
    ok = (np.isfinite(loss) and rel <= PARAM_LOSS_RTOL
          and total == 2 * NL_BLOCKS
          and all(launches[e] == n for e, n in want.items())
          and dtypes == moments == {"bfloat16"} and stats == {"float32"})
    log(f"[35 bf16 params] i3d_r50_nl_8x8 update, {5 * PARAM_VIDEOS} clips, "
        f"bf16 parameters and Adam: loss {loss:.5f} vs float32 parameters "
        f"{p18['loss']:.5f} (phase 18; rel {rel:.2e}, limit "
        f"{PARAM_LOSS_RTOL:g}); launches {launches}; {ms:.1f} ms an update "
        f"(phase 18: {p18['ms']:.1f}), peak {peak:.2f} GiB (phase 18: "
        f"{p18['peak_gib']:.2f}); parameters {dtypes}, moments {moments}, "
        f"statistics {stats} {'ok' if ok else 'FAIL'}")
    assert ok
    del model, learner, batch
    torch.cuda.empty_cache()
    return {"loss": loss, "loss_f32_params": p18["loss"], "loss_rel": rel,
            "launches": launches, "ms": ms, "peak_gib": peak}


def bf16_param_srl(dev):
    """Phase 35 (d): ``sfpret_txe_txd_vbarg`` at d 1024 with bf16 parameters
    and Adam: one ``Learner.train_step`` of 16 videos, then a beam-5 decode
    of one eval batch on the reorder route, every reorder through the
    row-gather kernel held bitwise against ``index_select``; launches ==
    decode steps (count set to 0 just before the decode)."""
    from vidsitu_tpu_torch.bench import REAL_TX, make_lang_train
    from vidsitu_tpu_torch.data import build_comm
    from vidsitu_tpu_torch.ops import beam_gather as B
    from vidsitu_tpu_torch.train.adam import HalfAdam
    from vidsitu_tpu_torch.train.learner import Learner

    with tempfile.TemporaryDirectory(prefix="chip_smoke_p35_") as tmp:
        model, _, batch, cfg = make_lang_train(
            "vb_arg", "sfpret_txe_txd_vbarg", LANG_BS["vb_arg"], dev,
            Path(tmp), REAL_TX, {"train.dtype": "bfloat16",
                                 "train.param_dtype": "bfloat16"})
        learner = Learner("chip_smoke_srl_bf16", cfg, model, None, None, dev)
        learner.prepare_optimizer(1e-4)
        assert isinstance(learner.optimizer, HalfAdam)
        loss = learner.train_step(batch).item()
        dtypes = {p.dtype for p in model.parameters()}
        model.eval()
        comm = build_comm(cfg)
        gen = generator_for(model, cfg, comm)
        eval_batch = device_batch(cfg, dev)
        B.LAUNCHES = 0
        checked = {}
        with checked_reorders(checked):
            out, wall = timed_search(gen, eval_batch)
        launches = B.LAUNCHES
    ok = (np.isfinite(loss) and dtypes == {torch.bfloat16}
          and launches == out.steps == checked["reorders"] > 0
          and checked["max_abs_err"] == 0.0)
    log(f"[35 bf16 params] sfpret_txe_txd_vbarg d 1024, bf16 parameters: "
        f"train step loss {loss:.5f}; beam-5 decode on the reorder route "
        f"{out.steps} steps in {wall:.3f} s, row-gather launches {launches}, "
        f"{checked['reorders']} reorders bitwise equal to index_select "
        f"(max diff {checked['max_abs_err']:g}) {'ok' if ok else 'FAIL'}")
    assert ok
    return {"loss": loss, "launches": launches, "steps": out.steps}


def phase_dtypes(paths, root, state_dict, p18, dev):
    """Phase 35: the dtype surface: (a) the float16 kernels, (b)
    train.dtype=float16 through extraction and a train step, (c) the I3D-NL
    update with bf16 parameters, (d) the SRL model with bf16 parameters."""
    t0 = time.perf_counter()
    worst, worst_rel = f16_kernel_checks(dev)
    times = f16_kernel_times(dev)
    main = f16_main_path(paths, root, state_dict, p18, dev)
    update = bf16_param_update(root, p18, dev)
    srl = bf16_param_srl(dev)
    log(f"[35 dtypes] done in {time.perf_counter() - t0:.1f} s")
    return {"worst": worst, "worst_rel": worst_rel, "times": times,
            "main": main, "update": update, "srl": srl}


@contextlib.contextmanager
def deterministic_algorithms():
    """PyTorch's deterministic algorithms (cuDNN's among them, and the
    stem's two one-axis pools), warning where an op has none; cuBLAS's
    workspace set as they require; uninitialised memory left unfilled, as
    in every other run."""
    import os

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.utils.deterministic.fill_uninitialized_memory,
            os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0])
        torch.utils.deterministic.fill_uninitialized_memory = prev[1]
        if prev[2] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev[2]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (REPO / "vidsitu_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no vidsitu_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    global cuda_ms, kernel_rows, medians_in_turns
    from vidsitu_tpu_torch.timing import (
        cuda_ms,
        kernel_rows,
        medians_in_turns,
    )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase_build()
    attn_err, times = phase_kernel(dev)
    gather_err, gather_times = phase_gather_kernel(dev)
    fused_err, fused_timed, fused_plain_ms = phase_fused_kernel(dev)
    copy_res = phase_copy_probes(dev)

    from vidsitu_tpu_torch.data.synth import make_synth_dataset

    # the data of phases 3-10 and 17 stay until phases 24-25 have used them
    stack = contextlib.ExitStack()
    tmp = stack.enter_context(
        tempfile.TemporaryDirectory(prefix="chip_smoke_"))
    root = Path(tmp)
    t0 = time.perf_counter()
    paths = make_synth_dataset(root / "data", n_train=2, n_valid=8,
                               n_test=1, with_frames=True, frame_hw=224)
    log(f"[3 main] synthetic dataset (224 px JPEGs) in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = smoke_cfg(paths, root, "i3d_r50_nl_8x8")
    state_dict = seeded_state_dict(cfg)
    launches, by_entry = phase_main_path(cfg, state_dict, root / "feats")
    forward_ms = phase_paths_agree(cfg, state_dict, dev)
    sf_model, sf_inp = phase_default_cfg(paths, root, dev)
    # the SRL models read the feature width from the directory's name
    feats_dir = root / "i3d_nl_smoke_feats"
    feats_dir.symlink_to(root / "feats", target_is_directory=True)
    gather_launches, gen, srl_cfg, srl_preds = phase_srl_main(paths, root,
                                                              feats_dir)
    main_root, main_paths = root, paths
    phase_routes(gen, srl_cfg, dev)
    phase_srl_profile(gen, device_batch(srl_cfg, dev))
    phase_real_vocab(srl_cfg, dev)

    # this slice's main path: the fused block on the model's own blocks,
    # then the measuring entry point; counts set to 0 just before
    from vidsitu_tpu_torch.ops import beam_gather as B
    from vidsitu_tpu_torch.ops import copy_probe as CP
    from vidsitu_tpu_torch.ops import fused_bottleneck as FB

    FB.reset_launches()
    CP.reset_launches()
    B.LAUNCHES = 0
    model_err = phase_fused_in_model(sf_model, sf_inp, dev)
    del sf_model, sf_inp
    torch.cuda.empty_cache()
    gates_res, featext, decode = phase_bench(dev)
    slice_launches = {**FB.LAUNCHES_BY_ENTRY, **CP.LAUNCHES,
                      "beam_gather_rows": B.LAUNCHES}
    assert sum(FB.LAUNCHES.values()) == sum(FB.LAUNCHES_BY_ENTRY.values())
    log(f"[15 bench] kernel launches on this slice's path: {slice_launches}")
    assert all(n > 0 for n in slice_launches.values()), slice_launches

    bwd_err, bwd_rel_err, bwd_times = phase_backward_kernel(dev)
    tmp = stack.enter_context(
        tempfile.TemporaryDirectory(prefix="chip_smoke_vb_"))
    root = Path(tmp)
    t0 = time.perf_counter()
    paths = make_synth_dataset(root / "data", n_train=2 * VB_BS,
                               n_valid=8, n_test=1, with_frames=True,
                               frame_hw=224, seed=17)
    log(f"[17 train] synthetic dataset (224 px JPEGs) in "
        f"{time.perf_counter() - t0:.1f} s")
    train_launches, train_wall, p17 = phase_vb_train_main(paths, root)
    vb_root, vb_paths = root, paths
    step_res = phase_train_step(dev)
    bench_train = phase_bench_train(dev)
    # the dtype surface: each run's counts set to 0 just before it
    dtypes = phase_dtypes(main_paths, main_root, state_dict, step_res, dev)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_lang_") as tmp:
        root = Path(tmp)
        paths = make_synth_dataset(root / "data", n_train=32, n_valid=8,
                                   n_test=1, seed=29)
        srl_train_launches, srl_train_wall = phase_srl_train_main(paths, root)
        srl_step = step_check("21", "vb_arg", "sfpret_txe_txd_vbarg",
                              LANG_BS["vb_arg"], dev)
        evrel_walls = phase_evrel_main(paths, root)
    evrel_steps = {mdl: step_check("22", "evrel", mdl, LANG_BS["evrel"], dev,
                                   extra={})
                   for mdl in ("rob_evrel", "sfpret_evrel")}
    bench_lang = phase_bench_lang(dev)

    # several processes: each rank's counts set to 0 just before its entry
    # point, read just after (dist_child)
    torch.cuda.empty_cache()
    with stack:
        dp1, dp1_wall = phase_dp_fit_one_rank(vb_paths, vb_root / "dp1", p17)
        dp2 = phase_dp_two_ranks(vb_paths, vb_root, main_paths, main_root,
                                 feats_dir, p17, srl_preds)
        # the release surfaces; then a resize, each run's counts set to 0
        # just before its entry point (dist_child; in process:
        # phase_elastic)
        torch.cuda.empty_cache()
        fit_cli = phase_fit_cli(vb_root)
        release = phase_release_full_width(vb_paths, vb_root)
        straight = {}
        elastic = phase_elastic(vb_paths, vb_root, p17, keep=straight)
        # sharded training: each run's counts set to 0 just before its
        # entry point (dist_child; phase 30: just before its first update)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_drop_") as tmp:
            dropout = phase_dropout_ranks(Path(tmp))
        fsdp = phase_fsdp_update(vb_paths, vb_root)
        fsdp_orbax = phase_fsdp_orbax(vb_paths, vb_root, straight)
        # tensor parallelism: each rank's counts set to 0 just before its
        # entry point (dist_child); the launches are those of its main.py run
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
            tp = phase_tp(Path(tmp), dev)
        # the mid-run resize: each rank's counts set to 0 just before its
        # build_learner and fit (dist_child)
        torch.cuda.empty_cache()
        resize = phase_resize(straight, elastic["controls"])
        del straight
    # the dry run: no kernel of the port lies on its path (SlowFast, and
    # decoding on the ancestry route, as the JAX entry's)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dry_") as tmp:
        dry = phase_dryrun(Path(tmp))

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax"))
    assert not leaked, f"jax was imported: {leaked[:5]}"
    def kernel_row(name, source, replaces, n_launches, err, ms, plain_ms,
                   bound_ms, bound_by, library_ms, **more):
        return {"name": name, "route": "cuda",
                "source": f"vidsitu_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, **more}

    s3, s4 = times["s3"], times["s4"]
    fwd_entry = s3["entry"]
    fsdp_fwd, fsdp_bwd = bf16_update_entries()
    bwd_entry = bwd_times["s3"]["entry"]

    def by_rank(res, entry):
        """Each rank's launches of ``entry`` and its kernel-vs-plain
        errors, in rank order."""
        return ([r["launches"].get(entry, 0) for r in res],
                [max((e for k, e in r["checks"].items()
                      if k.startswith(entry + " ")), default=None)
                 for r in res])

    dp_runs = {"fit_1rank": dp1, "fit_2rank": dp2["fit"],
               "srl_2rank": dp2["srl"], "extract_2rank": dp2["extract"]}
    dp_walls = {"fit_1rank": dp1_wall, **{
        f"{k}_2rank": v for k, v in dp2["walls"].items()}}
    dp = {e: {k: by_rank(res, e) for k, res in dp_runs.items()
              if any(by_rank(res, e)[0])}
          for e in (fwd_entry, bwd_entry, "beam_gather_rows")}
    # fused bottleneck at the gate's 256 frames of 56x56, 256/64/256, bf16
    fb256, fb960 = fused_timed["256"], fused_timed["960"]
    fb_others = fused_timed["others"]
    for fb in (fb256, fb960):  # the multi wrapper: the better of 2 / 4 frames
        fb["multi_ms"] = min(fb["multi2_ms"], fb["multi4_ms"])
        fb["multi_v1_ms"] = min(fb["multi2_v1_ms"], fb["multi4_v1_ms"])
    fb_ops = 2 * 56 * 56 * (256 * 64 + 9 * 64 * 64 + 64 * 256)
    fb_bound = bound(fb256["least_bytes"], 256 * fb_ops)
    fb_bound960 = bound(fb960["least_bytes"], 960 * fb_ops)
    copy_bytes = 2 * 6144 * 65536 * 2
    copy_ms = {k: copy_bytes / 1e6 / v for k, v in (
        ("staged", max(copy_res["staged_gbps"].values())),
        ("pipelined", copy_res["pipelined_gbps"]),
        ("direct", copy_res["direct_gbps"]),
        ("clone", copy_res["clone_gbps"]))}
    copy_bound = bound(copy_bytes, 0)
    log(json.dumps({"kernels": [
        kernel_row(s3["entry"], "nonlocal_attn.cu",
                   "vidsitu_tpu/ops/attention.py:61", launches,
                   attn_err[s3["entry"]], s3["ms"], s3["plain_ms"],
                   s3["bound_ms"], s3["bound_by"], s3["library_ms"],
                   ms_s4=s4["ms"], plain_ms_s4=s4["plain_ms"],
                   library_ms_s4=s4["library_ms"], bound_ms_s4=s4["bound_ms"],
                   ms_v1=s3["v1_ms"], ms_v1_s4=s4["v1_ms"],
                   max_abs_err_v1=attn_err[V1_ENTRY],
                   dot_product_ms=s3["dot_product_ms"],
                   five_clips_ms=s3["five_clips_ms"],
                   launches_by_entry=by_entry, forward_ms=forward_ms,
                   launches_dp={k: v[0] for k, v in dp[fwd_entry].items()},
                   max_abs_err_dp={k: v[1] for k, v in
                                   dp[fwd_entry].items()},
                   dp_walls_s=dp_walls,
                   launches_elastic={k: [n for n, _ in v] for k, v in
                                     elastic["launches"].items()},
                   elastic=elastic, fit_cli_wall_s=fit_cli["wall_s"],
                   release_steps={k: {m: v[m] for m in ("loss", "ms",
                                                        "peak_gib")}
                                  for k, v in release["steps"].items()},
                   launches_fsdp={"update_1rank": fsdp["fsdp_launches"].get(
                       fsdp_fwd, 0), "orbax_fit": [
                       n for n, _ in fsdp_orbax["launches"].values()]},
                   fsdp_update=fsdp, fsdp_orbax=fsdp_orbax,
                   dropout_ranks=dropout,
                   launches_resize=[[n for n, _ in r]
                                    for r in resize["launches"]],
                   resize=resize, dryrun_wall_s=dry["wall_s"]),
        kernel_row("beam_gather_rows", "beam_gather.cu",
                   "benchmarks/probe_beam_gather.py:62", gather_launches,
                   gather_err, gather_times[0], gather_times[1],
                   gather_times[2], gather_times[3], gather_times[1],
                   launches_slice=slice_launches["beam_gather_rows"],
                   launches_srl_train=srl_train_launches,
                   srl_train_main_wall_s=srl_train_wall,
                   srl_train_step=srl_step, evrel_train_step=evrel_steps,
                   evrel_train_main_wall_s=evrel_walls,
                   bench_lang_train={r["metric"]: r["value"]
                                     for r in bench_lang},
                   launches_dp={k: v[0] for k, v in
                                dp["beam_gather_rows"].items()},
                   max_abs_err_dp={k: v[1] for k, v in
                                   dp["beam_gather_rows"].items()},
                   launches_tp=tp["launches"],
                   max_abs_err_tp=tp["max_abs_err"], tensor_parallel=tp,
                   launches_bf16_params=dtypes["srl"]["launches"]),
        *(kernel_row(
            entry, "fused_bottleneck.cu", replaces, slice_launches[entry],
            fused_err[entry], fb256[key], fused_plain_ms, *fb_bound,
            fb256["unfused_ms"], ms_960=fb960[key],
            library_ms_960=fb960["unfused_ms"], bound_ms_960=fb_bound960[0],
            folded_library_ms=fb256["folded_library_ms"],
            folded_library_ms_960=fb960["folded_library_ms"], **more)
          for entry, replaces, key, more in (
              ("fused_bottleneck_frames_wgmma", FB_FRAMES_TPU, "frames_ms",
               dict(queued_ms=fb256["frames_queued_ms"],
                    queued_ms_960=fb960["frames_queued_ms"],
                    folded_library_queued_ms=fb256["folded_library_queued_ms"],
                    folded_library_queued_ms_960=fb960[
                        "folded_library_queued_ms"],
                    model_rel_err=model_err)),
              ("fused_bottleneck_multi_wgmma", FB_MULTI_TPU, "multi_ms",
               dict(queued_ms=fb256["multi4_queued_ms"],
                    queued_ms_960=fb960["multi4_queued_ms"])),
              ("fused_bottleneck_frames", FB_FRAMES_TPU, "frames_v1_ms",
               dict(model_rel_err=model_err,
                    ms_s2_proj=fb_others["slow-s2 proj"]["ms"],
                    bound_ms_s2_proj=fb_others["slow-s2 proj"]["bound_ms"],
                    ms_s3=fb_others["slow-s3"]["ms"],
                    bound_ms_s3=fb_others["slow-s3"]["bound_ms"])),
              ("fused_bottleneck_multi", FB_MULTI_TPU, "multi_v1_ms", {}))),
        kernel_row(bwd_entry, "nonlocal_attn.cu", BWD_TPU,
                   train_launches[bwd_entry], bwd_err[bwd_entry],
                   bwd_times["s3"]["ms"], bwd_times["s3"]["plain_ms"],
                   bwd_times["s3"]["bound_ms"], bwd_times["s3"]["bound_by"],
                   bwd_times["s3"]["library_ms"],
                   replaces_note="no TPU kernel: jax.grad of _einsum_attention",
                   max_rel_err=bwd_rel_err[bwd_entry],
                   ms_v1=bwd_times["s3"]["v1_ms"],
                   ms_v1_s4=bwd_times["s4"]["v1_ms"],
                   max_abs_err_v1=bwd_err[BWD_V1_ENTRY],
                   max_rel_err_v1=bwd_rel_err[BWD_V1_ENTRY],
                   launches_by_entry={e: train_launches[e]
                                      for e in bwd_err},
                   ms_s4=bwd_times["s4"]["ms"],
                   plain_ms_s4=bwd_times["s4"]["plain_ms"],
                   library_ms_s4=bwd_times["s4"]["library_ms"],
                   bound_ms_s4=bwd_times["s4"]["bound_ms"],
                   bound_by_s4=bwd_times["s4"]["bound_by"],
                   library_backend=bwd_times["s3"]["library_backend"],
                   library_backend_s4=bwd_times["s4"]["library_backend"],
                   launches_forward_in_training=train_launches[
                       fwd_entry],
                   train_step=step_res, train_main_wall_s=train_wall,
                   bench_vbtrain=[r["value"] for r in bench_train],
                   launches_dp={k: v[0] for k, v in dp[bwd_entry].items()},
                   max_abs_err_dp={k: v[1] for k, v in
                                   dp[bwd_entry].items()},
                   launches_elastic={k: [n for _, n in v] for k, v in
                                     elastic["launches"].items()},
                   launches_fsdp={"update_1rank": fsdp["fsdp_launches"].get(
                       fsdp_bwd, 0), "orbax_fit": [
                       n for _, n in fsdp_orbax["launches"].values()]},
                   launches_resize=[[n for _, n in r]
                                    for r in resize["launches"]]),
        *(kernel_row(
            f"{entry} (float16)", "nonlocal_attn.cu", replaces, n_launches,
            dtypes["worst"][entry], t["ms"], t["plain_ms"], t["bound_ms"],
            t["bound_by"], t["library_ms"], ms_v1=t["v1_ms"],
            max_err_v1=dtypes["worst"][v1], ms_s4=t4["ms"],
            plain_ms_s4=t4["plain_ms"], bound_ms_s4=t4["bound_ms"],
            library_ms_s4=t4["library_ms"], ms_v1_s4=t4["v1_ms"], **more)
          for entry, v1, replaces, n_launches, t, t4, more in (
              ("nl_attn_fwd_wgmma", V1_ENTRY,
               "vidsitu_tpu/ops/attention.py:61",
               dtypes["main"]["extract_launches"]["nl_attn_fwd_wgmma"],
               dtypes["times"]["s3"]["fwd"], dtypes["times"]["s4"]["fwd"],
               dict(launches_forward=dtypes["main"]["forward_launches"],
                    launches_train_step=dtypes["main"]["step_launches"],
                    feature_rel_err=dtypes["main"]["feature_rel_err"],
                    forward_ms=dtypes["main"]["forward_ms"],
                    forward_plain_ms=dtypes["main"]["forward_plain_ms"])),
              ("nl_attn_bwd_wgmma", BWD_V1_ENTRY, BWD_TPU,
               dtypes["main"]["step_launches"]["nl_attn_bwd_wgmma"],
               dtypes["times"]["s3"]["bwd"], dtypes["times"]["s4"]["bwd"],
               dict(max_rel_err=dtypes["worst_rel"]["nl_attn_bwd_wgmma"],
                    max_rel_err_v1=dtypes["worst_rel"][BWD_V1_ENTRY],
                    train_step_loss=dtypes["main"]["step_loss"],
                    bf16_param_update=dtypes["update"],
                    bf16_param_srl=dtypes["srl"])))),
        kernel_row("staged_copy", "copy_probe.cu", "benchmarks/gates.py:86",
                   slice_launches["staged_copy"], 0.0, copy_ms["staged"],
                   copy_ms["clone"], *copy_bound, copy_ms["clone"]),
        kernel_row("pipelined_copy", "copy_probe.cu",
                   "benchmarks/micro3.py:130",
                   slice_launches["pipelined_copy"], 0.0,
                   copy_ms["pipelined"], copy_ms["clone"], *copy_bound,
                   copy_ms["clone"]),
        kernel_row("direct_copy", "copy_probe.cu", "benchmarks/micro3.py:158",
                   slice_launches["direct_copy"], 0.0, copy_ms["direct"],
                   copy_ms["clone"], *copy_bound, copy_ms["clone"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-child"]:
        sys.exit(dist_child(sys.argv[2], sys.argv[3]))
    sys.exit(main())
