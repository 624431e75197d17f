"""Entry points of the port for an outside check: a forward and a dry run on
several ranks (the counterpart of the root ``__graft_entry__.py``, which
stays the JAX package's).

``entry(device)`` returns ``(fn, example_args)``: the forward loss of the
flagship ``vb_arg`` model ``sfpret_txe_txd_vbarg`` at the JAX entry's tiny
widths, on ``device``, over the port's synthetic data.

``dryrun_multichip(n, device)`` launches ``n`` ranks with ``torchrun`` and
asserts, with the JAX entry's limits, that they compute what one process
computes:

  * one train step (dropout on: every rank draws the global batch's masks)
    of each of the three tasks (``vb_arg`` ``sfpret_txe_txd_vbarg``, ``vb``
    ``sf_base`` with its BatchNorm statistics, ``evrel`` ``sfpret_evrel``):
    the loss within 1e-3, the pre-Adam gradients within atol 5e-4 / rtol
    5e-2 with a mean error under 5e-5, the parameters within atol 2e-3 /
    rtol 1e-4 with a mean error under 1e-4, the statistics within atol
    3e-4 / rtol 1e-4;
  * the flagship's step with tensor parallelism (a ``model`` axis);
  * the SRL beam decode (beam 3, segmented, ancestry) by data shard,
    tokens exact;
  * the feature extractor by rank (``clip_batch`` 6, ``batch_size`` 3),
    features within 2e-5;
  * a checkpoint saved after 2 steps on the ``n`` ranks, resumed on
    ``n // 2`` (one process, without a group, when that is 1) for 2 more:
    the loss within 1e-4 and the parameters within atol 3e-4 of 4 straight
    steps there.

The ranks use NCCL where each has its own card, gloo where they share one
card (``device="cuda:0"``, or more ranks than cards) and on the CPU. The
mesh of the task steps is ``data`` x ``fsdp`` ``[2, n/2]`` for even ``n``
(``data`` ``[n]`` for odd), and the tensor-parallel step's ``data`` x
``model`` x ``fsdp`` ``[2, 2, n/4]`` where 4 divides ``n``; with ranks that
share a card through gloo, FSDP2 cannot run (gloo carries no PREMUL_SUM
for CUDA tensors), so there the steps take ``data`` ``[n]`` and the
tensor-parallel step ``data`` x ``model`` ``[n/2, 2]``. Each printed line
names the mesh it ran::

    python -m vidsitu_tpu_torch.dryrun --n 2 --device cuda
    python -m vidsitu_tpu_torch.dryrun --n 4 --device cpu

The command writes its receipt to ``MULTICHIP_torch.json`` beside the
package (``--receipt``): one entry per device type, with the JAX receipt's
keys (``n_devices``, ``rc``, ``ok``, ``skipped``, ``tail``) and ``device``,
``mesh`` and the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
RECEIPT = REPO / "MULTICHIP_torch.json"
LAUNCH_TIMEOUT_S = 900

# the JAX entry's tiny widths (__graft_entry__.py:24-53)
_TINY_TX = {
    "tx_dec.decoder_embed_dim": 128,
    "tx_dec.decoder_ffn_embed_dim": 256,
    "tx_dec.decoder_layers": 2,
    "tx_dec.decoder_attention_heads": 4,
    "tx_dec.encoder_embed_dim": 128,
    "tx_dec.encoder_ffn_embed_dim": 256,
    "tx_dec.encoder_layers": 2,
    "tx_dec.encoder_attention_heads": 4,
}
_TINY_VID = {
    "vid_mdl.resnet.depth": 26,
    "vid_mdl.crop_size": 32,
    "vid_mdl.num_frames": 4,
    "vid_mdl.sampling_rate": 2,
}
_TINY_ROB = {
    "rob_mdl.d_model": 64,
    "rob_mdl.n_layers": 2,
    "rob_mdl.n_heads": 4,
    "rob_mdl.ffn_dim": 128,
    "rob_mdl.max_pos": 130,
}
# (task_type, mdl_name, extra cfg, needs_frames), __graft_entry__.py:57-61
_DRYRUN_TASKS = [
    ("vb_arg", "sfpret_txe_txd_vbarg", _TINY_TX, False),
    ("vb", "sf_base", _TINY_VID, True),
    ("evrel", "sfpret_evrel", _TINY_ROB, False),
]
_DECODE = {"gen.beam_size": 3, "gen.max_len_b": 20,
           "tpu.seg_decode_min": 8, "tpu.ancestry_beam": True}
LR = 1e-3


def _synth(root: Path, with_frames: bool) -> Dict[str, str]:
    from .data.synth import make_synth_dataset

    return make_synth_dataset(root / ("frames" if with_frames else "feats"),
                              n_train=8, n_valid=5, seed=0,
                              with_frames=with_frames)


def _cfg(paths, root, task_type, mdl_name, extra, bs, **more):
    from .utils.config import get_cfg_with_overrides

    return get_cfg_with_overrides("dryrun", **{
        **paths, **extra, "task_type": task_type, "mdl.mdl_name": mdl_name,
        "train.bs": bs, "train.bsv": bs, "train.nw": 0, "train.nwv": 0,
        "train.dtype": "float32", "misc.tmp_path": str(root / "tmp"),
        **more})


def _model(cfg, comm, seed: int = 0):
    from .models.selector import build_model, init_model_variables

    return init_model_variables(build_model(cfg, comm), seed)


def entry(device="cuda"):
    """``(fn, example_args)``: ``fn(model, batch)`` is the flagship
    ``sfpret_txe_txd_vbarg``'s loss (eval mode) at the JAX entry's widths;
    ``example_args`` its seeded model and a batch of 2 videos of the port's
    synthetic data, on ``device``."""
    from .data import get_data
    from .extract import resolve_device
    from .train.learner import batch_to_device

    dev = resolve_device(device)
    root = Path(tempfile.mkdtemp(prefix="vidsitu_entry_"))
    cfg = _cfg(_synth(root, False), root, "vb_arg", "sfpret_txe_txd_vbarg",
               _TINY_TX, 2)
    data = get_data(cfg)
    model = _model(cfg, data.train_dl.dataset.comm).to(dev).eval()
    batch = batch_to_device(next(iter(data.train_dl)), dev)

    def fwd(model, batch):
        return model(batch)["loss"]

    return fwd, (model, batch)


# -- the ranks' work and one process's ------------------------------------

def _plan(n: int, device) -> Dict:
    """Each rank's device, the backend, and the meshes (shape, axis names)
    of the task steps, the tensor-parallel step and the elastic resume."""
    dev = torch.device(device)
    shared = False
    if dev.type == "cpu":
        rank_device, backend = "cpu", "gloo"
    elif dev.index is None and n <= torch.cuda.device_count():
        rank_device, backend = "cuda", "nccl"
    else:
        rank_device, backend, shared = f"cuda:{dev.index or 0}", "gloo", True
    if shared or n % 2:
        dp = ([n], ["data"])
    else:
        dp = ([2, n // 2], ["data", "fsdp"])
    if shared:
        tp = ([n // 2, 2], ["data", "model"]) if n % 2 == 0 else None
    else:
        tp = ([2, 2, n // 4], ["data", "model", "fsdp"]) if n % 4 == 0 \
            else None
    return {"device": rank_device, "backend": backend,
            "shared": shared, "dp": dp, "tp": tp,
            "small": ([max(n // 2, 1)], ["data"])}


def _mesh_over(shape, names) -> Dict[str, str]:
    return {"tpu.mesh_shape": str(list(shape)),
            "tpu.mesh_axis_names": str(list(names))}


def _mesh_dict(mesh) -> Dict[str, int]:
    shape, names = mesh
    return dict(zip(names, shape))


def one_step(cfg, model, batch, dev, mesh=None) -> Dict:
    """One ``Learner.train_step`` (Adam(0.9, 0.99), dropout on) of ``model``
    (whole) on this rank's rows of the global batch, placed on ``mesh`` as
    ``build_learner`` places it (the whole batch on one process, no mesh):
    the global loss, the gradients the update used, the state dict after
    it, all whole, on the CPU (the JAX entry's ``_one_step``)."""
    from .data.loader import fold_frame_events
    from .train.build import place_model
    from .train.learner import Learner, batch_to_device

    model, eval_model = place_model(model, cfg, mesh, dev)
    learner = Learner("dryrun", cfg, model, None, None, dev,
                      eval_model=eval_model, mesh=mesh)
    learner.prepare_optimizer(LR)
    grads: Dict[str, torch.Tensor] = {}
    step = learner.optimizer.step

    def keep_grads_then_step():
        grads.update({n: learner._whole(
            n, torch.zeros_like(p) if p.grad is None else p.grad, True)
            for n, p in zip(learner._param_names, learner._params)})
        step()

    learner.optimizer.step = keep_grads_then_step
    loss = float(learner.train_step(
        batch_to_device(fold_frame_events(batch), dev)))
    state = {k: learner._whole(k, v, True).clone()
             for k, v in learner.model.state_dict().items()}
    return {"loss": loss, "grads": grads, "state": state}


def _decode(cfg, comm, batch, dev, mesh=None) -> torch.Tensor:
    """The SRL beam decode of this rank's rows by a seeded model (the
    evaluation copy on ``mesh``, whole on an fsdp axis)."""
    from .models.selector import build_srl_generate_fn
    from .train.build import place_model
    from .train.learner import batch_to_device

    _, eval_model = place_model(_model(cfg, comm), cfg, mesh, dev)
    eval_model.eval()
    with torch.no_grad():
        out = build_srl_generate_fn(cfg, comm, eval_model)(
            batch_to_device(batch, dev))
    return out.cpu()


def _extract(cfg, comm, out_dir, dev, batch_size, clip_batch) -> int:
    from .extract import extract_features

    return extract_features(cfg, comm, splits=["valid"], out_dir=out_dir,
                            batch_size=batch_size, clip_batch=clip_batch,
                            device=dev)["valid"]


def _elastic_learner(paths, root, uid, mesh, dev):
    """The JAX entry's elastic Learner (``tx_only``, dropout 0, a global
    batch of 8) on ``mesh``, this rank's loader shard."""
    from .data import get_data
    from .parallel.collectives import data_rank, data_world_size, is_dist
    from .parallel.mesh import make_mesh
    from .train.build import place_model
    from .train.learner import Learner

    cfg = _cfg(paths, root, "vb_arg", "tx_only",
               {**_TINY_TX, "tx_dec.dropout": 0.0}, 8, **_mesh_over(*mesh))
    dmesh = make_mesh(cfg, dev.type) if is_dist() else None
    data = get_data(cfg, num_shards=data_world_size(), shard_id=data_rank())
    model, eval_model = place_model(
        _model(cfg, data.train_dl.dataset.comm, 7), cfg, dmesh, dev)
    return Learner(uid, cfg, model, data, None, dev, eval_model=eval_model,
                   mesh=dmesh)


def _resume(root: Path, plan: Dict, dev) -> Dict:
    """The elastic checkpoint resumed on ``plan["small"]`` for 2 steps, and
    4 straight steps there: the losses and the state dicts (whole)."""
    paths = _synth_paths(root, False)
    lb = _elastic_learner(paths, root, "el_b", plan["small"], dev)
    lb.load_model_dict(str(root / "elastic.ckpt"), load_opt=True)
    loss_b = lb.overfit_batch(2, LR)
    lc = _elastic_learner(paths, root, "el_c", plan["small"], dev)
    loss_c = lc.overfit_batch(4, LR)
    return {"loss_b": loss_b, "loss_c": loss_c} | {
        f"state_{tag}": {k: learner._whole(k, v, True).clone()
                         for k, v in learner.model.state_dict().items()}
        for tag, learner in (("b", lb), ("c", lc))}


@contextlib.contextmanager
def _float32_exact():
    """No TF32 in cuBLAS or cuDNN: the steps are compared in float32."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _child(spec_path: str) -> int:
    """One rank of a launch: the phase ``spec["phase"]`` (``steps``: the
    tasks' steps, the tensor-parallel step, the decode, the extraction and
    the elastic save on ``n`` ranks; ``resume``: the elastic resume and the
    straight run on ``n // 2``), written to ``{out}/rank{r}.pt``."""
    from .data import build_comm, get_data
    from .parallel import collectives as C
    from .parallel.mesh import init_distributed, make_mesh

    spec = json.loads(Path(spec_path).read_text())
    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    dev = init_distributed(spec["device"], spec["backend"])
    root, plan = Path(spec["root"]), spec["plan"]
    out: Dict = {}
    with _float32_exact():
        if spec["phase"] == "steps":
            for task, mdl, extra, frames in _DRYRUN_TASKS:
                paths = _synth_paths(root, frames)
                meshes = {"dp": plan["dp"]}
                if task == "vb_arg" and plan["tp"]:
                    meshes["tp"] = plan["tp"]
                for tag, mesh in meshes.items():
                    cfg = _cfg(paths, root, task, mdl, extra, spec["bs"],
                               **_mesh_over(*mesh), **_DECODE)
                    # the mesh first: it sets the data group, the shards
                    dmesh = make_mesh(cfg, dev.type)
                    data = get_data(cfg, num_shards=C.data_world_size(),
                                    shard_id=C.data_rank())
                    comm = data.train_dl.dataset.comm
                    batch = next(iter(data.train_dl))
                    out[f"{task}_{tag}"] = one_step(
                        cfg, _model(cfg, comm), batch, dev, dmesh)
                    if task == "vb_arg" and tag == "dp":
                        out["decode"] = _decode(cfg, comm, batch, dev, dmesh)
            paths = _synth_paths(root, True)
            cfg = _cfg(paths, root, "vb", "sf_base", _TINY_VID, 4)
            out["extract"] = _extract(cfg, build_comm(cfg),
                                      root / "ext_ranks", dev, 3, 6)
            la = _elastic_learner(_synth_paths(root, False), root, "el_a",
                                  plan["dp"], dev)
            la.overfit_batch(2, LR)
            la.save_model_dict(root / "elastic.ckpt")
            la.ckpt_backend.wait()
        else:
            out = _resume(root, plan, dev)
    out["data"] = [C.data_rank(), C.data_world_size()]
    torch.save(out, Path(spec["out"]) / f"rank{C.get_rank()}.pt")
    C.synchronize()
    torch.distributed.destroy_process_group()
    return 0


def _synth_paths(root: Path, with_frames: bool) -> Dict[str, str]:
    """The paths of the tree ``_synth`` made (made once, by the launcher)."""
    return json.loads((root / ("frames" if with_frames else "feats")
                       / "paths.json").read_text())


def _launch(phase: str, nproc: int, plan: Dict, root: Path, bs: int) -> List:
    """``torchrun`` of this module's ``--child`` on ``nproc`` ranks; every
    rank's result, in rank order. A failed rank or a launch past
    LAUNCH_TIMEOUT_S raises (the launcher's process group is killed)."""
    out = root / f"{phase}_out"
    out.mkdir(parents=True, exist_ok=True)
    spec = root / f"{phase}_spec.json"
    spec.write_text(json.dumps({"phase": phase, "root": str(root),
                                "out": str(out), "plan": plan, "bs": bs,
                                "device": plan["device"],
                                "backend": plan["backend"]}))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "-m", "vidsitu_tpu_torch.dryrun",
           "--child", str(spec)]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    if plan["device"] == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    log = root / f"{phase}.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                cwd=str(REPO), env=env,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=LAUNCH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    if rc != 0:
        raise RuntimeError(f"dryrun {phase} on {nproc} ranks: rc {rc}\n"
                           + log.read_text(errors="replace")[-6000:])
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(nproc)]


def _close(a: torch.Tensor, b: torch.Tensor, atol, rtol, mean=None,
           what=""):
    a, b = a.double().numpy(), b.double().numpy()
    np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=what)
    if mean is not None and a.size:
        err = float(np.abs(a - b).mean())
        assert err < mean, (what, err, mean)


def _stats(state) -> List[str]:
    return [k for k in state if k.endswith(("running_mean", "running_var"))]


def dryrun_multichip(n_devices: int, device="cuda") -> List[str]:
    """Launch ``n_devices`` ranks and assert that they compute what one
    process computes (see the module docstring); print one line a part, in
    the JAX entry's wording, and return them. Raises on any difference past
    its limit, or when a rank fails."""
    from .data import build_comm, get_data
    from .extract import resolve_device

    n = int(n_devices)
    if n < 2:
        raise ValueError(f"dryrun_multichip({n}): at least 2 ranks")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)  # one process's reference
    plan = _plan(n, device)
    lines: List[str] = []

    def say(line):
        print(line, flush=True)
        lines.append(line)

    bs = max(n, 2)
    with tempfile.TemporaryDirectory(prefix="vidsitu_dryrun_") as tmp, \
            _float32_exact():
        root = Path(tmp)
        for frames in (False, True):
            paths = _synth(root, frames)
            (root / ("frames" if frames else "feats") / "paths.json"
             ).write_text(json.dumps(paths))
        ranks = _launch("steps", n, plan, root, bs)
        dp, tp = _mesh_dict(plan["dp"]), plan["tp"]
        for task, mdl, extra, frames in _DRYRUN_TASKS:
            cfg = _cfg(_synth_paths(root, frames), root, task, mdl, extra, bs,
                       **_DECODE)
            data = get_data(cfg)
            comm = data.train_dl.dataset.comm
            batch = next(iter(data.train_dl))
            one = one_step(cfg, _model(cfg, comm), batch, dev)
            loss_1 = one["loss"]
            max_delta = 0.0
            for r in ranks:
                got = r[f"{task}_dp"]
                loss_n = got["loss"]
                assert loss_n == loss_n, f"[{task}] NaN loss on {n} ranks"
                assert abs(loss_n - loss_1) <= 1e-3 * max(1.0, abs(loss_1)), (
                    f"[{task}] loss mismatch: {n} ranks {loss_n} vs "
                    f"1 process {loss_1}")
                for k, g in one["grads"].items():
                    _close(got["grads"][k], g, 5e-4, 5e-2, 5e-5,
                           f"[{task}] grad {k}")
                stats = _stats(one["state"])
                for k, v in one["state"].items():
                    if not v.is_floating_point():
                        continue
                    if k in stats:
                        _close(got["state"][k], v, 3e-4, 1e-4,
                               what=f"[{task}] stat {k}")
                    else:
                        _close(got["state"][k], v, 2e-3, 1e-4, 1e-4,
                               f"[{task}] param {k}")
                        max_delta = max(max_delta, float(
                            (got["state"][k] - v).abs().max()))
            loss_n = ranks[0][f"{task}_dp"]["loss"]
            say(f"dryrun[{task}/{mdl}] OK loss_{n}dev={loss_n:.5f} "
                f"loss_1dev={loss_1:.5f} max_param_delta={max_delta:.2e} "
                f"extra_leaves={len(stats)} mesh={dp}")
            if task == "vb_arg" and tp:
                for r in ranks:
                    got = r["vb_arg_tp"]
                    assert abs(got["loss"] - loss_1) <= 1e-3 * max(
                        1.0, abs(loss_1)), (
                        f"[vb_arg tp] loss mismatch: tp {got['loss']} vs "
                        f"1 process {loss_1}")
                    for k, g in one["grads"].items():
                        _close(got["grads"][k], g, 5e-4, 5e-2,
                               what=f"[vb_arg tp] grad {k}")
                    for k, v in one["state"].items():
                        if v.is_floating_point():
                            _close(got["state"][k], v, 1e-3, 1e-4,
                                   what=f"[vb_arg tp] param {k}")
                loss_tp = ranks[0]["vb_arg_tp"]["loss"]
                say(f"dryrun[vb_arg tp] OK tensor-parallel mesh "
                    f"{_mesh_dict(tp)} loss={loss_tp:.5f} == 1dev")
            if task == "vb_arg":
                toks_1 = _decode(cfg, comm, batch, dev)
                world = ranks[0]["data"][1]
                for r in ranks:
                    d = r["data"][0]
                    assert torch.equal(r["decode"], toks_1[d::world]), (
                        f"beam decode tokens of data shard {d} differ "
                        f"between {n} ranks and 1 process")
                say(f"dryrun[vb_arg decode] OK segmented ancestry beam-3 "
                    f"{n}dev == 1dev (tokens exact)")
        cfg = _cfg(_synth_paths(root, True), root, "vb", "sf_base",
                   _TINY_VID, 4)
        comm = build_comm(cfg)
        _extract(cfg, comm, root / "ext_one", dev, 4, 64)
        files = sorted((root / "ext_ranks").glob("*_feats.npy"))
        assert sum(r["extract"] for r in ranks) >= len(files) == 5, (
            [r["extract"] for r in ranks], files)
        for f in files:
            a, b = np.load(f), np.load(root / "ext_one" / f.name)
            assert a.shape == b.shape and a.shape[0] == 5, (f.name, a.shape)
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)
        say(f"dryrun[extract] OK sharded clip-stream {n}dev == 1dev "
            f"({len(files)} segments, spanning batches + padded tail)")
        n_small = plan["small"][0][0]
        # one rank: this process, without a process group
        small = ([_resume(root, plan, dev)] if n_small == 1
                 else _launch("resume", n_small, plan, root, bs))
        for r in small:
            lb, lc = r["loss_b"][-1], r["loss_c"][-1]
            assert abs(lb - lc) <= 1e-4 * max(1.0, abs(lc)), (
                f"continued loss {lb} != uninterrupted {lc}")
            for k, v in r["state_c"].items():
                if v.is_floating_point():
                    _close(r["state_b"][k], v, 3e-4, 0, what=f"elastic {k}")
        say(f"dryrun[elastic] OK save@{dp} -> resume@"
            f"{_mesh_dict(plan['small'])}: continued loss "
            f"{small[0]['loss_b'][-1]:.5f} == uninterrupted "
            f"{small[0]['loss_c'][-1]:.5f}")
    say(f"dryrun_multichip({n}) OK: vb_arg+vb+evrel verified")
    return lines


def _gpu_line() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return None


def write_receipt(path: Path, receipt: Dict) -> None:
    """``receipt`` into ``path``'s ``runs``, in place of the run of its
    device type."""
    runs = []
    if path.is_file():
        runs = [r for r in json.loads(path.read_text()).get("runs", [])
                if r.get("device_type") != receipt["device_type"]]
    runs.append(receipt)
    runs.sort(key=lambda r: r["device_type"])
    path.write_text(json.dumps({"runs": runs}, indent=2) + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vidsitu_tpu_torch.dryrun")
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--receipt", default=str(RECEIPT))
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return _child(args.child)
    rc, lines, error = 0, [], None
    try:
        lines = dryrun_multichip(args.n, args.device)
    except Exception as e:  # noqa: BLE001 - the receipt records it
        rc, error = 1, f"{type(e).__name__}: {e}"
        print(error, file=sys.stderr)
    plan = _plan(args.n, args.device) if rc == 0 else None
    dev_type = torch.device(args.device).type
    write_receipt(Path(args.receipt), {
        "n_devices": args.n, "rc": rc, "ok": rc == 0, "skipped": False,
        "tail": "\n".join(lines + ([error] if error else [])) + "\n",
        "device_type": dev_type, "device": (
            torch.cuda.get_device_name(0) if dev_type == "cuda" else "cpu"),
        "backend": plan["backend"] if plan else None,
        "mesh": {"steps": _mesh_dict(plan["dp"]),
                 "tp": _mesh_dict(plan["tp"]) if plan["tp"] else None,
                 "resume": _mesh_dict(plan["small"])} if plan else None,
        "gpu": _gpu_line() if dev_type == "cuda" else None,
        "torch": torch.__version__})
    return rc


if __name__ == "__main__":
    sys.exit(main())
