"""Training engine: the Learner (port of vidsitu_tpu/train/learner.py;
reference: utils/trn_utils.py:315-939), on one device per process, one
process or several (``torch.distributed``, ``parallel/``).

The JAX package's lifecycle, kept: log-dir scaffolding, resume by uid, fit
with per-epoch validation and a best-metric checkpoint (strict: a tie is no
improvement), reduce-on-plateau, EMA loss smoothing, the tracker, SIGTERM
preemption to a separate checkpoint, overfit-batch. The train step is eager
PyTorch:

  * Adam(0.9, 0.99, eps 1e-8) with the lr in the param group, so plateau
    changes it in place (``optax.inject_hyperparams(adam)``); over
    parameters held in bfloat16 or float16 (``train.param_dtype``) its
    moments are kept in that dtype and every step of the update rounds to
    it, in optax's order (``train/adam.py``);
  * ``train.grad_accum`` = k is ``optax.MultiSteps``: the mean of k
    gradients, one update every k steps; a cycle in flight (its count and
    the gradients so far) goes into a checkpoint and resumes, as the
    MultiSteps state does in the JAX package's;
  * ``train.freeze_sfbase`` zeroes the backbone's gradients before each
    update (its BatchNorm statistics still move);
  * the loss of a step is fetched to the host only after the next step was
    queued, so the device never waits on the host's read;
  * frames are folded (B, 5, ...) -> (B*5, ...) on the host, copied from
    pinned memory without blocking;
  * dropout (SRL and evrel) draws its masks from ``dropout_gen``, a
    generator on the training device seeded from ``train.seed``, whose
    state goes into every checkpoint (the JAX package keeps its dropout key
    there for the same reason): a resumed run continues the same masks;
  * the model validates in ``eval()`` and returns to ``train()`` after.

Under a process group each rank trains on its shard of the global batch and
the step computes what the JAX package's one program computes over the
global batch: BatchNorm takes the global batch's statistics and the loss is
the global masked mean (each rank's share; ``models/``), so the ranks'
gradients are summed, not averaged: in one flat all-reduce before the
update (every ``grad_accum``-th step; a parameter without a gradient on
every rank keeps none), or, under fsdp (``parallel.mesh.shard_model``), by
FSDP2's reduce-scatter at every backward with its divide factor at 1. Every
rank holds the same dropout generator, seeded from ``train.seed``, and
keeps its examples' rows of the global batch's masks
(``models.common.dropout_generator``), so a step does not depend on the
number of ranks. Under a ``model`` mesh axis (tensor parallelism,
``parallel/tensor.py``) the ranks of a model group hold the same examples:
the batch, the dropout rows, the loss and the gradient sum follow the data
group (``collectives.data_group``), and the split parameters' gradients stay
each rank's slice. Rank 0 writes the logs and the tracker; checkpoints hold
one generator state and resume on any number of ranks and any mesh that
divides the global batches (``load_model_dict``); a sharded model validates
through a whole copy (``eval_model``), refreshed before each validation;
rank 0's validation results reach every rank, so best-metric, plateau and
save decisions agree; SIGTERM is honoured at the epoch boundary, once any
rank has seen it (``_sync_preempt_flag``). ``request_resize(n)`` shrinks a
running fit to ranks 0..n-1 at the next epoch boundary, without a restart
(the JAX package's mid-run elasticity, learner.py:366-439).
"""

from __future__ import annotations

import json
import logging
import math
import signal
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.common import take_dtypes
from ..parallel.collectives import (
    broadcast_object,
    collective_device,
    data_group,
    data_rank,
    data_world_size,
    get_rank,
    get_world_size,
    is_dist,
    synchronize,
    world_group,
)
from ..utils.config import CfgProcessor


class SmoothenDict:
    """EMA(0.9) loss smoothing with bias correction
    (trn_utils.py:132-181)."""

    def __init__(self, keys, beta: float = 0.9):
        self.beta = beta
        self.keys = list(keys)
        self.n = 0
        self.mov = {k: 0.0 for k in self.keys}
        self.smooth = {k: 0.0 for k in self.keys}

    def add_value(self, vals: Dict[str, float]):
        self.n += 1
        for k in self.keys:
            self.mov[k] = self.beta * self.mov[k] + (1 - self.beta) * float(
                vals[k])
            self.smooth[k] = self.mov[k] / (1 - self.beta**self.n)


def good_format_stats(names, stats) -> str:
    # a scorer that omits a metric logs 0 rather than failing the epoch
    return " ".join(f"{k}: {float(stats.get(k, 0.0)):.4f}" for k in names)


def batch_to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Numeric numpy arrays of a host batch -> tensors on ``device``; on a
    GPU through pinned memory, without blocking the host."""
    out = {}
    cuda = device.type == "cuda"
    for k, v in batch.items():
        arr = np.asarray(v)
        if arr.dtype.kind not in "biuf":
            continue
        t = torch.from_numpy(np.ascontiguousarray(arr))
        out[k] = (t.pin_memory().to(device, non_blocking=True) if cuda
                  else t.to(device))
    return out


class Learner:
    """``eval_fn(dl, dl_name, pred_path) -> (loss_dict, metric_dict)``, with
    ``met_keys``, scores a loader (the evaluators of
    ``evaluation/evaluators.py``)."""

    def __init__(self, uid: str, cfg, model: torch.nn.Module, data, eval_fn,
                 device, loss_keys=("loss",),
                 eval_model: Optional[torch.nn.Module] = None, mesh=None):
        from .checkpoint import get_backend

        self.uid = uid
        self.cfg = cfg
        self.device = torch.device(device)
        self.data = data
        self.eval_fn = eval_fn
        self.loss_keys = list(loss_keys)
        self.num_it = 0
        self.num_epoch = 0
        self.best_met = None
        self.best_epoch = 0
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.plateau_wait = 0
        self._lr = None
        self._grad_accum = max(int(cfg.train.grad_accum), 1)
        self._accum_count = 0
        # optimizer state (and a grad_accum cycle) stashed by a resume
        self._pending_opt = None
        self._preempt_requested = False
        self._stale_preempt = None  # consumed preempt ckpt, deleted on save
        self.ckpt_backend = get_backend(cfg.train.ckpt_backend)
        self._pending_resize: Optional[int] = None
        self._resized = False
        self.left = False  # this rank left the run at a resize
        self._bind(model, eval_model, mesh)
        # the dropout masks' random state, on the training device, the same
        # on every rank; the only random state of a step (the JAX
        # package's rng)
        self.dropout_gen = torch.Generator(device=self.device).manual_seed(
            int(cfg.train.seed))
        self.init_log_dirs()
        self.prepare_log_file()
        if cfg.train.resume:
            resume_path = cfg.train.resume_path or str(
                self.preempt_file if self.preempt_file.exists()
                else self.model_file)
            self.load_model_dict(resume_path, load_opt=cfg.train.load_opt)
            if resume_path == str(self.preempt_file):
                # consumed, but kept until the next save that resume reads
                self._stale_preempt = self.preempt_file

    def _bind(self, model: torch.nn.Module,
              eval_model: Optional[torch.nn.Module], mesh):
        """What the Learner keeps of the model, the mesh and the ranks (at
        construction, and again on the survivors of a resize)."""
        from ..parallel.mesh import is_sharded
        from ..parallel.tensor import split_of
        from .pretrained import make_freeze_mask

        self.model = model
        # what eval_fn runs: the model, or a whole copy of a sharded one
        self.eval_model = model if eval_model is None else eval_model
        self.mesh = mesh  # the DeviceMesh, or None
        self.sharded = is_sharded(model)
        # the tensor-parallel split (parallel/tensor.py), or None
        self.split = split_of(model)
        self.rank, self.world_size = get_rank(), get_world_size()
        # this rank's place among the ranks that split the batch
        self.data_rank, self.data_world = data_rank(), data_world_size()
        self.is_main = self.rank == 0
        frozen = make_freeze_mask(self.cfg, model)
        # under fsdp these are the sharded (DTensor) parameters
        params = dict(model.named_parameters())
        self._frozen = [params[n] for n in frozen] if frozen else []
        self._param_names = list(params)
        self._params = list(params.values())

    # -- scaffolding (trn_utils.py:433-478) ----------------------------------
    def init_log_dirs(self):
        tmp = Path(self.cfg.misc.tmp_path)
        self.txt_log_file = tmp / "txt_logs" / f"{self.uid}.txt"
        self.extra_logger_file = tmp / "ext_logs" / f"{self.uid}.txt"
        self.model_file = tmp / "models" / f"{self.uid}.ckpt"
        self.preempt_file = tmp / "models" / f"{self.uid}.preempt.ckpt"
        self.model_epoch_dir = tmp / "model_epochs" / self.uid
        self.predictions_dir = tmp / "predictions" / self.uid
        for p in (self.txt_log_file.parent, self.extra_logger_file.parent,
                  self.model_file.parent, self.predictions_dir):
            p.mkdir(parents=True, exist_ok=True)
        self.logger = logging.getLogger(f"vidsitu_tpu_torch.{self.uid}")
        self.logger.setLevel(logging.DEBUG)
        if not self.logger.handlers:
            sh = logging.StreamHandler(sys.stdout)
            sh.setLevel(logging.INFO)
            self.logger.addHandler(sh)
            if self.is_main:
                self.logger.addHandler(
                    logging.FileHandler(self.extra_logger_file))

    def prepare_log_file(self):
        if not self.is_main:
            return
        with open(self.txt_log_file, "a") as f:
            f.write(CfgProcessor.to_str(self.cfg))
            f.write("\n\n")

    def update_log_file(self, line: str):
        if not self.is_main:
            return
        with open(self.txt_log_file, "a") as f:
            f.write(line + "\n")

    # -- optimizer ------------------------------------------------------------
    def prepare_optimizer(self, lr: float):
        """Adam(0.9, 0.99) over every parameter, lr in the param group; a
        stashed optimizer state from ``load_model_dict(load_opt=True)`` is
        restored here, with its lr and its ``grad_accum`` cycle. Without
        one, no cycle is in flight."""
        self._new_optimizer(lr)
        pending, self._pending_opt = self._pending_opt, None
        if pending is not None:
            self._restore_opt(pending)
        else:
            self.optimizer.zero_grad(set_to_none=True)
            self._accum_count = 0

    def _new_optimizer(self, lr: float):
        from .adam import make_adam

        self.optimizer = make_adam(self.model.parameters(), lr)
        self._lr = lr

    def _restore_opt(self, pending: Dict):
        self._load_opt_state(pending["opt"])
        lr = pending["lr"]
        if lr is None:
            lr = self.optimizer.param_groups[0]["lr"]
        self._set_lr(float(lr))
        self._restore_accum(pending["accum_count"], pending["accum"])
        self.logger.info("restored optimizer state (lr=%.2e)", self._lr)

    def _set_lr(self, lr: float):
        self._lr = lr
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def train_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One forward and backward on a device batch; every
        ``train.grad_accum`` steps, one update with the mean of their
        gradients (under a process group: of the global batches', summed
        over the ranks here). Returns the loss (the global batch's), still
        on the device."""
        from ..models.common import dropout_generator

        self.model.train()
        # every batch holds vseg_idx: one row per example of this rank
        examples = len(batch["vseg_idx"]) if "vseg_idx" in batch else None
        with dropout_generator(self.dropout_gen, self.data_rank,
                               self.data_world, examples):
            loss = self.model(batch)["loss"]
        (loss / self._grad_accum).backward()
        self._accum_count += 1
        if self._accum_count == self._grad_accum:
            if is_dist() and not self.sharded:
                self._sum_grads()
            for p in self._frozen:
                if p.grad is not None:
                    p.grad.zero_()
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self._accum_count = 0
        loss = loss.detach()
        if is_dist():
            loss = loss.clone()
            torch.distributed.all_reduce(loss, group=data_group())
        return loss

    def _sum_grads(self):
        """Sum the ranks' gradients in place (``_summed_grads``)."""
        for p, g in zip(self._params, self._summed_grads(inplace=True)):
            p.grad = g

    def _summed_grads(self, inplace: bool) -> List[Optional[torch.Tensor]]:
        """The data group's gradients summed in one flat all-reduce (a split
        parameter's are this rank's slice, summed with the same slice of
        the other data coordinates), with a flag
        per parameter: one that has no gradient on any rank keeps none
        (Adam then leaves it alone, as on one process), one that has a
        gradient on some rank takes zeros where it has none. ``inplace``
        writes the sums into the gradients' own storage; else they are
        new tensors and the gradients stay as they were."""
        params = self._params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        flags = torch.tensor([p.grad is not None for p in params],
                             dtype=grads[0].dtype, device=grads[0].device)
        flat = torch.cat([g.reshape(-1) for g in grads] + [flags])
        torch.distributed.all_reduce(flat, group=data_group())
        sizes = [g.numel() for g in grads] + [len(params)]
        *parts, flags = flat.split(sizes)
        return [(g.copy_(part.view(g.shape)) if inplace
                 else part.view(g.shape)) if any_grad else None
                for g, part, any_grad in zip(grads, parts, flags.tolist())]

    # -- preemption -------------------------------------------------------------
    def _install_preempt_handler(self):
        """SIGTERM -> stop after the step in flight (one process) or the
        epoch in flight (several: a rank that stopped alone would leave the
        others waiting in a collective), checkpoint to the preempt file,
        return (``train.handle_preemption``). Returns the callable that
        restores the previous handler."""
        self._preempt_requested = False
        if not getattr(self.cfg.train, "handle_preemption", True):
            return lambda: None
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def _on_term(signum, frame):
                self._preempt_requested = True  # flag only: not reentrant

            signal.signal(signal.SIGTERM, _on_term)
            return lambda: signal.signal(signal.SIGTERM, prev)
        except ValueError:  # not the main thread
            return lambda: None

    def _sync_preempt_flag(self) -> bool:
        """The preempt flag OR-ed over the ranks, at the epoch boundary that
        every rank reaches together: if any rank saw SIGTERM, all take the
        checkpoint-and-return branch (the signal may reach one rank only)."""
        if is_dist():
            flag = torch.tensor([int(self._preempt_requested)],
                                device=collective_device())
            torch.distributed.all_reduce(
                flag, op=torch.distributed.ReduceOp.MAX, group=world_group())
            self._preempt_requested = bool(flag.item())
        return self._preempt_requested

    # -- training loop (trn_utils.py:583-628,788-867) ---------------------------
    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def train_epoch(self, smoother: SmoothenDict) -> Dict[str, float]:
        from ..data.loader import fold_frame_events

        dl = self.data.train_dl
        dl.set_epoch(self.num_epoch)
        losses: List[float] = []
        profiling = bool(self.cfg.tpu.profile) and self.num_epoch == 0
        prof = None
        prof_dir = Path(self.cfg.misc.tmp_path) / "profile" / self.uid

        def consume(pending_loss, pending_it):
            # the previous step's loss: the next step is already queued
            lossf = float(pending_loss)
            if np.isnan(lossf):
                self.logger.info("Nan loss at iteration %d", pending_it)
            losses.append(lossf)
            smoother.add_value({k: lossf if i == 0 else 0.0
                                for i, k in enumerate(self.loss_keys)})
            if pending_it % max(self.cfg.log.deb_it, 1) == 0:
                self.logger.debug("it %d loss %.4f smooth %.4f", pending_it,
                                  lossf, smoother.smooth[self.loss_keys[0]])

        pending = None
        for bix, batch in enumerate(dl):
            if profiling and bix == 1:
                prof = self._profiler()
                prof.__enter__()
            loss = self.train_step(
                batch_to_device(fold_frame_events(batch), self.device))
            if prof is not None and bix == self.cfg.tpu.profile_steps:
                self._stop_profile(prof, prof_dir)
                prof, profiling = None, False
            self.num_it += 1
            if pending is not None:
                consume(*pending)
            pending = (loss, self.num_it)
            if self._preempt_requested and not is_dist():
                self.logger.info("preemption requested; stopping epoch at it "
                                 "%d", self.num_it)
                break
        if pending is not None:
            consume(*pending)
        if prof is not None:  # epoch shorter than the profile window
            self._stop_profile(prof, prof_dir)
        return {"loss": float(np.mean(losses)) if losses else float("nan")}

    def _stop_profile(self, prof, prof_dir: Path):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        prof_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(prof_dir / "trace.json"))
        self.logger.info("profiler trace written to %s", prof_dir)

    def validate(self, db: Optional[Dict] = None, write_to_file: bool = False):
        if db is None:
            db = {self.cfg.val_dl_name: self.data.valid_dl}
        out_loss, out_acc = {}, {}
        if self.eval_model is not self.model:
            # the fsdp-sharded weights, gathered on every rank (collective;
            # under tensor parallelism the copy keeps this rank's slices)
            self.eval_model.load_state_dict(self._model_state(
                full=True, cpu=False, model_axis=False))
        was_training = self.model.training
        self.model.eval()
        self.eval_model.eval()
        try:
            for dl_name, dl in db.items():
                loss, acc = self.eval_fn(dl, dl_name, self.predictions_dir)
                out_loss.update(loss)
                out_acc.update(acc)
        finally:
            self.model.train(was_training)
        # rank 0 alone scored the merged predictions (the others hold
        # zeros); its float64 values, on every rank
        out_loss, out_acc = broadcast_object((out_loss, out_acc))
        if write_to_file:
            keys = ["epochs"] + list(out_loss) + list(out_acc)
            vals = [str(self.num_epoch)] + [
                f"{float(v):.4f}"
                for v in list(out_loss.values()) + list(out_acc.values())]
            self.update_log_file("  ".join(keys))
            self.update_log_file("  ".join(vals))
        return out_loss, out_acc, {}

    def fit(self, epochs: int, lr: float):
        from .tracking import Tracker

        self.prepare_optimizer(lr)
        smoother = SmoothenDict(self.loss_keys)
        met_keys = self.eval_fn.met_keys
        self.update_log_file("  ".join(["epochs", "trn_loss", "val_loss"]
                                       + list(met_keys)))
        st_time = time.time()
        tracker = Tracker(self.cfg, self.uid, enabled=self.is_main)
        tracker.log_params(CfgProcessor.cfg_to_flat_dct(self.cfg))
        restore_sig = self._install_preempt_handler()
        try:
            for _ in range(epochs):
                ep_start = time.time()
                trn_loss = self.train_epoch(smoother)
                if self._sync_preempt_flag():
                    # the full state to the preempt file (never over the
                    # best model), so that re-running the uid resumes it
                    self.save_model_dict(self.preempt_file)
                    self.update_log_file(
                        f"preempted at epoch {self.num_epoch} "
                        f"it {self.num_it}; checkpoint saved")
                    self.logger.info("preempted: checkpoint saved to %s; "
                                     "re-run uid %s to resume",
                                     self.preempt_file, self.uid)
                    tracker.end_run()
                    self.ckpt_backend.wait()
                    return
                val_loss, val_acc, _ = self.validate()
                self.num_epoch += 1
                met0 = float(val_acc.get(met_keys[0], 0.0))
                # strict: a tie is no improvement (trn_utils.py:825)
                if self.best_met is None or met0 > self.best_met:
                    self.best_met = met0
                    self.best_epoch = self.num_epoch
                    self.save_model_dict()
                    self.plateau_wait = 0
                elif self.cfg.train.use_reduce_lr_plateau:
                    self.plateau_wait += 1
                    if self.plateau_wait >= self.cfg.train.plateau_patience:
                        self._set_lr(self._lr * self.cfg.train.plateau_factor)
                        self.plateau_wait = 0
                        self.logger.info("plateau: lr -> %.2e", self._lr)
                tracker.log_metrics({
                    "trn_loss": trn_loss["loss"],
                    "val_loss": float(val_loss.get("loss", 0.0)),
                    "lr": self._lr,
                    **{k: float(v) for k, v in val_acc.items()},
                }, step=self.num_epoch)
                if self.cfg.train.save_mdl_epochs:
                    self.model_epoch_dir.mkdir(parents=True, exist_ok=True)
                    self.save_model_dict(
                        self.model_epoch_dir / f"mdl_ep_{self.num_epoch}.ckpt")
                row = (f"{self.num_epoch}  {trn_loss['loss']:.4f}  "
                       f"{float(val_loss.get('loss', 0.0)):.4f}  "
                       + good_format_stats(met_keys, val_acc))
                self.update_log_file(row)
                self.logger.info("epoch %d done in %.1fs: %s", self.num_epoch,
                                 time.time() - ep_start, row)
                if self._pending_resize is not None and \
                        not self._apply_resize():
                    tracker.end_run()
                    return  # this rank left the run
        except Exception as e:
            # every improving epoch saved at once: nothing more to save
            self.update_log_file(f"exited due to exception {e!r}")
            self.update_log_file(f"elapsed {time.time() - st_time:.1f}s")
            tracker.end_run()
            self.ckpt_backend.wait()
            raise
        finally:
            restore_sig()
        self.update_log_file(
            f"epochs done. elapsed {time.time() - st_time:.1f}s")
        tracker.log_artifact(self.txt_log_file)
        tracker.end_run()
        self.ckpt_backend.wait()  # an async save in flight commits

    # -- mid-run resize (the JAX Learner.request_resize, learner.py:366-439) -
    def request_resize(self, n: int):
        """Shrink the run to ranks 0..n-1 at the next epoch boundary of
        ``fit``, after the validation and the saves, without a restart.
        Ranks >= n leave ``fit`` there (``left`` is then True; ``main`` then
        skips the final validation); the survivors go on with the whole
        state: the model, Adam's moments, the BatchNorm statistics, a
        ``grad_accum`` cycle in flight, the dropout generator and the
        counters, re-split and re-sharded on the new mesh
        (``cfg.tpu.mesh_shape`` over n, or a pure ``data`` mesh where that
        shape does not tile n), with their loaders' shards and the
        evaluator re-targeted. A step does not depend on the number of
        ranks, so the resized run is the straight run.

        A process drives one GPU and cannot take ranks it was not started
        with: a grow (``n`` >= the run's ranks) raises here. It is the
        checkpoint restart on more ranks (``train.resume=True``,
        ``load_model_dict``), as the JAX docstring says for process-count
        changes. One resize a run: the survivors' groups are made over the
        default group, which the ranks that left are no longer in."""
        n = int(n)
        if not 1 <= n < self.world_size:
            raise ValueError(
                f"request_resize({n}) on a run of {self.world_size} rank(s): "
                "a resize only shrinks (1 <= n < ranks); to grow, restart on "
                "more ranks from a checkpoint (train.resume=True, "
                "Learner.load_model_dict)")
        if self._resized:
            raise ValueError(
                f"request_resize({n}): this run was resized once already; "
                "restart from a checkpoint to resize again")
        self._pending_resize = n

    def _mesh_shape(self) -> Dict[str, int]:
        if self.mesh is None:
            return {"data": self.world_size}
        return {a: int(s) for a, s in zip(self.mesh.mesh_dim_names,
                                          self.mesh.mesh.shape)}

    def _apply_resize(self) -> bool:
        """The resize ``request_resize`` asked for, on every rank, as an
        in-memory save and resume: the checks (the same on every rank, so
        all raise together, before any state changes), the whole state
        gathered while every rank is here, the survivors' groups (every
        rank makes them), then on the survivors a whole model placed on the
        new mesh as ``build_learner`` places one, the state loaded into it
        as ``load_model_dict`` loads one, the optimizer, the loaders and the
        evaluator. Returns False on a rank that leaves."""
        from ..data.loader import DataWrap, get_dataloader
        from ..parallel import collectives as C
        from ..parallel.mesh import make_survivors_mesh, resized_shape
        from ..parallel.tensor import unshard_tp
        from .build import place_model

        n, self._pending_resize = self._pending_resize, None
        shape, names = resized_shape(self.cfg, n)
        new = dict(zip(names, shape))
        extent = math.prod(s for a, s in new.items() if a in ("data", "fsdp"))
        for key, what in (("bs", "train batch"), ("bsv", "eval batch")):
            if int(self.cfg.train[key]) % extent:
                raise ValueError(
                    f"resize to {n} ranks ({new}): {what} train.{key}="
                    f"{self.cfg.train[key]} is not divisible by the resized "
                    f"mesh's {extent}-way data-parallel share; pick a "
                    f"compatible n or train.{key}")
        old = self._mesh_shape()
        self.ckpt_backend.wait()
        model_state = self._model_state(full=True)
        opt_state = self._opt_state(full=True)
        accum_count, accum = self._accum_count, self._accum_state(full=True)
        self.ckpt_backend.regroup(n)
        made = make_survivors_mesh(shape, names, self.device.type)
        if made is None:
            C.leave()
            self.left = True
            self.logger.info("rank %d left the run at the resize to %d "
                             "ranks (epoch %d)", self.rank, n, self.num_epoch)
            return False
        world, mesh, groups = made
        C.set_world_group(world)
        C.set_axis_groups(**groups)
        # a whole model: the evaluation copy under fsdp (whole on the fsdp
        # axis), else the model itself; its split undone
        base = self.eval_model
        unshard_tp(base, model_state)
        base.load_state_dict(model_state, strict=True)
        model, eval_model = place_model(base, self.cfg, mesh, self.device)
        model.train()
        self._bind(model, eval_model, mesh)
        self._new_optimizer(self._lr)
        self._restore_opt({"opt": opt_state, "lr": self._lr,
                           "accum_count": accum_count, "accum": accum})
        if self.data is not None:
            def shard(dl, is_train):
                return None if dl is None else get_dataloader(
                    self.cfg, dl.dataset, is_train, self.data_world,
                    self.data_rank)

            self.data = DataWrap(path=self.data.path,
                                 train_dl=shard(self.data.train_dl, True),
                                 valid_dl=shard(self.data.valid_dl, False),
                                 test_dl=shard(self.data.test_dl, False))
        rebind = getattr(self.eval_fn, "rebind", None)
        if callable(rebind):
            rebind(self.eval_model, self.data_rank, self.data_world,
                   C.model_rank())
        self._resized = True
        self.logger.info("elastic resize: mesh %s -> %s", old, new)
        self.update_log_file(
            f"elastic resize at epoch {self.num_epoch}: {old} -> {new}")
        return True

    def overfit_batch(self, epochs: int, lr: float) -> List[float]:
        """Single-batch convergence sanity (trn_utils.py:915-939)."""
        from ..data.loader import fold_frame_events

        self.prepare_optimizer(lr)
        batch = batch_to_device(
            fold_frame_events(next(iter(self.data.train_dl))), self.device)
        losses = []
        for _ in range(epochs):
            losses.append(float(self.train_step(batch)))
            self.logger.info("overfit loss %.5f", losses[-1])
        return losses

    # -- checkpointing (trn_utils.py:631-749) -----------------------------------
    # One layout in every mode: the model's state dict, Adam's state keyed by
    # parameter name, the grad_accum cycle's gradients by name, whole
    # tensors. ``full`` gathers fsdp's shards and the tensor-parallel slices
    # whole (collectives: every rank calls it) for the pickle backend, and
    # for the orbax backend under tensor parallelism (the ranks' slices of
    # one name have other shapes); else fsdp's shards go to the orbax
    # backend as they are. (``torch.distributed.checkpoint.state_dict``'s
    # getters would take an optimizer step of lr 0 to make Adam's state
    # where it has none yet, which moves Adam's step count: they are not
    # used.)

    def _whole(self, name: str, v: torch.Tensor, cpu: bool,
               model_axis: bool = True) -> torch.Tensor:
        """Parameter ``name``'s tensor ``v`` whole: fsdp's shards gathered,
        and with ``model_axis`` the model group's slices."""
        from torch.distributed.tensor import DTensor

        if isinstance(v, DTensor):
            v = v.full_tensor()
        if model_axis and self.split is not None:
            v = self.split.whole(name, v)
        return v.detach().cpu() if cpu else v.detach()

    def _shard_like(self, name: str, full: torch.Tensor,
                    target: torch.Tensor) -> torch.Tensor:
        """A whole tensor of parameter ``name`` in ``target``'s layout: this
        rank's tensor-parallel slice, then its fsdp shard where ``target``
        is a DTensor, on ``target``'s device."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        if self.split is not None:
            full = self.split.local(name, full)
        full = full.to(target.device, target.dtype).contiguous()
        if isinstance(target, DTensor):
            # every rank holds the whole tensor: no communication
            return distribute_tensor(full, target.device_mesh,
                                     target.placements, src_data_rank=None)
        return full

    def _model_state(self, full: bool, cpu: bool = True,
                     model_axis: bool = True) -> Dict:
        return {k: self._whole(k, v, cpu, model_axis) if full else v.detach()
                for k, v in self.model.state_dict().items()}

    def _opt_state(self, full: bool) -> Optional[Dict]:
        if self.optimizer is None:
            return None
        sd = self.optimizer.state_dict()
        names = self._param_names  # the optimizer's order (parameters())
        state = {names[i]: {k: self._whole(names[i], v, True) if full else v
                            for k, v in st.items()}
                 for i, st in sd["state"].items()}
        groups = [{**g, "params": [names[i] for i in g["params"]]}
                  for g in sd["param_groups"]]
        return {"state": state, "param_groups": groups}

    def _load_opt_state(self, saved: Dict):
        """Adam's state by parameter name (or by index: checkpoints written
        before the layout was by name), whole tensors, into this run's
        optimizer and layout."""
        names = self._param_names
        index = {n: i for i, n in enumerate(names)}

        def name(k):
            return names[k] if isinstance(k, int) else k

        state = {}
        for k, st in saved["state"].items():
            i = index[name(k)]
            p = self._params[i]
            state[i] = {f: v if f == "step"
                        else self._shard_like(name(k), v, p)
                        for f, v in st.items()}
        groups = [{**g, "params": [index[name(k)] for k in g["params"]]}
                  for g in saved["param_groups"]]
        self.optimizer.load_state_dict({"state": state,
                                        "param_groups": groups})

    def _accum_state(self, full: bool) -> Dict[str, torch.Tensor]:
        """The gradients of the ``grad_accum`` cycle in flight, summed over
        the ranks, by name ({} outside a cycle). Data-parallel ranks still
        hold their own partial gradients (``_sum_grads`` runs at the end of
        the cycle): a copy is summed over the data group. fsdp's are summed
        already (its reduce-scatter runs at every backward)."""
        if self._accum_count == 0:
            return {}
        if self.sharded or not is_dist():
            grads = [None if p.grad is None else p.grad.detach().clone()
                     for p in self._params]
        else:
            grads = self._summed_grads(inplace=False)
        return {n: (self._whole(n, g, True) if full else g)
                for n, g in zip(self._param_names, grads) if g is not None}

    def _restore_accum(self, count: int, grads: Dict[str, torch.Tensor]):
        """Resume a ``grad_accum`` cycle: the saved sum on data coordinate 0
        and zeros on the other data-parallel ranks (their sum is the saved
        sum), each rank's shard of it under fsdp and its slice under tensor
        parallelism; a parameter without a saved gradient has none on any
        rank."""
        count = int(count or 0)
        if count >= self._grad_accum:
            raise ValueError(
                f"the checkpoint holds {count} steps of a grad_accum cycle; "
                f"train.grad_accum={self._grad_accum}")
        for name, p in zip(self._param_names, self._params):
            g = grads.get(name) if count else None
            if g is None:
                p.grad = None
            elif self.sharded or self.data_rank == 0:
                p.grad = self._shard_like(name, g, p)
            else:
                p.grad = torch.zeros_like(p)
        self._accum_count = count

    def save_model_dict(self, path: Optional[Path] = None):
        """Every rank calls it. The pickle backend: the state is gathered
        (fsdp's shards whole, the grad_accum cycle's partial gradients
        summed) and rank 0 writes; every rank returns once the file is in
        place. The orbax backend: every rank hands its shards to the
        collective asynchronous save (committed by the next save or
        ``ckpt_backend.wait()``)."""
        path = Path(path) if path else self.model_file
        backend = self.ckpt_backend
        full = not backend.collective or self.split is not None
        meta = {
            "num_it": self.num_it,
            "num_epoch": self.num_epoch,
            "cfgtxt": json.dumps(self.cfg.to_dict()),
            "best_met": self.best_met,
            "scheduler_state_dict": {"plateau_wait": self.plateau_wait,
                                     "lr": self._lr},
            "dropout_rng": self.dropout_gen.get_state(),
            "world_size": self.world_size,
            "accum_count": self._accum_count,
        }
        # fsdp's and the model axis's gathers and the data-parallel sum of a
        # cycle in flight are collectives; the rest is needed where it is
        # written
        writes = backend.collective or self.is_main
        gathers = writes or self.sharded or self.split is not None
        model_state = self._model_state(full) if gathers else None
        opt_state = self._opt_state(full) if gathers else None
        accum = self._accum_state(full)
        if writes:
            backend.save(path, model_state, opt_state, meta, accum)
        if self._stale_preempt is not None and path == self.model_file:
            # a newer checkpoint now lies where resume reads
            stale, self._stale_preempt = self._stale_preempt, None
            if backend.collective or self.is_main:
                backend.delete(stale)
        synchronize()

    def load_model_dict(self, resume_path: str, load_opt: bool = False):
        """Restore a checkpoint written by any number of processes on any
        mesh: the backends return whole tensors (model, Adam's moments,
        BatchNorm statistics, the gradients of a grad_accum cycle in
        flight), which load into this run's layout (its shards under
        fsdp), and the counters. Every rank takes the one dropout generator
        state (a checkpoint written when each rank had its own generator
        also holds ``dropout_rng_by_rank``; its ``dropout_rng`` is rank
        0's, which every rank takes). A resize
        needs the new number of ranks to divide the global batches, which
        ``build_learner`` holds; the ranks' steps do not depend on their
        number, so the resumed run is the straight run on the new ranks.
        With ``load_opt`` the optimizer state and a ``grad_accum`` cycle in
        flight (its count and summed gradients, as ``optax.MultiSteps``'
        ``mini_step`` and ``acc_grads`` in the JAX package's checkpoint)
        are restored, so the next update equals the straight run's.

        Parameters take the checkpoint's dtype (``models.common.take_dtypes``),
        as the JAX package's restore does (flax's ``from_bytes`` /
        ``from_state_dict`` keep the saved arrays' dtype): a float32
        checkpoint resumed with ``train.param_dtype=bfloat16`` goes on in
        float32, its Adam state too."""
        loaded = self.ckpt_backend.load(resume_path)
        if loaded is None:
            self.logger.info("no checkpoint at %s; starting fresh",
                             resume_path)
            return
        meta = loaded["meta"]
        saved_world = int(meta.get("world_size", 1))
        for model in dict.fromkeys((self.model, self.eval_model)):
            take_dtypes(model, loaded["model"])
        target = self.model.state_dict()
        self.model.load_state_dict(
            {k: self._shard_like(k, v, target[k]) if k in target else v
             for k, v in loaded["model"].items()}, strict=True)
        self.num_it = meta.get("num_it", 0)
        self.num_epoch = meta.get("num_epoch", 0)
        self.best_met = meta.get("best_met", None)
        if meta.get("dropout_rng") is not None:
            self.dropout_gen.set_state(meta["dropout_rng"])
        if saved_world != self.world_size:
            self.update_log_file(
                f"resumed a {saved_world}-process checkpoint on "
                f"{self.world_size} processes")
        if load_opt and self.ckpt_backend.has_opt(loaded):
            sched = meta.get("scheduler_state_dict") or {}
            self.plateau_wait = int(sched.get("plateau_wait", 0))
            pending = {"opt": loaded["opt"], "lr": sched.get("lr"),
                       "accum_count": meta.get("accum_count", 0),
                       "accum": loaded.get("accum") or {}}
            if self.optimizer is None:
                # the optimizer is made at fit(); prepare_optimizer takes it
                self._pending_opt = pending
            else:
                self._restore_opt(pending)
        self.logger.info("resumed from %s at epoch %d it %d", resume_path,
                         self.num_epoch, self.num_it)
