"""Training engine: the Learner (port of vidsitu_tpu/train/learner.py;
reference: utils/trn_utils.py:315-939), on one device per process, one
process or several (``torch.distributed``, ``parallel/``).

The JAX package's lifecycle, kept: log-dir scaffolding, resume by uid, fit
with per-epoch validation and a best-metric checkpoint (strict: a tie is no
improvement), reduce-on-plateau, EMA loss smoothing, the tracker, SIGTERM
preemption to a separate checkpoint, overfit-batch. The train step is eager
PyTorch:

  * Adam(0.9, 0.99, eps 1e-8) with the lr in the param group, so plateau
    changes it in place (``optax.inject_hyperparams(adam)``);
  * ``train.grad_accum`` = k is ``optax.MultiSteps``: the mean of k
    gradients, one update every k steps;
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
gradients are summed, not averaged, in one flat all-reduce before the
update (every ``grad_accum``-th step; a parameter without a gradient on
every rank keeps none). Each rank draws dropout from its own generator,
seeded from ``(train.seed, rank)``; rank 0 writes the logs, the tracker and
the checkpoints, which hold every rank's generator state (a checkpoint
resumes on any number of ranks that divides the global batches:
``load_model_dict``); rank 0's validation results reach every rank, so
best-metric, plateau and save decisions agree; SIGTERM is honoured at the
epoch boundary, once any rank has seen it (``_sync_preempt_flag``).
"""

from __future__ import annotations

import json
import logging
import signal
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..parallel.collectives import (
    all_gather_object,
    broadcast_object,
    collective_device,
    get_rank,
    get_world_size,
    is_dist,
    synchronize,
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


def dropout_seed(seed: int, rank: int, num_it: int = 0) -> int:
    """Rank ``rank``'s dropout seed: ``seed`` on rank 0 (a one-process run
    draws what it drew before), distinct on every other rank; ``num_it`` > 0
    for a rank that joins a resumed run without a saved state, so that it
    does not repeat the masks a fresh run's rank drew from iteration 0
    (64 bits, as ``torch.Generator.manual_seed`` takes)."""
    return (int(seed) + (int(rank) << 32) + (int(num_it) << 48)) % 2 ** 64


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
                 device, loss_keys=("loss",)):
        from .checkpoint import get_backend
        from .pretrained import make_freeze_mask

        self.uid = uid
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model
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
        self._pending_opt = None  # optimizer state stashed by a resume
        self._pending_lr = None
        self._preempt_requested = False
        self._stale_preempt = None  # consumed preempt ckpt, deleted on save
        self.ckpt_backend = get_backend(cfg.train.ckpt_backend)
        self.rank, self.world_size = get_rank(), get_world_size()
        self.is_main = self.rank == 0
        # the dropout masks' random state, on the training device; the only
        # random state of a step (the JAX package's rng)
        self.dropout_gen = torch.Generator(device=self.device).manual_seed(
            dropout_seed(cfg.train.seed, self.rank))
        frozen = make_freeze_mask(cfg, model)
        params = dict(model.named_parameters())
        self._frozen = [params[n] for n in frozen] if frozen else []
        self._params = list(params.values())
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
        restored here, with its lr."""
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=lr, betas=(0.9, 0.99), eps=1e-8)
        self._lr = lr
        self._accum_count = 0
        if self._pending_opt is not None:
            self.optimizer.load_state_dict(self._pending_opt)
            self._pending_opt = None
            restored = self._pending_lr
            if restored is None:
                restored = self.optimizer.param_groups[0]["lr"]
            self._set_lr(float(restored))
            self._pending_lr = None
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
        with dropout_generator(self.dropout_gen):
            loss = self.model(batch)["loss"]
        (loss / self._grad_accum).backward()
        self._accum_count += 1
        if self._accum_count == self._grad_accum:
            if is_dist():
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
            torch.distributed.all_reduce(loss)
        return loss

    def _sum_grads(self):
        """Sum the ranks' gradients in one flat all-reduce, with a flag per
        parameter: one that has no gradient on any rank keeps none (Adam
        then leaves it alone, as on one process), one that has a gradient
        on some rank takes zeros where it has none."""
        params = self._params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        flags = torch.tensor([p.grad is not None for p in params],
                             dtype=grads[0].dtype, device=grads[0].device)
        flat = torch.cat([g.reshape(-1) for g in grads] + [flags])
        torch.distributed.all_reduce(flat)
        sizes = [g.numel() for g in grads] + [len(params)]
        *parts, flags = flat.split(sizes)
        for p, g, part, any_grad in zip(params, grads, parts,
                                         flags.tolist()):
            p.grad = g.copy_(part.view(g.shape)) if any_grad else None

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
                flag, op=torch.distributed.ReduceOp.MAX)
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
        was_training = self.model.training
        self.model.eval()
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
        except Exception as e:
            # every improving epoch saved at once: nothing more to save
            self.update_log_file(f"exited due to exception {e!r}")
            self.update_log_file(f"elapsed {time.time() - st_time:.1f}s")
            tracker.end_run()
            raise
        finally:
            restore_sig()
        self.update_log_file(
            f"epochs done. elapsed {time.time() - st_time:.1f}s")
        tracker.log_artifact(self.txt_log_file)
        tracker.end_run()

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
    def save_model_dict(self, path: Optional[Path] = None):
        """Every rank calls it (the ranks' dropout generator states are
        gathered); rank 0 writes; every rank returns once the file is in
        place."""
        path = Path(path) if path else self.model_file
        rng_by_rank = all_gather_object(self.dropout_gen.get_state())
        if self.is_main:
            model_state = {k: v.detach().cpu()
                           for k, v in self.model.state_dict().items()}
            opt_state = (self.optimizer.state_dict()
                         if self.optimizer is not None else None)
            meta = {
                "num_it": self.num_it,
                "num_epoch": self.num_epoch,
                "cfgtxt": json.dumps(self.cfg.to_dict()),
                "best_met": self.best_met,
                "scheduler_state_dict": {"plateau_wait": self.plateau_wait,
                                         "lr": self._lr},
                "dropout_rng": rng_by_rank[0],
                "world_size": self.world_size,
            }
            if self.world_size > 1:
                meta["dropout_rng_by_rank"] = rng_by_rank
            self.ckpt_backend.save(path, model_state, opt_state, meta)
        if self._stale_preempt is not None and path == self.model_file:
            # a newer checkpoint now lies where resume reads
            stale, self._stale_preempt = self._stale_preempt, None
            if self.is_main:
                self.ckpt_backend.delete(stale)
        synchronize()

    def load_model_dict(self, resume_path: str, load_opt: bool = False):
        """Restore a checkpoint written by any number of processes: it holds
        whole tensors (model, Adam's moments, BatchNorm statistics) and the
        counters, which load as they are. Rank r takes the dropout
        generator state that rank r saved; a rank the saving run did not
        have draws from a generator seeded from ``(train.seed, rank,
        num_it)`` (a one-process checkpoint's state is rank 0's). A resize
        needs the new number of ranks to divide the global batches, which
        ``build_learner`` holds. Resumes happen at epoch boundaries, or
        from a preemption at a step boundary: a checkpoint holds no
        gradient of a ``train.grad_accum`` cycle in flight (neither does
        the JAX package's)."""
        loaded = self.ckpt_backend.load(resume_path)
        if loaded is None:
            self.logger.info("no checkpoint at %s; starting fresh",
                             resume_path)
            return
        meta = loaded["meta"]
        saved_world = int(meta.get("world_size", 1))
        self.model.load_state_dict(loaded["model"], strict=True)
        self.num_it = meta.get("num_it", 0)
        self.num_epoch = meta.get("num_epoch", 0)
        self.best_met = meta.get("best_met", None)
        rngs = meta.get("dropout_rng_by_rank") or [meta.get("dropout_rng")]
        if self.rank < len(rngs) and rngs[self.rank] is not None:
            self.dropout_gen.set_state(rngs[self.rank])
        else:
            self.dropout_gen.manual_seed(dropout_seed(
                self.cfg.train.seed, self.rank, self.num_it))
        if saved_world != self.world_size:
            self.update_log_file(
                f"resumed a {saved_world}-process checkpoint on "
                f"{self.world_size} processes: each rank's data shard and "
                "dropout stream differ from the original run's")
        if load_opt and self.ckpt_backend.has_opt(loaded):
            sched = meta.get("scheduler_state_dict") or {}
            self.plateau_wait = int(sched.get("plateau_wait", 0))
            if self.optimizer is None:
                # the optimizer is made at fit(); prepare_optimizer takes it
                self._pending_opt = loaded["opt"]
                self._pending_lr = sched.get("lr")
            else:
                self.optimizer.load_state_dict(loaded["opt"])
                if sched.get("lr") is not None:
                    self._set_lr(float(sched["lr"]))
        self.logger.info("resumed from %s at epoch %d it %d", resume_path,
                         self.num_epoch, self.num_it)
