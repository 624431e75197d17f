"""Checkpoints of the Learner (port of vidsitu_tpu/train/checkpoint.py).

Both backends hold the same state: the model's state dict (parameters and
BatchNorm statistics, keyed by name), Adam's state keyed by parameter name
(``torch.distributed.checkpoint.state_dict``'s layout, the same in every
mode: one process, data-parallel ranks or fsdp), the gradients of a
``train.grad_accum`` cycle in flight (summed over the ranks, keyed by name)
and the metadata (``num_it``, ``num_epoch``, ``cfgtxt``, ``best_met``,
``scheduler_state_dict``, ``world_size``, ``accum_count``; the dropout
generator's state under ``dropout_rng``, where the JAX package keeps its
key under ``rng``). ``load`` returns whole tensors on the CPU, whatever
wrote them, so a checkpoint resumes on any number of ranks and any mesh.

  * ``pickle``: one ``torch.save`` file, written by rank 0 from the state
    gathered to it, to a temporary file moved into place with
    ``os.replace`` (a crash mid-write never truncates the only resumable
    checkpoint); a torn or unreadable file loads as ``None``.
  * ``orbax``: :class:`DcpBackend`, the counterpart of the JAX package's
    ``OrbaxBackend`` on ``torch.distributed.checkpoint``: collective and
    asynchronous, each rank writing its own shards.
"""

from __future__ import annotations

import logging
import os
import pickle
import shutil
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional

import torch

MODEL_KEY = "model_state_dict"
OPT_KEY = "optimizer_state_dict"
ACCUM_KEY = "accum_grads"
# what a checkpoint's metadata may hold (the orbax backend refuses others,
# as the JAX package's does)
META_KEYS = {"num_it", "num_epoch", "cfgtxt", "best_met",
             "scheduler_state_dict", "dropout_rng", "world_size",
             "accum_count"}


class PickleBackend:
    """One ``torch.save`` file per checkpoint, written atomically by rank
    0 (``collective`` False: the Learner gathers the state to rank 0)."""

    name = "pickle"
    collective = False

    def save(self, path, model_state: Dict[str, torch.Tensor],
             opt_state: Optional[Dict[str, Any]], meta: Dict[str, Any],
             accum: Optional[Dict[str, torch.Tensor]] = None):
        payload = dict(meta)
        payload[MODEL_KEY] = model_state
        payload[OPT_KEY] = opt_state
        if accum:
            payload[ACCUM_KEY] = accum
        tmp = Path(str(path) + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def load(self, path) -> Optional[Dict[str, Any]]:
        """``{'model', 'opt', 'accum', 'meta'}``, or None when the file is
        missing or unreadable."""
        p = Path(path)
        if not p.is_file():
            return None
        try:
            payload = torch.load(p, map_location="cpu", weights_only=True)
        except (EOFError, RuntimeError, pickle.UnpicklingError,
                zipfile.BadZipFile) as e:
            logging.getLogger("vidsitu_tpu_torch").warning(
                "unreadable checkpoint %s (%s); ignoring", p, e)
            return None
        return {
            "model": payload.get(MODEL_KEY),
            "opt": payload.get(OPT_KEY),
            "accum": payload.get(ACCUM_KEY) or {},
            "meta": {k: v for k, v in payload.items()
                     if k not in (MODEL_KEY, OPT_KEY, ACCUM_KEY)},
        }

    def has_opt(self, loaded) -> bool:
        return bool(loaded.get("opt"))

    def delete(self, path):
        Path(path).unlink(missing_ok=True)

    def wait(self):
        pass

    def regroup(self, n: int):
        """Nothing: rank 0 writes alone (see ``DcpBackend.regroup``)."""


GENERATIONS = ("tree.g0", "tree.g1")
LEGACY = "tree"


def _flat(model_state, opt_state, accum) -> Dict[str, Any]:
    """The backends' state as one flat dict of DCP entries: ``model/<name>``,
    ``opt/<name>/<field>`` (Adam's moments and step), ``opt_groups`` (the
    param groups, an object), ``accum/<name>``. Names hold dots, so the
    layout never nests (DCP would flatten a nested dict by joining keys
    with dots, and the names could not be told apart again)."""
    flat = {f"model/{k}": v for k, v in model_state.items()}
    if opt_state is not None:
        for name, st in opt_state["state"].items():
            flat.update({f"opt/{name}/{f}": v for f, v in st.items()})
        flat["opt_groups"] = opt_state["param_groups"]
    flat.update({f"accum/{k}": v for k, v in (accum or {}).items()})
    return flat


def _unflat(flat: Dict[str, Any]) -> Dict[str, Any]:
    model, state, accum = {}, {}, {}
    for key, v in flat.items():
        kind, _, rest = key.partition("/")
        if kind == "model":
            model[rest] = v
        elif kind == "accum":
            accum[rest] = v
        elif kind == "opt":
            name, _, field = rest.rpartition("/")
            state.setdefault(name, {})[field] = v
    opt = ({"state": state, "param_groups": flat["opt_groups"]}
           if "opt_groups" in flat else None)
    return {"model": model, "opt": opt, "accum": accum}


class DcpBackend:
    """``ckpt_backend=orbax``: the counterpart of the JAX package's
    ``OrbaxBackend`` (vidsitu_tpu/train/checkpoint.py), on
    ``torch.distributed.checkpoint``. The config value stays ``orbax``, so
    that a config written for the JAX package runs unchanged.

    Every rank calls ``save`` (``collective`` True) with its own shards
    (fsdp's DTensors; replicated tensors are written once: under tensor
    parallelism the Learner gathers the split tensors whole first, so every
    name has one shape on every rank), and
    ``dcp.async_save`` writes them in the background; there is no gather to
    rank 0. Durability as orbax's: saves alternate between two generation
    directories, ``tree.g0`` and ``tree.g1``, inside the checkpoint's
    directory, and rank 0 publishes a ``LIVE`` pointer (tmp + rename) once
    the save has committed (``wait``, or the next save), so a crash at any
    point leaves the pointed-to generation intact. The next generation is
    tracked in memory after the first save or load, so the ranks agree
    without reading a pointer that rank 0 may be rewriting. A legacy
    single ``tree`` directory still loads. Metadata keys outside
    ``META_KEYS`` are refused.

    The collectives of a save run in a background thread and those of a
    load on the host: both take a gloo group of every rank (made once; the
    default group may be NCCL). ``load`` reads every shard into whole CPU
    tensors on every rank (as the JAX backend restores host arrays), so a
    checkpoint resumes on any world size and mesh."""

    name = "orbax"
    collective = True

    def __init__(self):
        self._future = None
        self._pending_live = None  # (dir, generation) of the save in flight
        self._next_gen: Dict[str, str] = {}
        self._group = None

    def _pg(self):
        from ..parallel.collectives import is_dist

        if not is_dist():
            return None
        if self._group is None:
            self._group = torch.distributed.new_group(backend="gloo")
        return self._group

    def regroup(self, n: int):
        """A resize to ranks 0..n-1: every rank of the process group calls
        it (the group is made over the default group), and the survivors'
        later saves and loads take their own gloo group."""
        from ..parallel.collectives import get_rank

        self.wait()
        group = torch.distributed.new_group(list(range(n)), backend="gloo")
        self._group = group if get_rank() < n else None

    @staticmethod
    def _dir(path) -> Path:
        return Path(path).resolve()

    @staticmethod
    def _live_gen(d: Path) -> Optional[str]:
        ptr = d / "LIVE"
        if ptr.is_file():
            try:
                name = ptr.read_text().strip()
            except OSError:
                return None
            if name in GENERATIONS and (d / name / ".metadata").is_file():
                return name
        return None

    def save(self, path, model_state, opt_state, meta: Dict[str, Any],
             accum=None):
        import torch.distributed.checkpoint as dcp

        from ..parallel.collectives import get_rank

        unknown = set(meta) - META_KEYS
        if unknown:
            raise ValueError(f"orbax backend does not persist meta keys "
                             f"{sorted(unknown)}; add them to META_KEYS")
        self.wait()  # one save in flight at a time (and publish it)
        d = self._dir(path)
        if get_rank() == 0:
            d.mkdir(parents=True, exist_ok=True)
        gen = self._next_gen.get(str(d))
        if gen is None:
            live = self._live_gen(d)
            gen = GENERATIONS[1] if live == GENERATIONS[0] else GENERATIONS[0]
        self._next_gen[str(d)] = GENERATIONS[1 - GENERATIONS.index(gen)]
        pg = self._pg()
        if pg is not None:
            torch.distributed.barrier(group=pg)  # the directory exists
        if get_rank() == 0 and (d / gen).exists():
            shutil.rmtree(d / gen)  # never the live generation
        if pg is not None:
            torch.distributed.barrier(group=pg)
        state = _flat(model_state, opt_state, accum)
        state["meta"] = dict(meta)
        self._future = dcp.async_save(
            state, checkpoint_id=str(d / gen), process_group=pg,
            planner=dcp.DefaultSavePlanner(flatten_state_dict=False))
        self._pending_live = (d, gen)

    def wait(self):
        """Wait for the save in flight, then publish its generation."""
        from ..parallel.collectives import get_rank

        if self._future is None:
            return
        future, self._future = self._future, None
        future.result()
        d, gen = self._pending_live
        self._pending_live = None
        pg = self._pg()
        if pg is not None:
            # every rank's writes are done before the pointer moves
            torch.distributed.barrier(group=pg)
        if get_rank() == 0:
            tmp = d / "LIVE.tmp"
            tmp.write_text(gen)
            os.replace(tmp, d / "LIVE")

    def load(self, path) -> Optional[Dict[str, Any]]:
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.metadata import (
            TensorStorageMetadata,
        )

        self.wait()
        d = self._dir(path)
        gen = self._live_gen(d)
        if gen is None and (d / LEGACY / ".metadata").is_file():
            gen = LEGACY
        if gen is None:
            return None
        if gen in GENERATIONS:
            # the resumed run's first save must not overwrite this one
            self._next_gen.setdefault(
                str(d), GENERATIONS[1 - GENERATIONS.index(gen)])
        reader = dcp.FileSystemReader(str(d / gen))
        target: Dict[str, Any] = {}
        for key, md in reader.read_metadata().state_dict_metadata.items():
            if isinstance(md, TensorStorageMetadata):
                target[key] = torch.empty(md.size,
                                          dtype=md.properties.dtype)
            else:
                target[key] = None  # an object, read whole
        dcp.load(target, storage_reader=reader, process_group=self._pg(),
                 planner=dcp.DefaultLoadPlanner(
                     flatten_state_dict=False, flatten_sharded_tensors=False))
        out = _unflat(target)
        out["meta"] = target["meta"]
        return out

    def has_opt(self, loaded) -> bool:
        return bool(loaded.get("opt"))

    def delete(self, path):
        from ..parallel.collectives import get_rank

        self.wait()  # never under a save in flight
        d = self._dir(path)
        self._next_gen.pop(str(d), None)
        if get_rank() == 0 and d.is_dir():
            shutil.rmtree(d)


def get_backend(name: str):
    if name == "pickle":
        return PickleBackend()
    if name == "orbax":
        return DcpBackend()
    raise ValueError(f"unknown ckpt backend {name!r}")
