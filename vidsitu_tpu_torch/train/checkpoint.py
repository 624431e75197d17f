"""Checkpoints of the Learner (port of vidsitu_tpu/train/checkpoint.py).

The port's own format, with the JAX package's ``pickle`` backend semantics:
one file per checkpoint, written to a temporary file and moved into place
with ``os.replace`` (a crash mid-write never truncates the only resumable
checkpoint), a torn or unreadable file loads as ``None``, and the same
metadata payload (``num_it``, ``num_epoch``, ``cfgtxt``, ``best_met``,
``scheduler_state_dict``; the dropout generator's state under
``dropout_rng``, where the JAX package keeps its key under ``rng``) beside
``model_state_dict`` (parameters and BatchNorm statistics) and
``optimizer_state_dict``. Written with ``torch.save`` of state dicts.

The orbax backend is not ported: ``ckpt_backend=orbax`` raises.
"""

from __future__ import annotations

import logging
import os
import pickle
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional

import torch

MODEL_KEY = "model_state_dict"
OPT_KEY = "optimizer_state_dict"


class PickleBackend:
    """One ``torch.save`` file per checkpoint, written atomically."""

    name = "pickle"

    def save(self, path, model_state: Dict[str, torch.Tensor],
             opt_state: Optional[Dict[str, Any]], meta: Dict[str, Any]):
        payload = dict(meta)
        payload[MODEL_KEY] = model_state
        payload[OPT_KEY] = opt_state
        tmp = Path(str(path) + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def load(self, path) -> Optional[Dict[str, Any]]:
        """``{'model', 'opt', 'meta'}``, or None when the file is missing or
        unreadable."""
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
            "meta": {k: v for k, v in payload.items()
                     if k not in (MODEL_KEY, OPT_KEY)},
        }

    def has_opt(self, loaded) -> bool:
        return bool(loaded.get("opt"))

    def delete(self, path):
        Path(path).unlink(missing_ok=True)

    def wait(self):
        pass


def get_backend(name: str):
    if name == "pickle":
        return PickleBackend()
    if name == "orbax":
        raise NotImplementedError(
            "ckpt_backend=orbax is not ported: the port writes its own "
            "format, one torch.save file of state dicts (ckpt_backend=pickle)")
    raise ValueError(f"unknown ckpt backend {name!r}")
