"""File IO helpers (reference: utils/dat_utils.py:294-311)."""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Any

import numpy as np


def read_file_with_assertion(fpath, read_type: str = "r", reader: str = "json"):
    fpath1 = Path(fpath)
    if read_type == "r":
        assert fpath1.exists(), f"{fpath1} doesn't exist"
        if reader == "json":
            with open(fpath1, "r") as f:
                return json.load(f)
        elif reader == "pickle":
            with open(fpath1, "rb") as f:
                return pickle.load(f)
        elif reader == "numpy":
            return np.load(fpath1)
        raise NotImplementedError(reader)
    elif read_type == "w":
        assert fpath1.parent.exists()
        return None
    raise NotImplementedError(read_type)


def write_json(obj: Any, fpath) -> None:
    Path(fpath).parent.mkdir(parents=True, exist_ok=True)
    with open(fpath, "w") as f:
        json.dump(obj, f)


def write_pickle(obj: Any, fpath) -> None:
    Path(fpath).parent.mkdir(parents=True, exist_ok=True)
    with open(fpath, "wb") as f:
        pickle.dump(obj, f)


def read_pickle(fpath) -> Any:
    with open(fpath, "rb") as f:
        return pickle.load(f)


def read_json(fpath) -> Any:
    with open(fpath, "r") as f:
        return json.load(f)
