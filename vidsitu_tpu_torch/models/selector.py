"""Compute-dtype selection (port of vidsitu_tpu/models/selector.py:16-24)."""

from __future__ import annotations

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def compute_dtypes(cfg):
    """(compute dtype, parameter dtype) from ``train.dtype`` and
    ``train.param_dtype``."""
    return DTYPES[cfg.train.dtype], DTYPES[cfg.train.param_dtype]
