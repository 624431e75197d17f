"""Flax variables -> the port's ``state_dict`` (weight carry-over).

The port's modules carry the flax module names (models/video_backbone.py),
so the map is a rename plus a transpose:

  params/.../kernel (T,H,W,Cin,Cout) -> .../weight (Cout,Cin,T,H,W)   conv
  params/.../kernel (Din, Dout)      -> .../weight (Dout, Din)         dense
  params/.../bias                    -> .../bias          conv, dense, BN
  params/.../scale                   -> .../weight        BN gamma
  batch_stats/.../mean, var          -> .../running_mean, running_var

``variables`` is a nested mapping of numpy arrays in the layout that
``vidsitu_tpu``'s ``VbVideoModel.init`` produces, or that
``vidsitu_tpu.convert.slowfast_torch.convert_sfbase_checkpoint`` returns
for a PySlowFast checkpoint, so both packages load a checkpoint the same
way.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Nested flax ``{'params', 'batch_stats'}`` numpy tree -> state_dict
    (float32 tensors; BatchNorm step counters set to 0)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables.get("params", {})):
        *mod, name = path
        arr = _tensor(leaf)
        if name == "kernel":
            if arr.dim() == 5:
                arr = arr.permute(4, 3, 0, 1, 2)
            elif arr.dim() == 2:
                arr = arr.t()
            else:
                raise ValueError(f"kernel of rank {arr.dim()} at {path}")
            name = "weight"
        elif name == "scale":
            name = "weight"
        elif name != "bias":
            raise ValueError(f"unknown flax param {'/'.join(path)}")
        sd[".".join(mod + [name])] = arr.contiguous()
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        *mod, name = path
        if name not in ("mean", "var"):
            raise ValueError(f"unknown flax batch stat {'/'.join(path)}")
        sd[".".join(mod + ["running_" + name])] = _tensor(leaf)
        sd[".".join(mod + ["num_batches_tracked"])] = torch.tensor(0)
    return sd


def load_flax_variables(module: nn.Module, variables: Mapping) -> None:
    """Load flax variables into ``module`` with ``strict=True``: every
    parameter and statistic must be present, and nothing else."""
    module.load_state_dict(flax_to_state_dict(variables), strict=True)


def seeded_variables(module: nn.Module, seed: int) -> Dict[str, Any]:
    """Random weights for ``module`` as a flax-layout numpy tree, made from
    ``seed`` with numpy. Conv and dense kernels are normal with std
    fan_in**-0.5, biases small; BatchNorm gammas lie in [0.5, 1] and
    running variances in [0.5, 1.5], so that no block is an identity (flax
    initialises the non-local and final-bottleneck gammas to zero)."""
    rng = np.random.default_rng(seed)
    tree: Dict[str, Any] = {}

    def put(coll: str, mod, name: str, value: np.ndarray):
        d = tree.setdefault(coll, {})
        for m in mod:
            d = d.setdefault(m, {})
        d[name] = value.astype(np.float32)

    for key, t in module.state_dict().items():
        *mod, name = key.split(".")
        shape = tuple(t.shape)
        if name == "num_batches_tracked":
            continue
        if name == "weight" and len(shape) in (2, 5):
            fan_in = int(np.prod(shape[1:]))
            w = rng.standard_normal(shape) * fan_in ** -0.5
            put("params", mod, "kernel",
                w.T if len(shape) == 2 else w.transpose(2, 3, 4, 1, 0))
        elif name == "weight":
            put("params", mod, "scale", rng.uniform(0.5, 1.0, shape))
        elif name == "bias":
            put("params", mod, "bias", 0.02 * rng.standard_normal(shape))
        elif name == "running_mean":
            put("batch_stats", mod, "mean", 0.1 * rng.standard_normal(shape))
        elif name == "running_var":
            put("batch_stats", mod, "var", rng.uniform(0.5, 1.5, shape))
        else:
            raise ValueError(f"no flax counterpart for {key}")
    return tree
