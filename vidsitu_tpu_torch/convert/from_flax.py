"""Flax variables -> the port's ``state_dict`` (weight carry-over).

The port's modules carry the flax module names (models/video_backbone.py),
so the map is a rename plus a transpose:

  params/.../kernel (T,H,W,Cin,Cout) -> .../weight (Cout,Cin,T,H,W)   conv
  params/.../kernel (Din, Dout)      -> .../weight (Dout, Din)         dense
  params/.../{q,k,v}_proj/kernel (D, H, Dh) -> .../weight (H*Dh, D)  attention
  params/.../out_proj/kernel (H, Dh, D)     -> .../weight (D, H*Dh)  (DenseGeneral)
  params/.../{q,k,v}_proj/bias (H, Dh)      -> .../bias (H*Dh,)
  params/.../embedding (V, D)        -> .../weight (V, D)              Embed
  params/.../bias                    -> .../bias      conv, dense, BN, LayerNorm
  params/.../scale                   -> .../weight    BN gamma, LayerNorm scale
  batch_stats/.../mean, var          -> .../running_mean, running_var

``variables`` is a nested mapping of numpy arrays in the layout that
``vidsitu_tpu``'s ``VbVideoModel.init`` produces, or that
``vidsitu_tpu.convert.slowfast_torch.convert_sfbase_checkpoint`` returns
for a PySlowFast checkpoint, so both packages load a checkpoint the same
way. The language models take the same map: RoBERTa's embeddings and
DenseGeneral attention, the evrel MLPs, the LSTM cells' per-gate kernels
(``fwd_l0/ii/kernel``) and the rel-transformer's bias-free projections.

``state_dict_to_flax`` is the inverse, a test aid: it hands weights fitted
in the port to the JAX package. Nothing on a main path calls it.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn


_QKV = ("q_proj", "k_proj", "v_proj")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _tensor(x) -> torch.Tensor:
    """A float32 tensor of ``x``; a bfloat16 or float16 array keeps its
    dtype (a bfloat16 one, ``ml_dtypes``' type as JAX hands it over, is
    taken by its 16-bit pattern, so no ``ml_dtypes`` is needed here)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    if a.dtype == np.float16:
        return torch.from_numpy(a.copy())
    return torch.from_numpy(np.array(a, dtype=np.float32))


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Nested flax ``{'params', 'batch_stats'}`` numpy tree -> state_dict
    (float32 tensors, bfloat16 and float16 leaves in their own dtype;
    BatchNorm step counters set to 0)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables.get("params", {})):
        *mod, name = path
        arr = _tensor(leaf)
        if name == "kernel":
            if arr.dim() == 5:
                arr = arr.permute(4, 3, 0, 1, 2)
            elif arr.dim() == 2:
                arr = arr.t()
            elif arr.dim() == 3 and mod and mod[-1] == "out_proj":
                arr = arr.reshape(-1, arr.shape[-1]).t()
            elif arr.dim() == 3 and mod and mod[-1] in _QKV:
                arr = arr.reshape(arr.shape[0], -1).t()
            else:
                raise ValueError(f"kernel of rank {arr.dim()} at {path}")
            name = "weight"
        elif name in ("scale", "embedding"):
            name = "weight"
        elif name == "bias":
            arr = arr.reshape(-1)  # DenseGeneral q/k/v biases are (H, Dh)
        else:
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


def state_dict_to_flax(sd: Mapping[str, torch.Tensor], module: nn.Module
                       ) -> Dict[str, Any]:
    """The port's ``state_dict`` -> a flax ``{'params', 'batch_stats'}``
    numpy tree (float32), the inverse of :func:`flax_to_state_dict`.
    ``module`` tells the layouts apart: embeddings, attention projections
    (``n_heads`` of their parent, DenseGeneral kernels (D, H, Dh) and (H,
    Dh, D)), conv and dense kernels, scales."""
    modules = dict(module.named_modules())
    tree: Dict[str, Any] = {}

    def put(coll: str, mod, name: str, value: np.ndarray):
        d = tree.setdefault(coll, {})
        for m in mod:
            d = d.setdefault(m, {})
        d[name] = value

    for key, t in sd.items():
        *mod, name = key.split(".")
        arr = t.detach().cpu().to(torch.float32).numpy()
        if name == "num_batches_tracked":
            continue
        heads = None
        if mod and mod[-1] in _QKV + ("out_proj",):
            heads = getattr(modules[".".join(mod[:-1])], "n_heads", None)
        if name in ("running_mean", "running_var"):
            put("batch_stats", mod, name[len("running_"):], arr)
        elif isinstance(modules[".".join(mod)], nn.Embedding):
            put("params", mod, "embedding", arr)
        elif name == "weight" and arr.ndim == 5:
            put("params", mod, "kernel", arr.transpose(2, 3, 4, 1, 0))
        elif name == "weight" and arr.ndim == 2:
            if heads and mod[-1] == "out_proj":
                w = arr.T.reshape(heads, -1, arr.shape[0])
            elif heads:
                w = arr.T.reshape(arr.shape[1], heads, -1)
            else:
                w = arr.T
            put("params", mod, "kernel", w)
        elif name == "weight":
            put("params", mod, "scale", arr)
        elif name == "bias":
            put("params", mod, "bias", arr.reshape(heads, -1)
                if heads and mod[-1] in _QKV else arr)
        else:
            raise ValueError(f"no flax counterpart for {key}")
    return tree


def seeded_variables(module: nn.Module, seed: int) -> Dict[str, Any]:
    """Random weights for ``module`` as a flax-layout numpy tree, made from
    ``seed`` with numpy. Conv and dense kernels are normal with std
    fan_in**-0.5, embeddings with std D**-0.5, biases small; BatchNorm and
    LayerNorm gammas lie in [0.5, 1] and running variances in [0.5, 1.5],
    so that no block is an identity (flax initialises the non-local and
    final-bottleneck gammas to zero). Attention projections (modules with
    ``n_heads``) get the ``DenseGeneral`` layouts."""
    rng = np.random.default_rng(seed)
    tree: Dict[str, Any] = {}
    modules = dict(module.named_modules())

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
        heads = None
        if mod and mod[-1] in _QKV + ("out_proj",):
            heads = getattr(modules[".".join(mod[:-1])], "n_heads", None)
        if isinstance(modules[".".join(mod)], nn.Embedding):
            put("params", mod, "embedding",
                rng.standard_normal(shape) * shape[1] ** -0.5)
        elif name == "weight" and len(shape) in (2, 5):
            fan_in = int(np.prod(shape[1:]))
            w = rng.standard_normal(shape) * fan_in ** -0.5
            if len(shape) == 5:
                w = w.transpose(2, 3, 4, 1, 0)
            elif heads and mod[-1] == "out_proj":  # (H, Dh, D)
                w = w.T.reshape(heads, -1, shape[0])
            elif heads:  # (D, H, Dh)
                w = w.T.reshape(shape[1], heads, -1)
            else:
                w = w.T
            put("params", mod, "kernel", w)
        elif name == "weight":
            put("params", mod, "scale", rng.uniform(0.5, 1.0, shape))
        elif name == "bias":
            b = 0.02 * rng.standard_normal(shape)
            if heads and mod[-1] in _QKV:
                b = b.reshape(heads, -1)
            put("params", mod, "bias", b)
        elif name == "running_mean":
            put("batch_stats", mod, "mean", 0.1 * rng.standard_normal(shape))
        elif name == "running_var":
            put("batch_stats", mod, "var", rng.uniform(0.5, 1.5, shape))
        else:
            raise ValueError(f"no flax counterpart for {key}")
    return tree
