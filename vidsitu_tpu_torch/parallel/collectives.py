"""Process-level helpers over ``torch.distributed`` (port of
vidsitu_tpu/parallel/collectives.py; reference: utils/trn_utils.py:44-129).

Without a process group every helper returns what one process would: rank
0, world size 1, the input unchanged. Reductions of host scalars run in
float64 (the JAX package's ``reduce_dict`` gathers float32 arrays: without
x64 ``process_allgather`` drops the float64 it was given). The tensors of a
reduction live on the CPU for gloo and on this rank's card for NCCL.

Under a mesh with a ``model`` axis of extent > 1 (tensor parallelism,
``parallel/tensor.py``) the ranks of one model group hold the same
examples: what sums over examples (the loss's count, BatchNorm's sums, the
gradients, a validation loss) sums over the *data group*, the ranks that
share this rank's model coordinate, and what the split layers reduce sums
over the *model group*. ``parallel.mesh.make_mesh`` records both
(:func:`set_axis_groups`); without a model axis the data group is every
rank and there is no model group.

A mid-run resize (``train.learner.Learner.request_resize``) shrinks the run
to ranks 0..n-1. ``torch.distributed`` cannot shrink the default group, so
the survivors record a *world group* of their own (:func:`set_world_group`)
and every helper here reduces over it: ``get_rank`` / ``get_world_size``,
``synchronize``, the objects' broadcast and gather, the float64 sums, and
the data group where no ``model`` axis makes one. A rank that left
(:func:`leave`) takes part in no collective: its ``synchronize`` returns at
once.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist


def is_dist() -> bool:
    """True when a process group is initialized (of any size)."""
    return dist.is_available() and dist.is_initialized()


# the ranks of the run: None is the default group (every rank); after a
# resize, the survivors' group. ``left``: this rank left the run at a resize
_WORLD: Dict[str, Any] = {"group": None, "left": False}


def set_world_group(group=None) -> None:
    """The ranks of the run from now on (None: the default group)."""
    _WORLD.update(group=group, left=False)


def leave() -> None:
    """This rank left the run at a resize: it joins no collective again."""
    _WORLD.update(group=None, left=True)


def world_group():
    """The group of every rank of the run; None is the default group."""
    return _WORLD["group"]


def _or_world(group):
    return world_group() if group is None else group


def get_rank() -> int:
    return dist.get_rank(world_group()) if is_dist() else 0


def get_world_size() -> int:
    return dist.get_world_size(world_group()) if is_dist() else 1


def is_main_process() -> bool:
    return get_rank() == 0


# the groups of the mesh's axes, set by parallel.mesh.make_mesh: None for
# the data group is the default group (every rank); None for the model
# group is no tensor parallelism
_AXIS_GROUPS: Dict[str, Any] = {"data": None, "model": None}


def set_axis_groups(data=None, model=None) -> None:
    _AXIS_GROUPS.update(data=data, model=model)


def data_group():
    """The ranks that split the batch with this one (data x fsdp): the
    world group without a model axis (None: the default group)."""
    return _or_world(_AXIS_GROUPS["data"])


def model_group():
    """The ranks that hold this rank's examples and split its tensor-
    parallel layers; None without tensor parallelism."""
    return _AXIS_GROUPS["model"]


def data_world_size() -> int:
    return dist.get_world_size(data_group()) if is_dist() else 1


def data_rank() -> int:
    """This rank's coordinate on the data x fsdp axes: its loader shard and
    its rows of a global batch."""
    return dist.get_rank(data_group()) if is_dist() else 0


def model_world_size() -> int:
    group = model_group()
    return dist.get_world_size(group) if is_dist() and group else 1


def model_rank() -> int:
    group = model_group()
    return dist.get_rank(group) if is_dist() and group else 0


def synchronize() -> None:
    """Barrier across every rank of the run (reference synchronize,
    trn_utils.py:64); nothing on a rank that left it."""
    if not _WORLD["left"] and get_world_size() > 1:
        dist.barrier(group=world_group())


def collective_device() -> torch.device:
    """Where the host-side reductions' tensors go: NCCL takes only CUDA
    tensors, gloo takes CPU ones."""
    if is_dist() and dist.get_backend(world_group()) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _sum_float64(values: List[float], group=None) -> List[float]:
    t = torch.tensor(values, dtype=torch.float64, device=collective_device())
    dist.all_reduce(t, group=_or_world(group))
    return t.tolist()


def _size(group) -> int:
    return dist.get_world_size(_or_world(group)) if is_dist() else 1


def reduce_dict(input_dict: Dict[str, float], average: bool = True,
                group: Optional[Any] = None) -> Dict:
    """Sum (or mean) of a dict of host scalars over the ranks of ``group``
    (None: every rank of the run), in float64 (reference reduce_dict,
    trn_utils.py:79-103)."""
    world = _size(group)
    if world == 1:
        return dict(input_dict)
    keys = sorted(input_dict)
    summed = _sum_float64([float(input_dict[k]) for k in keys], group)
    return {k: (v / world if average else v) for k, v in zip(keys, summed)}


def reduce_dict_corr(input_dict: Dict[str, float], nums: float,
                     group: Optional[Any] = None) -> Dict:
    """Count-weighted mean over the ranks of ``group`` (None: every rank
    of the run),
    in float64: each rank's values weighted by its ``nums`` (reference
    reduce_dict_corr, trn_utils.py:106-121)."""
    if _size(group) == 1:
        return dict(input_dict)
    keys = sorted(input_dict)
    summed = _sum_float64([float(input_dict[k]) * float(nums) for k in keys]
                          + [float(nums)], group)
    total = summed[-1]
    return {k: v / max(total, 1e-8) for k, v in zip(keys, summed[:-1])}


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``obj`` of rank ``src`` on every rank (picklable objects)."""
    if get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=world_group())
    return box[0]


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order, on every rank."""
    if get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, obj, group=world_group())
    return out
