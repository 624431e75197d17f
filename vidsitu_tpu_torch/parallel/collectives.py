"""Process-level helpers over ``torch.distributed`` (port of
vidsitu_tpu/parallel/collectives.py; reference: utils/trn_utils.py:44-129).

Without a process group every helper returns what one process would: rank
0, world size 1, the input unchanged. Reductions of host scalars run in
float64 (the JAX package's ``reduce_dict`` gathers float32 arrays: without
x64 ``process_allgather`` drops the float64 it was given). The tensors of a
reduction live on the CPU for gloo and on this rank's card for NCCL.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.distributed as dist


def is_dist() -> bool:
    """True when a process group is initialized (of any size)."""
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_dist() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_dist() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """Barrier across every rank (reference synchronize, trn_utils.py:64)."""
    if get_world_size() > 1:
        dist.barrier()


def collective_device() -> torch.device:
    """Where the host-side reductions' tensors go: NCCL takes only CUDA
    tensors, gloo takes CPU ones."""
    if is_dist() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _sum_float64(values: List[float]) -> List[float]:
    t = torch.tensor(values, dtype=torch.float64, device=collective_device())
    dist.all_reduce(t)
    return t.tolist()


def reduce_dict(input_dict: Dict[str, float], average: bool = True) -> Dict:
    """Sum (or mean) of a dict of host scalars over the ranks, in float64
    (reference reduce_dict, trn_utils.py:79-103)."""
    if get_world_size() == 1:
        return dict(input_dict)
    keys = sorted(input_dict)
    summed = _sum_float64([float(input_dict[k]) for k in keys])
    world = get_world_size()
    return {k: (v / world if average else v) for k, v in zip(keys, summed)}


def reduce_dict_corr(input_dict: Dict[str, float], nums: float) -> Dict:
    """Count-weighted mean over the ranks, in float64: each rank's values
    weighted by its ``nums`` (reference reduce_dict_corr,
    trn_utils.py:106-121)."""
    if get_world_size() == 1:
        return dict(input_dict)
    keys = sorted(input_dict)
    summed = _sum_float64([float(input_dict[k]) * float(nums) for k in keys]
                          + [float(nums)])
    total = summed[-1]
    return {k: v / max(total, 1e-8) for k, v in zip(keys, summed[:-1])}


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``obj`` of rank ``src`` on every rank (picklable objects)."""
    if get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order, on every rank."""
    if get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out
