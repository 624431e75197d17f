"""The process group, each rank's device and the data-parallel mesh (port
of vidsitu_tpu/parallel/mesh.py:21-95; reference: utils/trn_dist_utils.py).

One process per GPU, launched by ``torchrun``, which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT``::

    torchrun --standalone --nproc_per_node=8 -m vidsitu_tpu_torch.main \\
        vb_run --task_type=vb --device=cuda

Parameters are replicated and the global batch is split over the ranks
along the one mesh axis, ``data``. The JAX package's ``fsdp`` and ``model``
axes (ZeRO-3, Megatron tensor parallelism: ``tp_spec``,
``param_shardings``) are not ported (ROADMAP.md, Queue 1 item 6).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .collectives import is_dist

# the process group's timeout: a collective that waits longer raises
TIMEOUT_S = 1800.0
NOT_PORTED_AXES = ("fsdp", "model")


def rank_device(device, local_rank: int) -> torch.device:
    """This rank's device: ``cuda`` is ``cuda:{local_rank}`` (raises when
    the host has fewer cards; never wraps around), ``cuda:N`` puts every
    rank on card N, ``cpu`` is the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False")
    if dev.index is None:
        n = torch.cuda.device_count()
        if local_rank >= n:
            raise RuntimeError(
                f"--device=cuda on LOCAL_RANK {local_rank} but this host has "
                f"{n} CUDA device(s): start at most {n} processes a host, or "
                "name one card (--device=cuda:0) for every rank")
        dev = torch.device("cuda", local_rank)
    return dev


def init_distributed(device="cuda", backend: Optional[str] = None,
                     timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the process group that ``torchrun``'s variables describe and
    return this rank's device.

    The group is initialized when ``WORLD_SIZE`` > 1, or when ``backend``
    is named (a group of one rank then runs the several-process code
    path). ``backend`` defaults to NCCL for CUDA devices and gloo for the
    CPU; NCCL refuses two ranks on one card, gloo takes them. A group that
    exists already is kept. A failed initialization raises."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and not backend and not is_dist():
        from ..extract import resolve_device

        return resolve_device(device)
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", "0")))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if is_dist():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"--dist_backend={backend}: nccl or gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"NCCL needs CUDA devices, not {dev}")
    dist.init_process_group(
        backend, init_method="env://",
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None)
    return dev


def check_axes(cfg) -> None:
    """Raise for the mesh axes the port does not have."""
    names = tuple(cfg.tpu.mesh_axis_names)
    bad = [a for a in names if a in NOT_PORTED_AXES]
    if bad:
        raise NotImplementedError(
            f"mesh axes {bad} (cfg.tpu.mesh_axis_names={list(names)}): "
            "fsdp / tensor parallelism are not ported (ROADMAP.md, Queue 1 "
            "item 6); the port splits the batch over one 'data' axis")


def make_mesh(cfg, device_type: str = "cpu"):
    """The 1-D ``DeviceMesh`` ``('data',)`` over every rank of the process
    group (which must exist)."""
    from torch.distributed.device_mesh import init_device_mesh

    check_axes(cfg)
    if not is_dist():
        raise RuntimeError("make_mesh needs a process group "
                           "(parallel.mesh.init_distributed)")
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))


def data_extent(mesh) -> int:
    """How many ways the batch axis is split: the ``data`` axis's size."""
    return int(mesh.size(0))
