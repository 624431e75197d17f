"""The process group, each rank's device, the mesh and fsdp (port of
vidsitu_tpu/parallel/mesh.py:21-95, 156-199; reference:
utils/trn_dist_utils.py).

One process per GPU, launched by ``torchrun``, which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT``::

    torchrun --standalone --nproc_per_node=8 -m vidsitu_tpu_torch.main \\
        vb_run --task_type=vb --device=cuda

The mesh is ``tpu.mesh_shape`` over ``tpu.mesh_axis_names``, as the JAX
package's: ``data`` replicates the parameters, ``fsdp`` shards them
(ZeRO-3, ``torch.distributed.fsdp.fully_shard``), and the global batch is
split over data x fsdp, i.e. over every rank. An fsdp run::

    torchrun --standalone --nproc_per_node=4 -m vidsitu_tpu_torch.main \\
        vb_run --task_type=vb --device=cuda \\
        --tpu.mesh_shape='[2, -1]' --tpu.mesh_axis_names="['data', 'fsdp']"

The ``model`` axis is the JAX package's Megatron tensor parallelism
(``tp_spec``; ``parallel/tensor.py``): the ranks along it hold the same
examples and split the transformer layers' heads and FFN columns, and the
batch is split over data x fsdp only. A run on 2 data x 2 model ranks::

    torchrun --standalone --nproc_per_node=4 -m vidsitu_tpu_torch.main \\
        srl_run --task_type=vb_arg --device=cuda \\
        --tpu.mesh_shape='[-1, 2]' --tpu.mesh_axis_names="['data', 'model']"

``make_mesh`` records the data and model groups of this rank
(``collectives.set_axis_groups``), which the loss, BatchNorm, the Learner,
the evaluators and the split layers reduce over.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from .collectives import is_dist, set_axis_groups, set_world_group

# the process group's timeout: a collective that waits longer raises
TIMEOUT_S = 1800.0
KNOWN_AXES = ("data", "fsdp", "model")


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
    set_axis_groups()  # a new group: no mesh's groups yet
    set_world_group()
    return dev


def check_axes(cfg) -> None:
    """Raise for an axis name the port does not know, or one named twice."""
    names = tuple(cfg.tpu.mesh_axis_names)
    unknown = [a for a in names if a not in KNOWN_AXES]
    if unknown or len(set(names)) != len(names):
        raise ValueError(f"cfg.tpu.mesh_axis_names={list(names)}: each of "
                         f"{list(KNOWN_AXES)} at most once")


def mesh_shape(cfg, world: int) -> tuple:
    """``cfg.tpu.mesh_shape`` over ``world`` ranks, as the JAX ``make_mesh``
    reads it: one ``-1`` is filled from the world size; a shape whose
    product is not the world size raises."""
    check_axes(cfg)
    names = tuple(cfg.tpu.mesh_axis_names)
    shape = [int(s) for s in cfg.tpu.mesh_shape]
    if len(shape) != len(names) or shape.count(-1) > 1 or any(
            s == 0 or s < -1 for s in shape):
        raise ValueError(f"cfg.tpu.mesh_shape={shape} over axes "
                         f"{list(names)}: one size per axis, at most one -1")
    fixed = math.prod(s for s in shape if s != -1)
    shape = [world // fixed if s == -1 else s for s in shape]
    if math.prod(shape) != world:
        raise ValueError(f"cfg.tpu.mesh_shape={list(cfg.tpu.mesh_shape)} "
                         f"-> {shape} does not cover the {world} ranks")
    return tuple(shape)


def make_mesh(cfg, device_type: str = "cpu"):
    """The ``DeviceMesh`` of ``cfg.tpu.mesh_shape`` / ``mesh_axis_names``
    over every rank of the process group (which must exist); records this
    rank's data and model groups (a collective: every rank calls it)."""
    from torch.distributed.device_mesh import init_device_mesh

    check_axes(cfg)
    if not is_dist():
        raise RuntimeError("make_mesh needs a process group "
                           "(parallel.mesh.init_distributed)")
    shape = mesh_shape(cfg, dist.get_world_size())
    mesh = init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(cfg.tpu.mesh_axis_names))
    set_axis_groups(**axis_groups(mesh))
    return mesh


def resized_shape(cfg, n: int):
    """The mesh shape and axis names of a run resized to ``n`` ranks (the
    JAX ``Learner._apply_resize``, learner.py:391-399): ``cfg.tpu.mesh_shape``
    over ``n``, or a pure ``data`` mesh of ``n`` where that shape does not
    tile ``n``."""
    try:
        return mesh_shape(cfg, n), tuple(cfg.tpu.mesh_axis_names)
    except ValueError:
        return (n,), ("data",)


def make_survivors_mesh(shape, names, device_type: str = "cpu"):
    """The groups of a run shrunk to ranks 0..n-1, n = prod(shape): every
    rank of the process group calls it (each group is made over the
    default group, the ranks that leave included, in one order), and the
    survivors get ``(world group, mesh, axis groups)``, the others None.
    The survivors' caller records the groups (``set_world_group``,
    ``set_axis_groups``)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    world = dist.new_group(list(range(n)))
    mesh = DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(names))
    groups = axis_groups(mesh)
    if dist.get_rank() >= n:
        return None
    return world, mesh, groups


def model_extent(mesh) -> int:
    """How many ways the ``model`` axis splits the transformer layers (1
    without one)."""
    names = mesh.mesh_dim_names
    return int(mesh["model"].size()) if "model" in names else 1


def model_coord(mesh) -> int:
    return mesh.get_local_rank("model") if model_extent(mesh) > 1 else 0


def axis_groups(mesh) -> dict:
    """This rank's data group (the ranks of its model coordinate, in
    data x fsdp order: group rank = data coordinate) and model group; with
    no ``model`` axis of extent > 1, ``data=None`` (every rank) and no
    model group. The data groups are made here (every rank makes all of
    them; a rank outside the mesh gets no group)."""
    names = mesh.mesh_dim_names
    if "model" not in names or mesh.mesh.shape[names.index("model")] == 1:
        return {"data": None, "model": None}
    ranks = mesh.mesh.movedim(names.index("model"), 0)
    data, _ = dist.new_subgroups_by_enumeration(
        [ranks[m].flatten().tolist() for m in range(ranks.shape[0])])
    if data is None:  # a rank outside the mesh (make_survivors_mesh)
        return {"data": None, "model": None}
    return {"data": data, "model": mesh["model"].get_group()}


def data_extent(mesh) -> int:
    """How many ways the batch axis is split: the product of the ``data``
    and ``fsdp`` extents (fsdp is a subdivision of data parallelism; the
    ``model`` axis splits weights, not examples)."""
    return math.prod(int(mesh[a].size()) for a in mesh.mesh_dim_names
                     if a in ("data", "fsdp"))


def shards_params(mesh) -> bool:
    """Whether the mesh has an ``fsdp`` axis (of any extent, 1 included)."""
    return mesh is not None and "fsdp" in mesh.mesh_dim_names


def fsdp_blocks(model: torch.nn.Module):
    """The modules that :func:`shard_model` wraps on their own, outermost
    first: the video backbone's bottlenecks and non-local blocks and the
    transformers' layers (encoder, decoder, RoBERTa, relative)."""
    from ..models.rel_transformer import RelEncoderLayer
    from ..models.transformer import EncoderLayer
    from ..models.video_backbone import Bottleneck, NonLocalBlock

    kinds = (Bottleneck, NonLocalBlock, EncoderLayer, RelEncoderLayer)
    out, inside = [], set()
    for name, m in model.named_modules():
        if isinstance(m, kinds) and not any(
                name.startswith(p + ".") for p in inside):
            out.append(m)
            inside.add(name)
    return out


def shard_model(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """ZeRO-3 over ``mesh``'s ``fsdp`` axis (FSDP2's ``fully_shard``): each
    block of :func:`fsdp_blocks`, then the root. With a ``data`` axis too
    the parameters are sharded over ``fsdp`` and replicated over ``data``
    (HSDP); with ``fsdp`` alone, sharded over every rank.

    Each parameter, its gradient and Adam's moments become DTensors sharded
    along dim 0 (padded where the extent does not divide it). The JAX
    package's ``param_shardings`` takes the largest divisible dimension
    instead; the layouts differ, the values do not (the choice of sharding
    is numerically transparent). BatchNorm statistics are buffers and stay
    replicated. FSDP2 divides reduced gradients by the world size, per
    wrapped module: the divide factor is set to 1 on every one of them (and
    the reduction to a plain sum), so that the gradients are summed over
    the ranks as the JAX program's global-batch step sums them. FSDP2 takes contiguous parameters only, so
    the model must not be moved to ``channels_last_3d``."""
    from torch.distributed.fsdp import FSDPModule, fully_shard

    names = mesh.mesh_dim_names
    # over data x fsdp: under a model axis too, each model coordinate's
    # ranks shard its own slices of the split layers
    sub = mesh[("data", "fsdp")] if "data" in names else mesh["fsdp"]
    for block in fsdp_blocks(model):
        fully_shard(block, mesh=sub)
    fully_shard(model, mesh=sub)
    for m in model.modules():
        if isinstance(m, FSDPModule):
            m.set_gradient_divide_factor(1.0)
            # a plain SUM (gloo has no PREMUL_SUM)
            m.set_force_sum_reduction_for_comms(True)
    return model


def is_sharded(model: torch.nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)
