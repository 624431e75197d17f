"""cfg -> a ready Learner (port of vidsitu_tpu/train/build.py; reference:
main_dist.py:94-129): data, model (initialised, pretrained weights,
weights given by the caller), the task's evaluator and the Learner, for
the three tasks: ``vb``, ``vb_arg`` and ``evrel``, training and evaluation,
on one device per process. Under a process group each rank loads its shard
of the global batch (``get_data(cfg, num_shards=data extent,
shard_id=data coordinate)``: the ranks of a ``model`` axis load the same
rows); with a ``model`` mesh axis the transformer layers are split
(``parallel.tensor.shard_tp``) and decode split; with an ``fsdp`` axis a
training model is then sharded (``parallel.mesh.shard_model``) and
evaluates through a copy that is whole on the fsdp axis.
"""

from __future__ import annotations

import copy

import torch

from .learner import Learner


def load_weights(model: torch.nn.Module, cfg, weights: str,
                 allow_random: bool) -> None:
    """Load ``weights`` (a state_dict file) strictly, or seeded random
    weights in the flax layout when explicitly allowed (SRL evaluation:
    decoding random weights yields noise scored as if it were a model)."""
    from ..convert.from_flax import flax_to_state_dict, seeded_variables
    from ..models.common import take_dtypes

    if weights:
        sd = torch.load(weights, map_location="cpu", weights_only=True)
        # given weights keep their dtype, as the JAX package's variables do
        take_dtypes(model, sd)
    elif allow_random:
        sd = flax_to_state_dict(seeded_variables(model, int(cfg.train.seed)))
    else:
        raise SystemExit(
            "--weights is required (pass --allow_random_weights=True to "
            "decode from seeded random weights, e.g. for smoke tests)")
    model.load_state_dict(sd, strict=True)


def is_training(cfg) -> bool:
    return not (cfg.only_val or cfg.only_test or cfg.overfit_batch)


def place_model(model: torch.nn.Module, cfg, mesh, dev: torch.device):
    """``model`` (whole) on ``dev`` and ``mesh``: split over its ``model``
    axis (``shard_tp``), and for training on an ``fsdp`` axis sharded
    (``shard_model``) after a copy is taken to evaluate through. Returns
    ``(model, eval_model)``; ``eval_model`` is ``model`` unless sharded.
    ``build_learner`` places a new model so, and a resize the survivors'
    whole one."""
    from ..parallel.mesh import shard_model, shards_params
    from ..parallel.tensor import shard_tp

    model.to(dev)
    if mesh is not None:
        shard_tp(model, mesh)
    sharded = shards_params(mesh) and is_training(cfg)
    if cfg.task_type == "vb" and dev.type == "cuda":
        # FSDP2 refuses parameters that are not contiguous
        model.to(memory_format=torch.contiguous_format if sharded
                 else torch.channels_last_3d)
    # an fsdp-sharded model evaluates through a copy that is whole on the
    # fsdp axis: the ranks' decodes stop at different steps, and a
    # per-forward all-gather would then deadlock (the Learner copies the
    # weights in before each validation). A model group decodes the same
    # rows in lockstep, so the copy keeps the tensor-parallel split.
    eval_model = copy.deepcopy(model) if sharded else model
    if sharded:
        shard_model(model, mesh)
    return model, eval_model


def build_learner(cfg, uid: str, device="cuda", weights: str = "",
                  allow_random: bool = False) -> Learner:
    """The Learner that ``main.py`` runs for ``cfg``. Training, and ``vb`` /
    ``evrel`` evaluation: the model with flax's initial values from
    ``train.seed``, then the pretrained weights the config names
    (``load_pretrained_variables``), then ``weights`` when given. ``vb_arg``
    evaluation alone: ``weights``, or seeded random ones when allowed."""
    from ..data import get_data
    from ..evaluation.evaluators import EvalB, EvalB_Acc, EvalB_Gen
    from ..extract import resolve_device
    from ..models.selector import (
        build_model,
        build_srl_generate_fn,
        init_model_variables,
    )
    from ..parallel.collectives import (
        data_rank,
        data_world_size,
        is_dist,
        model_rank,
    )
    from ..parallel.mesh import data_extent, make_mesh, mesh_shape
    from .pretrained import load_pretrained_variables

    task = cfg.task_type
    if task not in ("vb", "vb_arg", "evrel"):
        raise NotImplementedError(f"task_type {task!r}")
    dev = resolve_device(device)
    mesh = make_mesh(cfg, dev.type) if is_dist() else None
    if mesh is None:
        mesh_shape(cfg, 1)  # the axes and the shape must hold on one process
    extent = data_extent(mesh) if mesh is not None else 1
    for key in ("bs", "bsv"):
        # each rank loads global batch / world rows (learner.py:108-126)
        if int(cfg.train[key]) % extent:
            raise ValueError(
                f"train.{key}={cfg.train[key]} (the global batch) is not "
                f"divisible by the {extent} ranks of the data x fsdp axes")
    rank, world = data_rank(), data_world_size()
    data = get_data(cfg, num_shards=world, shard_id=rank)
    comm = data.valid_dl.dataset.comm
    model = build_model(cfg, comm)
    if task == "vb_arg" and not is_training(cfg):
        load_weights(model, cfg, weights, allow_random)
    else:
        init_model_variables(model, int(cfg.train.seed))
        load_pretrained_variables(cfg, model)
        if weights:
            load_weights(model, cfg, weights, False)
    model, eval_model = place_model(model, cfg, mesh, dev)
    ranks = dict(rank=rank, world_size=world, model_rank=model_rank())
    if task == "vb":
        eval_fn = EvalB(cfg, comm, eval_model, dev, split_type=(
            "valid" if not cfg.only_test else "test_verb"), **ranks)
    elif task == "evrel":
        eval_fn = EvalB_Acc(cfg, comm, eval_model, dev, split_type=(
            "valid" if not cfg.only_test else "test_evrel"), **ranks)
    else:
        eval_fn = EvalB_Gen(
            cfg, comm, build_srl_generate_fn(cfg, comm, eval_model), dev,
            split_type="valid" if not cfg.only_test else "test_srl",
            **ranks)
    model.train(is_training(cfg))
    return Learner(uid=uid, cfg=cfg, model=model, data=data, eval_fn=eval_fn,
                   device=dev, eval_model=eval_model, mesh=mesh)
