"""cfg -> a ready Learner (port of vidsitu_tpu/train/build.py; reference:
main_dist.py:94-129): data, model (initialised, pretrained weights,
weights given by the caller), the task's evaluator and the Learner, on one
process and one device.

Ported: ``vb`` (training and evaluation) and ``vb_arg`` evaluation.
``vb_arg`` training is Queue 1 item 3 of ROADMAP.md, ``evrel`` item 4.
"""

from __future__ import annotations

import torch

from .learner import Learner


def load_weights(model: torch.nn.Module, cfg, weights: str,
                 allow_random: bool) -> None:
    """Load ``weights`` (a state_dict file) strictly, or seeded random
    weights in the flax layout when explicitly allowed (SRL evaluation:
    decoding random weights yields noise scored as if it were a model)."""
    from ..convert.from_flax import flax_to_state_dict, seeded_variables

    if weights:
        sd = torch.load(weights, map_location="cpu", weights_only=True)
    elif allow_random:
        sd = flax_to_state_dict(seeded_variables(model, int(cfg.train.seed)))
    else:
        raise SystemExit(
            "--weights is required (pass --allow_random_weights=True to "
            "decode from seeded random weights, e.g. for smoke tests)")
    model.load_state_dict(sd, strict=True)


def is_training(cfg) -> bool:
    return not (cfg.only_val or cfg.only_test or cfg.overfit_batch)


def build_learner(cfg, uid: str, device="cuda", weights: str = "",
                  allow_random: bool = False) -> Learner:
    """The Learner that ``main.py`` runs for ``cfg``. ``vb``: the verb model
    with flax's initial values from ``train.seed``, then
    ``mdl.load_sf_pretrained``, then ``weights`` when given. ``vb_arg``
    (evaluation only): ``weights``, or seeded random ones when allowed."""
    from ..data import get_data
    from ..evaluation.evaluators import EvalB, EvalB_Gen
    from ..extract import resolve_device
    from ..models.selector import (
        build_model,
        build_srl_generate_fn,
        init_model_variables,
    )
    from .pretrained import load_pretrained_variables

    task = cfg.task_type
    if task == "vb_arg" and is_training(cfg):
        raise NotImplementedError(
            "vb_arg (SRL) training is not ported yet (ROADMAP.md, Queue 1 "
            "item 3); pass --only_val=True or --only_test=True")
    if task not in ("vb", "vb_arg"):
        raise NotImplementedError(
            f"task_type {task!r} is not ported yet (evrel: ROADMAP.md, "
            "Queue 1 item 4)")
    dev = resolve_device(device)
    data = get_data(cfg)
    comm = data.valid_dl.dataset.comm
    model = build_model(cfg, comm)
    if task == "vb":
        init_model_variables(model, int(cfg.train.seed))
        load_pretrained_variables(cfg, model)
        if weights:
            load_weights(model, cfg, weights, False)
        model.to(dev)
        if dev.type == "cuda":
            model.to(memory_format=torch.channels_last_3d)
        eval_fn = EvalB(cfg, comm, model, dev, split_type=(
            "valid" if not cfg.only_test else "test_verb"))
    else:
        load_weights(model, cfg, weights, allow_random)
        model.to(dev).eval()
        eval_fn = EvalB_Gen(
            cfg, comm, build_srl_generate_fn(cfg, comm, model), dev,
            split_type="valid" if not cfg.only_test else "test_srl")
    return Learner(uid=uid, cfg=cfg, model=model, data=data, eval_fn=eval_fn,
                   device=dev)
