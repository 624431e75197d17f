"""CLI of the PyTorch port: ``python -m vidsitu_tpu_torch.main <uid>
--key=val ...`` (the surface of the JAX package's main.py: a run id plus
dotted-key config overrides; reference main_dist.py:132-172).

One device per process. The three tasks train and validate::

    python -m vidsitu_tpu_torch.main vb_run --task_type=vb \\
        --mdl.mdl_name=sf_base --mdl.sf_mdl_name=i3d_r50_nl_8x8 --device=cuda
    python -m vidsitu_tpu_torch.main srl_run --task_type=vb_arg \\
        --mdl.mdl_name=sfpret_txe_txd_vbarg --device=cuda
    python -m vidsitu_tpu_torch.main evrel_run --task_type=evrel \\
        --mdl.mdl_name=sfpret_evrel --device=cuda

``train.epochs`` epochs, each validated (``EvalB``, ``EvalB_Gen`` decoding
with ``gen.*``, ``EvalB_Acc``); the best model goes to
``{misc.tmp_path}/models/{uid}.ckpt`` and ``--train.resume=True`` with the
same uid resumes it (optimizer included with ``train.load_opt``, the
dropout generator's state always). Then the best model is validated once
more (``run_final_val``). ``--only_val``, ``--only_test`` and
``--overfit_batch`` as in the JAX package; SRL decoding alone::

    python -m vidsitu_tpu_torch.main srl_eval --task_type=vb_arg \\
        --only_val=True --device=cuda --weights=srl_state_dict.pt

Several processes, one per GPU, through ``torchrun`` (the JAX package's
``jax.distributed.initialize``, main.py:75-89): each rank trains on its
shard of the global batch ``train.bs`` (BatchNorm statistics and the loss
over the global batch, gradients summed over the ranks), and rank 0 merges
and scores the ranks' predictions::

    torchrun --standalone --nproc_per_node=8 -m vidsitu_tpu_torch.main \
        vb_run --task_type=vb --mdl.sf_mdl_name=i3d_r50_nl_8x8 --device=cuda

Port-only flags, given in the same ``--key=value`` form:

  * ``--device``: torch device (default ``cuda``; raises when no GPU is
    visible, never falls back to the CPU); under ``torchrun``, ``cuda`` is
    ``cuda:{LOCAL_RANK}`` and ``cuda:N`` puts every rank on card N;
  * ``--dist_backend``: ``nccl`` (the default on CUDA) or ``gloo`` (the
    default on the CPU; also two ranks on one card, which NCCL refuses);
    naming one starts a process group even for a single rank;
  * ``--weights``: a torch file holding the port model's ``state_dict``
    (evaluation, or the starting point of a fit);
  * ``--allow_random_weights=True``: seeded random weights from
    ``train.seed`` instead, for SRL decoding alone (smoke tests only).

Predictions go to ``{misc.tmp_path}/predictions/{uid}/{dl_name}_0.pkl``.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional

PORT_FLAGS = ("device", "weights", "allow_random_weights", "dist_backend")


def parse_cli(argv: List[str]):
    """-> (uid, config overrides, port flags)."""
    if len(argv) < 1 or argv[0].startswith("--"):
        raise SystemExit(
            "usage: python -m vidsitu_tpu_torch.main <uid> "
            "[--dotted.key=value ...]")
    uid = argv[0]
    overrides: Dict[str, str] = {}
    flags: Dict[str, str] = {"device": "cuda", "weights": "",
                             "allow_random_weights": "False",
                             "dist_backend": ""}
    for arg in argv[1:]:
        if not (arg.startswith("--") and "=" in arg):
            raise SystemExit(f"expected --key=value, got {arg!r}")
        key, val = arg[2:].split("=", 1)
        (flags if key in PORT_FLAGS else overrides)[key] = val
    return uid, overrides, flags


def main_fn(cfg, uid: str, device, weights: str = "",
            allow_random: bool = False) -> Dict[str, Any]:
    """Run what ``cfg`` asks for (main.py:38-69). Returns the validation
    results by loader name as (loss, metrics), the evaluator, the
    predictions directory, the config and the Learner."""
    from .train.build import build_learner, is_training

    learner = build_learner(cfg, uid, device, weights, allow_random)
    results: Dict[str, Any] = {}
    if is_training(cfg):
        learner.fit(epochs=cfg.train.epochs, lr=cfg.train.lr)
        # preempted: the state is saved; skip the final validation so that
        # the process exits inside the grace period. A rank that left the
        # run at a resize validates no more either.
        if not (learner._preempt_requested or learner.left) and \
                cfg.run_final_val:
            print("Running Final Validation using best model")
            learner.load_model_dict(str(learner.model_file), load_opt=False)
            loss, acc, _ = learner.validate(write_to_file=True)
            results[cfg.val_dl_name] = (loss, acc)
    else:
        if cfg.overfit_batch:
            learner.overfit_batch(cfg.train.epochs, 1e-4)
        if cfg.only_val:
            loss, acc, _ = learner.validate(write_to_file=True)
            results[cfg.val_dl_name] = (loss, acc)
        if cfg.only_test:
            loss, acc, _ = learner.validate(
                db={cfg.test_dl_name: learner.data.test_dl},
                write_to_file=True)
            results[cfg.test_dl_name] = (loss, acc)
    for name, (loss, acc) in results.items():
        print(name, loss)
        print(name, acc)
    return {"results": results, "evaluator": learner.eval_fn,
            "pred_dir": learner.predictions_dir, "cfg": cfg,
            "learner": learner}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Join the process group ``torchrun`` describes (if any), build the
    config, run ``main_fn``; a group this call started is destroyed on the
    way out."""
    from .parallel.collectives import is_dist
    from .parallel.mesh import init_distributed
    from .utils.config import CfgProcessor, get_cfg_with_overrides

    uid, overrides, flags = parse_cli(
        list(argv) if argv is not None else sys.argv[1:])
    had_group = is_dist()
    device = init_distributed(flags["device"], flags["dist_backend"] or None)
    try:
        cfg = get_cfg_with_overrides(uid, **overrides)
        cfg["cmd_str"] = " ".join(sys.argv)
        cfg.freeze()
        print(CfgProcessor.to_str(cfg))
        return main_fn(cfg, uid, device, flags["weights"],
                       flags["allow_random_weights"].lower() in ("1", "true"))
    finally:
        if is_dist() and not had_group:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
