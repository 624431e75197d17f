"""CLI of the PyTorch port: ``python -m vidsitu_tpu_torch.main <uid>
--key=val ...`` (the surface of the JAX package's main.py: a run id plus
dotted-key config overrides; reference main_dist.py:132-172).

One process, one device. Verb prediction trains and validates::

    python -m vidsitu_tpu_torch.main vb_run --task_type=vb \\
        --mdl.mdl_name=sf_base --mdl.sf_mdl_name=i3d_r50_nl_8x8 --device=cuda

``train.epochs`` epochs, each validated with ``EvalB``; the best model goes
to ``{misc.tmp_path}/models/{uid}.ckpt`` and ``--train.resume=True`` with
the same uid resumes it (optimizer included with ``train.load_opt``). Then
the best model is validated once more (``run_final_val``). ``--only_val``,
``--only_test`` and ``--overfit_batch`` as in the JAX package. SRL decoding
evaluates ``vb_arg``::

    python -m vidsitu_tpu_torch.main srl_eval --task_type=vb_arg \\
        --only_val=True --device=cuda --weights=srl_state_dict.pt

Port-only flags, given in the same ``--key=value`` form:

  * ``--device``: torch device (default ``cuda``; raises when no GPU is
    visible, never falls back to the CPU);
  * ``--weights``: a torch file holding the port model's ``state_dict``;
  * ``--allow_random_weights=True``: seeded random weights from
    ``train.seed`` instead, for SRL decoding (smoke tests only).

Predictions go to ``{misc.tmp_path}/predictions/{uid}/{dl_name}_0.pkl``.
SRL training and evrel raise ``NotImplementedError`` until their slices
are ported.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional

PORT_FLAGS = ("device", "weights", "allow_random_weights")


def parse_cli(argv: List[str]):
    """-> (uid, config overrides, port flags)."""
    if len(argv) < 1 or argv[0].startswith("--"):
        raise SystemExit(
            "usage: python -m vidsitu_tpu_torch.main <uid> "
            "[--dotted.key=value ...]")
    uid = argv[0]
    overrides: Dict[str, str] = {}
    flags: Dict[str, str] = {"device": "cuda", "weights": "",
                             "allow_random_weights": "False"}
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
        # the process exits inside the grace period
        if not learner._preempt_requested and cfg.run_final_val:
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
    from .utils.config import CfgProcessor, get_cfg_with_overrides

    uid, overrides, flags = parse_cli(
        list(argv) if argv is not None else sys.argv[1:])
    cfg = get_cfg_with_overrides(uid, **overrides)
    cfg["cmd_str"] = " ".join(sys.argv)
    cfg.freeze()
    print(CfgProcessor.to_str(cfg))
    return main_fn(cfg, uid, flags["device"], flags["weights"],
                   flags["allow_random_weights"].lower() in ("1", "true"))


if __name__ == "__main__":
    main()
