"""CLI of the PyTorch port: ``python -m vidsitu_tpu_torch.main <uid>
--key=val ...`` (the surface of the JAX package's main.py: a run id plus
dotted-key config overrides; reference main_dist.py:132-172).

This slice evaluates ``vb_arg`` (SRL decoding) on one device::

    python -m vidsitu_tpu_torch.main srl_eval --task_type=vb_arg \\
        --only_val=True --device=cuda --weights=srl_state_dict.pt

Port-only flags, given in the same ``--key=value`` form:

  * ``--device``: torch device (default ``cuda``; raises when no GPU is
    visible, never falls back to the CPU);
  * ``--weights``: a torch file holding the port model's ``state_dict``;
  * ``--allow_random_weights=True``: seeded random weights from
    ``train.seed`` instead (smoke tests only).

Predictions go to ``{misc.tmp_path}/predictions/{uid}/{dl_name}_0.pkl``.
Training raises ``NotImplementedError`` until its slice is ported.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

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


def load_weights(model: torch.nn.Module, cfg, weights: str,
                 allow_random: bool) -> None:
    """Load ``weights`` (a state_dict file) strictly, or seeded random
    weights when explicitly allowed."""
    from .convert.from_flax import flax_to_state_dict, seeded_variables

    if weights:
        sd = torch.load(weights, map_location="cpu", weights_only=True)
    elif allow_random:
        sd = flax_to_state_dict(seeded_variables(model, int(cfg.train.seed)))
    else:
        # decoding random weights yields noise scored as if it were a model
        raise SystemExit(
            "--weights is required (pass --allow_random_weights=True to "
            "decode from seeded random weights, e.g. for smoke tests)")
    model.load_state_dict(sd, strict=True)


def main_fn(cfg, uid: str, device, weights: str = "",
            allow_random: bool = False) -> Dict[str, Any]:
    """Run the evaluations ``cfg`` asks for. Returns the results by loader
    name, the evaluator (which holds the per-batch times and the generator,
    with its model and decode-step counts), the predictions directory and
    the config."""
    from .data import get_data
    from .evaluation.evaluators import EvalB_Gen
    from .extract import resolve_device
    from .models.selector import build_model, build_srl_generate_fn

    if cfg.task_type != "vb_arg":
        raise NotImplementedError(
            f"task_type {cfg.task_type!r}: this port evaluates vb_arg only; "
            "vb training, SRL training and evrel are the next slices "
            "(ROADMAP.md, Queue 1)")
    if not (cfg.only_val or cfg.only_test):
        raise NotImplementedError(
            "training is not ported yet: SRL training comes after the vb "
            "training slice (ROADMAP.md, Queue 1); pass --only_val=True or "
            "--only_test=True")
    dev = resolve_device(device)
    data = get_data(cfg)
    comm = data.valid_dl.dataset.comm
    model = build_model(cfg, comm)
    load_weights(model, cfg, weights, allow_random)
    model.to(dev).eval()
    evaluator = EvalB_Gen(
        cfg, comm, build_srl_generate_fn(cfg, comm, model), dev,
        split_type="valid" if not cfg.only_test else "test_srl")
    pred_dir = Path(cfg.misc.tmp_path) / "predictions" / uid
    results: Dict[str, Any] = {}
    if cfg.only_val:
        results[cfg.val_dl_name] = evaluator(data.valid_dl, cfg.val_dl_name,
                                             pred_dir)
    if cfg.only_test:
        results[cfg.test_dl_name] = evaluator(data.test_dl, cfg.test_dl_name,
                                              pred_dir)
    for name, (loss, acc) in results.items():
        print(name, loss)
        print(name, acc)
    return {"results": results, "evaluator": evaluator,
            "pred_dir": pred_dir, "cfg": cfg}


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
