"""Pretrained-weight policies (port of vidsitu_tpu/train/pretrained.py;
reference: trn_utils.py:352-413).

  * vb task: load a converted SlowFast / SFBase checkpoint into the video
    backbone (and the projection head when the checkpoint has one), through
    the port's copies of the converters and then ``flax_to_state_dict``,
    the same route as the JAX package's;
  * ``train.freeze_sfbase``: the backbone's gradients are zeroed before
    each update (its BatchNorm statistics still move, as in JAX).

The GPT-2 and RoBERTa branches come with SRL and evrel training.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

from torch import nn


def _load_caffe2_blobs(path):
    """The caffe2 blob dict if ``path`` is a caffe2-format pickle (a
    {'blobs': ...} wrapper or a bare {name: ndarray} dict, both of which the
    published Kinetics checkpoints use), else None. torch checkpoints
    short-circuit (zip serialization) or fail the plain unpickle."""
    import pickle
    import zipfile

    if zipfile.is_zipfile(path):
        return None
    try:
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
    except Exception:
        return None
    if not isinstance(data, dict) or not data:
        return None
    blobs = data["blobs"] if "blobs" in data else data
    if isinstance(blobs, dict) and any(
            hasattr(v, "shape") for v in blobs.values()):
        return blobs
    return None


def load_pretrained_variables(cfg, model: nn.Module, logger=None) -> nn.Module:
    """Apply cfg-driven pretrained initialization to ``model`` in place."""
    if cfg.task_type == "vb" and cfg.mdl.load_sf_pretrained:
        from ..convert.from_flax import flax_to_state_dict

        path = cfg.mdl.sf_pretrained_path
        if not (path and Path(path).exists()):
            raise FileNotFoundError(
                f"load_sf_pretrained set but path missing: {path}")
        blobs = _load_caffe2_blobs(path)
        if blobs is not None:
            from ..convert.caffe2 import convert_caffe2_backbone

            bb_params, bb_stats = convert_caffe2_backbone(
                blobs, cfg.vid_mdl.arch, strict=True)
            tree = {"params": {"backbone": bb_params},
                    "batch_stats": {"backbone": bb_stats}}
        else:
            from ..convert.hf_torch import load_torch_state_dict
            from ..convert.slowfast_torch import convert_sfbase_checkpoint

            tree = convert_sfbase_checkpoint(
                load_torch_state_dict(path), cfg.vid_mdl.arch, strict=True)
        sd = flax_to_state_dict(tree)
        missing, unexpected = model.load_state_dict(sd, strict=False)
        stray = [k for k in missing if k.startswith("backbone.")]
        if stray or unexpected:
            raise ValueError(f"pretrained checkpoint {path} does not fit the "
                             f"backbone: missing {stray[:5]}, unexpected "
                             f"{list(unexpected)[:5]}")
        if logger:
            logger.info(f"loaded SlowFast pretrained weights from {path}")
    return model


def make_freeze_mask(cfg, model: nn.Module) -> Optional[List[str]]:
    """Names of the parameters whose gradients are zeroed
    (``train.freeze_sfbase``: the video backbone), or None."""
    names = [n for n, _ in model.named_parameters()]
    if not cfg.train.freeze_sfbase or not any(
            n.startswith("backbone.") for n in names):
        return None
    return [n for n in names if n.startswith("backbone.")]
