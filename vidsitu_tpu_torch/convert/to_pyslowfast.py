"""The inverse of ``convert/slowfast_torch.py``: a port video model's
``state_dict`` under PySlowFast's module names, as a published SFBase
checkpoint holds them. Used to fabricate such checkpoints from seeded
models (``chip_smoke.py`` phase 27 and the port's converter tests).

  backbone.s1{_slow|_fast}.conv.{conv|bn}  -> sf_mdl.s1.pathway{P}_stem.{conv|bn}
  backbone.s{K}_fuse.conv_f2s.{conv|bn}    -> sf_mdl.s{K}_fuse.{conv_f2s|bn}
  backbone.s{K}{_path}.block_{i}.proj      -> sf_mdl.s{K}.pathway{P}_res{i}.branch1{,_bn}
  backbone.s{K}{_path}.block_{i}.{a,b,c}   -> sf_mdl.s{K}.pathway{P}_res{i}.branch2.{a,b,c}{,_bn}
  backbone.s{K}{_path}.nl_{i}.{theta,phi,g,out,bn}
                                 -> sf_mdl.s{K}.pathway{P}_nonlocal{i}.{conv_*,bn}
  proj_head.layers_{i}                     -> proj_head.{2 i}
"""

from __future__ import annotations

import re
from typing import Dict, Mapping


def _pathway(suffix: str) -> int:
    return 1 if suffix == "_fast" else 0


def pysf_name(key: str) -> str:
    """The PySlowFast name (``sf_mdl.`` / ``proj_head.`` prefixed) of one
    port ``state_dict`` key; KeyError for a key that has none."""
    if m := re.fullmatch(r"proj_head\.layers_(\d)\.(\w+)", key):
        return f"proj_head.{2 * int(m[1])}.{m[2]}"
    if not key.startswith("backbone."):
        raise KeyError(f"no PySlowFast name for {key}")
    k = key[len("backbone."):]
    if m := re.fullmatch(r"s1(_slow|_fast)?\.conv\.(conv|bn)\.(\w+)", k):
        src = f"s1.pathway{_pathway(m[1])}_stem.{m[2]}.{m[3]}"
    elif m := re.fullmatch(r"s(\d)_fuse\.conv_f2s\.(conv|bn)\.(\w+)", k):
        src = (f"s{m[1]}_fuse." + ("conv_f2s" if m[2] == "conv" else "bn")
               + f".{m[3]}")
    elif m := re.fullmatch(r"s(\d)(_slow|_fast)?\.block_(\d+)\.(proj|a|b|c)\."
                           r"(conv|bn)\.(\w+)", k):
        part = ("branch1" if m[4] == "proj" else f"branch2.{m[4]}") + (
            "" if m[5] == "conv" else "_bn")
        src = f"s{m[1]}.pathway{_pathway(m[2])}_res{m[3]}.{part}.{m[6]}"
    elif m := re.fullmatch(r"s(\d)(_slow|_fast)?\.nl_(\d+)\."
                           r"(theta|phi|g|out|bn)\.(\w+)", k):
        part = "bn" if m[4] == "bn" else f"conv_{m[4]}"
        src = f"s{m[1]}.pathway{_pathway(m[2])}_nonlocal{m[3]}.{part}.{m[5]}"
    else:
        raise KeyError(f"no PySlowFast name for {key}")
    return f"sf_mdl.{src}"


def pysf_state_dict(sd: Mapping, prefix: str = "module.") -> Dict:
    """``sd`` (``backbone.*`` and optionally ``proj_head.*`` keys) renamed
    by :func:`pysf_name` under ``prefix`` (a DDP-saved checkpoint's
    ``module.``); BatchNorm step counters are left out."""
    return {prefix + pysf_name(k): v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}
