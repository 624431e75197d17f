"""SlowFast / ResNet3D checkpoint converter: torch state dicts (PySlowFast
layout, as inside the published VidSitu SFBase checkpoints) -> our flax
trees.

Covers the reference's checkpoint-consumption paths
(utils/trn_utils.py:352-413,631-706):
  * ``module.``-prefix stripping (DDP asymmetry)
  * ``sf_mdl.``-subtree extraction from a trained SFBase checkpoint
  * projection-head MLP conversion (mdl_sf_base.py:161-167)
  * BatchNorm running stats -> the ``batch_stats`` collection

Torch conv weights (Cout, Cin, T, H, W) are transposed to flax's
(T, H, W, Cin, Cout). PySlowFast module names map as:

  s1.pathway{P}_stem.conv            -> s1_{slow|fast}/conv/conv
  s1_fuse.conv_f2s                   -> s1_fuse/conv_f2s/conv
  s{K}.pathway{P}_res{i}.branch1     -> s{K}_{path}/block_{i}/proj/conv
  s{K}.pathway{P}_res{i}.branch2.{a,b,c} -> s{K}_{path}/block_{i}/{a,b,c}/conv
  s{K}.pathway{P}_nonlocal{i}.conv_{theta,phi,g,out}
                                     -> s{K}_{path}/nl_{i}/{theta,phi,g,out}
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .tracking import TrackedDict, verify_exhausted

_BACKBONE_IGNORE = (
    r"\.num_batches_tracked$",  # torch BN step counters
    r"^head\.",                 # classification head (trimmed, ref
                                # mdl_sf_base.py:65-113)
)


def _conv_w(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 4, 1, 0))


def strip_prefixes(sd: Dict[str, np.ndarray], subtree: Optional[str] = None):
    """Strip 'module.' and optionally select+strip a subtree prefix."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if subtree:
            if not k.startswith(subtree + "."):
                continue
            k = k[len(subtree) + 1:]
        out[k] = v
    return out


def _set(tree: Dict, path: Tuple[str, ...], leaf: Any):
    d = tree
    for p in path[:-1]:
        d = d.setdefault(p, {})
    d[path[-1]] = leaf


def convert_video_backbone(
    sd: Dict[str, np.ndarray], arch: str, strict: bool = False
) -> Tuple[Dict, Dict]:
    """PySlowFast state dict -> (params, batch_stats) for our backbone.

    ``arch``: 'slowfast' for dual pathway, else single pathway.
    Returns trees rooted at the backbone (no 'backbone' wrapper).
    ``strict`` asserts every source key is consumed (modulo BN step
    counters / the trimmed classification head).
    """
    sd = TrackedDict(dict(sd))
    multi = arch == "slowfast"
    params: Dict = {}
    stats: Dict = {}

    def pathway_name(p: int) -> str:
        return "slow" if p == 0 else "fast"

    def put_convbn(dst_prefix: Tuple[str, ...], src_prefix: str,
                   bn_name: str):
        bn = bn_name
        w = sd[src_prefix + ".weight"]
        _set(params, dst_prefix + ("conv", "kernel"), _conv_w(w))
        _set(params, dst_prefix + ("bn", "scale"), sd[bn + ".weight"])
        _set(params, dst_prefix + ("bn", "bias"), sd[bn + ".bias"])
        _set(stats, dst_prefix + ("bn", "mean"), sd[bn + ".running_mean"])
        _set(stats, dst_prefix + ("bn", "var"), sd[bn + ".running_var"])

    pathways = (0, 1) if multi else (0,)
    for p in pathways:
        pn = pathway_name(p) if multi else None
        stem_dst = (f"s1_{pn}",) if multi else ("s1",)
        put_convbn(
            stem_dst + ("conv",),
            f"s1.pathway{p}_stem.conv",
            bn_name=f"s1.pathway{p}_stem.bn",
        )

    if multi:
        put_convbn(("s1_fuse", "conv_f2s"), "s1_fuse.conv_f2s",
                   bn_name="s1_fuse.bn")

    # residual stages s2..s5
    for k in range(2, 6):
        for p in pathways:
            pn = pathway_name(p)
            stage_dst = f"s{k}_{pn}" if multi else f"s{k}"
            i = 0
            while f"s{k}.pathway{p}_res{i}.branch2.a.weight" in sd:
                blk = (stage_dst, f"block_{i}")
                src = f"s{k}.pathway{p}_res{i}"
                if f"{src}.branch1.weight" in sd:
                    put_convbn(blk + ("proj",), f"{src}.branch1",
                               bn_name=f"{src}.branch1_bn")
                for part in ("a", "b", "c"):
                    put_convbn(blk + (part,), f"{src}.branch2.{part}",
                               bn_name=f"{src}.branch2.{part}_bn")
                i += 1
            # non-local blocks, named by the index of the block they follow
            # (``nonlocal1``, ``nonlocal3``, ...), so not a run from 0
            nl_key = re.compile(
                rf"s{k}\.pathway{p}_nonlocal(\d+)\.conv_theta\.weight")
            for j in sorted(int(m.group(1)) for m in map(nl_key.fullmatch, sd)
                            if m):
                src = f"s{k}.pathway{p}_nonlocal{j}"
                nl = (stage_dst, f"nl_{j}")
                for src_name, ours in (
                    ("conv_theta", "theta"),
                    ("conv_phi", "phi"),
                    ("conv_g", "g"),
                    ("conv_out", "out"),
                ):
                    _set(params, nl + (ours, "kernel"),
                         _conv_w(sd[f"{src}.{src_name}.weight"]))
                    # PySlowFast's Nonlocal 1x1x1 convs are biased
                    _set(params, nl + (ours, "bias"),
                         sd[f"{src}.{src_name}.bias"])
                _set(params, nl + ("bn", "scale"), sd[f"{src}.bn.weight"])
                _set(params, nl + ("bn", "bias"), sd[f"{src}.bn.bias"])
                _set(stats, nl + ("bn", "mean"), sd[f"{src}.bn.running_mean"])
                _set(stats, nl + ("bn", "var"), sd[f"{src}.bn.running_var"])
        if multi and k < 5 and f"s{k}_fuse.conv_f2s.weight" in sd:
            put_convbn((f"s{k}_fuse", "conv_f2s"), f"s{k}_fuse.conv_f2s",
                       bn_name=f"s{k}_fuse.bn")

    if strict:
        verify_exhausted(sd, _BACKBONE_IGNORE, "convert_video_backbone")
    return params, stats


def convert_sfbase_checkpoint(
    sd: Dict[str, np.ndarray], arch: str, strict: bool = False
) -> Dict[str, Any]:
    """Full SFBase checkpoint (sf_mdl.* + proj_head.*) -> VbVideoModel
    variables {'params', 'batch_stats'}."""
    sd = strip_prefixes(sd)
    back_sd = strip_prefixes(sd, subtree="sf_mdl")
    bparams, bstats = convert_video_backbone(back_sd, arch, strict=strict)
    params: Dict[str, Any] = {"backbone": bparams}
    stats: Dict[str, Any] = {"backbone": bstats}
    # proj_head: nn.Sequential(Linear, ReLU, Linear) -> MLP layers_{0,1}
    head_keys = ("proj_head.0.weight", "proj_head.0.bias",
                 "proj_head.2.weight", "proj_head.2.bias")
    if "proj_head.0.weight" in sd:
        params["proj_head"] = {
            "layers_0": {
                "kernel": sd["proj_head.0.weight"].T,
                "bias": sd["proj_head.0.bias"],
            },
            "layers_1": {
                "kernel": sd["proj_head.2.weight"].T,
                "bias": sd["proj_head.2.bias"],
            },
        }
    if strict:
        # the backbone pass only audits the sf_mdl.* subtree — audit the
        # rest too, or keys like cls_head.*/sf_mdl_ema.* would be
        # silently dropped under a mode whose contract is "every source
        # key accounted for"
        leftover = sorted(
            k for k in sd
            if not k.startswith("sf_mdl.") and k not in head_keys
        )
        if leftover:
            raise ValueError(
                "convert_sfbase_checkpoint(strict): unconsumed keys "
                f"outside sf_mdl./proj_head: {leftover[:8]}"
                + ("..." if len(leftover) > 8 else "")
            )
    return {"params": params, "batch_stats": stats}
