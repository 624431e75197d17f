"""Caffe2 pickle checkpoint support (reference: PySlowFast
CHECKPOINT_TYPE=caffe2, used for the Kinetics-pretrained backbones,
configs/vsitu_mdl_cfgs/*:CHECKPOINT_FILE_PATH; load path
utils/trn_utils.py:358-375).

Converts caffe2 blob dictionaries — single-pathway ResNet3D (I3D / C2D /
SLOW R50, incl. non-local blocks) and dual-pathway SlowFast — into the
PySlowFast torch naming, then reuses ``convert_video_backbone``.

Blob suffixes: ``_w`` conv weight, ``_bn_s``/``_bn_b`` BN scale/bias,
``_bn_rm``/``_bn_riv`` running mean/var.

Dual-pathway namespace (PySlowFast ``get_name_convert_func`` semantics):
the slow pathway uses the unprefixed single-pathway names (-> pathway0);
the fast pathway uses the same scheme prefixed ``t_`` (-> pathway1), e.g.
``t_conv1_w``, ``t_res_conv1_bn_s``, ``t_res2_0_branch2a_w``; and the
fast->slow lateral fusion convs are named after the fast-pathway tensor
they subsample: ``t_pool1_subsample*`` -> ``s1_fuse`` and
``t_res{K}_{i}_branch2c_bn_subsample*`` -> ``s{K}_fuse``. The fuse
patterns must match before the generic ``t_``-strip.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, Tuple

import numpy as np

from .slowfast_torch import convert_video_backbone

_RES_RE = re.compile(r"^res(\d+)_(\d+)_branch(\d)([a-c]?)(.*)$")
_NL_RE = re.compile(r"^nonlocal_conv(\d+)_(\d+)_(theta|phi|g|out|bn)(.*)$")
_FUSE_POOL_RE = re.compile(r"^t_pool1_subsample(_bn)?_(w|s|b|rm|riv)$")
_FUSE_RES_RE = re.compile(
    r"^t_res(\d+)_\d+_branch2c_bn_subsample(_bn)?_(w|s|b|rm|riv)$"
)
_BN_SUF = {"s": "weight", "b": "bias", "rm": "running_mean",
           "riv": "running_var"}


def load_caffe2_pickle(path) -> Dict[str, np.ndarray]:
    """Load caffe2 blobs from a pickle path, or normalize an
    already-loaded blob dict (callers that sniffed the file pass the
    dict through to avoid a second deserialization)."""
    if isinstance(path, dict):
        data = path
    else:
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
    blobs = data["blobs"] if "blobs" in data else data
    return {
        k: np.asarray(v)
        for k, v in blobs.items()
        if isinstance(v, np.ndarray) or hasattr(v, "shape")
    }


def _map_single(name: str, arr, pathway: int, out: Dict[str, np.ndarray]):
    """Map one unprefixed caffe2 blob name into PySlowFast torch naming
    under the given pathway index. Returns True if mapped."""
    p = pathway
    if name == "conv1_w":
        out[f"s1.pathway{p}_stem.conv.weight"] = arr
        return True
    m = re.match(r"^res_conv1_bn_(s|b|rm|riv)$", name)
    if m:
        out[f"s1.pathway{p}_stem.bn.{_BN_SUF[m.group(1)]}"] = arr
        return True
    m = _NL_RE.match(name)
    if m:
        stage, block, part, rest = m.groups()
        base = f"s{stage}.pathway{p}_nonlocal{block}"
        if part == "bn":
            suf = {"_s": "weight", "_b": "bias", "_rm": "running_mean",
                   "_riv": "running_var"}.get(rest)
            if suf is None:
                return False  # unknown suffix -> diagnostics, not a crash
            out[f"{base}.bn.{suf}"] = arr
        elif rest == "_w":
            out[f"{base}.conv_{part}.weight"] = arr
        elif rest == "_b":
            # PySlowFast's Nonlocal convs are biased; real caffe2 NLN
            # checkpoints carry these blobs
            out[f"{base}.conv_{part}.bias"] = arr
        else:
            return False
        return True
    m = _RES_RE.match(name)
    if m:
        stage, block, branch, sub, rest = m.groups()
        base = f"s{stage}.pathway{p}_res{block}"
        if branch == "1":
            tgt = f"{base}.branch1"
        else:
            tgt = f"{base}.branch2.{sub}"
        if rest == "_w":
            out[f"{tgt}.weight"] = arr
        else:
            suf = {"_bn_s": "weight", "_bn_b": "bias",
                   "_bn_rm": "running_mean",
                   "_bn_riv": "running_var"}.get(rest)
            if suf is None:
                return False  # unknown suffix -> diagnostics, not a crash
            bn = f"{base}.branch1_bn" if branch == "1" else (
                f"{base}.branch2.{sub}_bn"
            )
            out[f"{bn}.{suf}"] = arr
        return True
    return False


def caffe2_to_pysf_names(blobs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Caffe2 blob names -> PySlowFast torch names (both pathways + fuse)."""
    out: Dict[str, np.ndarray] = {}
    for name, arr in blobs.items():
        if name.endswith("_momentum") or name.startswith(("pred_", "fc1000")):
            continue  # classifier head / optimizer state not needed
        # fast->slow fusion convs (match before the generic t_ strip)
        m = _FUSE_POOL_RE.match(name)
        if m:
            is_bn, suf = m.groups()
            if is_bn:
                out[f"s1_fuse.bn.{_BN_SUF[suf]}"] = arr
            else:
                assert suf == "w", name
                out["s1_fuse.conv_f2s.weight"] = arr
            continue
        m = _FUSE_RES_RE.match(name)
        if m:
            stage, is_bn, suf = m.groups()
            if is_bn:
                out[f"s{stage}_fuse.bn.{_BN_SUF[suf]}"] = arr
            else:
                assert suf == "w", name
                out[f"s{stage}_fuse.conv_f2s.weight"] = arr
            continue
        # pathway routing: fast blobs carry the t_ prefix
        if name.startswith("t_"):
            mapped = _map_single(name[2:], arr, pathway=1, out=out)
        else:
            mapped = _map_single(name, arr, pathway=0, out=out)
        if not mapped:
            # unknown blob: keep for diagnostics under a reserved prefix
            out[f"_unmapped.{name}"] = arr
    return out


def convert_caffe2_backbone(
    path, arch: str, strict: bool = False
) -> Tuple[Dict, Dict]:
    """caffe2 pkl -> (params, batch_stats) for any backbone arch
    (single-pathway ResNet3D variants and dual-pathway SlowFast).
    ``strict`` raises on any blob that neither maps to a model weight
    nor is known bookkeeping (momentum/iteration/lr/classifier head)."""
    blobs = load_caffe2_pickle(path)
    sd = caffe2_to_pysf_names(blobs)
    unmapped = [k for k in sd if k.startswith("_unmapped.")]
    sd = {k: v for k, v in sd.items() if not k.startswith("_unmapped.")}
    if unmapped:
        known_aux = [
            k for k in unmapped
            if k.split(".", 1)[1] in ("model_iter", "lr", "__type__")
        ]
        real = [k for k in unmapped if k not in known_aux]
        if real and strict:
            raise ValueError(
                f"caffe2 conversion: {len(real)} unmapped blobs "
                f"(e.g. {real[:5]}) — checkpoint naming-scheme mismatch"
            )
        if real:
            import logging

            logging.getLogger(__name__).warning(
                "caffe2 conversion skipped %d unmapped blobs (e.g. %s)",
                len(real), real[:3],
            )
    return convert_video_backbone(sd, arch, strict=strict)


def convert_caffe2_checkpoint(path, arch: str, strict: bool = False) -> Dict:
    """The documented one-call entry point (EXPTS.md): caffe2 pkl ->
    flax ``variables`` dict ``{"params": {"backbone": ...},
    "batch_stats": {"backbone": ...}}`` ready for pretrained loading
    (train/pretrained.py consumes this layout)."""
    params, stats = convert_caffe2_backbone(path, arch, strict=strict)
    return {"params": {"backbone": params},
            "batch_stats": {"backbone": stats}}
