"""Verb-prediction model (SFBase analog, mdl_sf_base.py:116-231) and the
feature-extraction model (vidsitu_code/feat_extractor.py:77-112).

Port of vidsitu_tpu/models/vb_models.py. ``forward`` returns the verb
logits, and the verb loss when the batch carries ``label_tensor``; the
module's mode is flax's ``deterministic`` flag (``train()``: BatchNorm on
batch statistics). Parameters are float32, products run in ``train.dtype``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .common import MLP
from .selector import compute_dtypes
from .srl_models import masked_cross_entropy
from .video_backbone import (
    ResNet3DBackbone,
    SlowFastBackbone,
    VideoCfg,
    backbone_out_dim,
    trimmed_head,
)


def _fold_events(x: torch.Tensor) -> torch.Tensor:
    """(B, 5, T, H, W, C) -> (B*5, T, H, W, C); 5-D inputs pass through.
    Prefer folding on the host (data/loader.fold_frame_events)."""
    if x.dim() == 5:
        return x
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def _maybe_normalize(x: torch.Tensor, vid_cfg: VideoCfg,
                     dtype: torch.dtype) -> torch.Tensor:
    """uint8 frames -> normalized compute dtype, on the device (ships 4x
    fewer host->device bytes); other dtypes are only cast.

    uint8 frames arrive already channel-reversed by the host packer when
    ``reverse_input_channel`` is set; the reference normalizes before
    reversing (dat_loader.py:478-484), so mean/std are reversed here to
    give both preprocessing paths identical tensors.
    """
    if x.dtype == torch.uint8:
        mean_t, std_t = vid_cfg.mean, vid_cfg.std
        if vid_cfg.reverse_input_channel:
            mean_t, std_t = mean_t[::-1], std_t[::-1]
        mean = torch.tensor(mean_t, dtype=dtype, device=x.device)
        std = torch.tensor(std_t, dtype=dtype, device=x.device)
        return (x.to(dtype) / 255.0 - mean) / std
    return x.to(dtype)


def _to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    """(N, T, H, W, C) -> (N, C, T, H, W), a channels-last-3d view."""
    return x.permute(0, 4, 1, 2, 3)


class VbVideoModel(nn.Module):
    """Backbone + trimmed head (+ projection to the verb vocabulary).

    With ``num_classes > 0`` this is SFBase (2-layer MLP projection head,
    mdl_sf_base.py:161-167); with ``num_classes == 0`` it is the feature
    extractor producing (B, 5, D).
    """

    def __init__(self, vid_cfg: VideoCfg, num_classes: int = 0):
        super().__init__()
        self.vid_cfg = vid_cfg
        self.num_classes = num_classes
        if vid_cfg.arch == "slowfast":
            self.backbone = SlowFastBackbone(vid_cfg)
        else:
            self.backbone = ResNet3DBackbone(vid_cfg)
        if num_classes > 0:
            din = backbone_out_dim(vid_cfg)
            self.proj_head = MLP(din, [din // 2, num_classes],
                                 dtype=vid_cfg.dtype)

    def clip_features(self, inp: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(N, D) pooled per-clip features from (N, T, H, W, C) frames (or
        the 6-D (B, 5, ...) form); N need not be a multiple of 5."""
        dtype = self.vid_cfg.dtype
        fast = _to_ncdhw(_maybe_normalize(
            _fold_events(inp["frms_ev_fast_tensor"]), self.vid_cfg, dtype))
        if self.vid_cfg.arch == "slowfast":
            slow = _to_ncdhw(_maybe_normalize(
                _fold_events(inp["frms_ev_slow_tensor"]), self.vid_cfg, dtype))
            return trimmed_head(list(self.backbone(slow, fast)))
        return trimmed_head([self.backbone(fast)])

    def features(self, inp: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, 5, D) pooled clip features (forward_encoder + head)."""
        pooled = self.clip_features(inp)
        return pooled.reshape(pooled.shape[0] // 5, 5, pooled.shape[1])

    def forward(self, inp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        feats = self.features(inp)
        if self.num_classes == 0:
            return {"feats": feats}
        logits = self.proj_head(feats)  # (B, 5, V)
        out = {"mdl_out": logits}
        if "label_tensor" in inp:
            # plain CE over the B*5 events (LossB, mdl_sf_base.py:219-231)
            out["loss"] = masked_cross_entropy(
                logits.reshape(-1, self.num_classes),
                inp["label_tensor"].reshape(-1), pad_id=-1)
        return out


def _build(cfg, num_classes: int) -> VbVideoModel:
    dtype, param_dtype = compute_dtypes(cfg)
    if param_dtype != torch.float32:
        raise NotImplementedError(
            f"train.param_dtype {cfg.train.param_dtype}: the port keeps "
            "float32 parameters")
    vid_cfg = VideoCfg.from_cfg(
        cfg.vid_mdl, dtype=dtype, remat=cfg.train.remat,
        remat_stages=cfg.train.remat_stages,
        bn_f32_stats=cfg.train.bn_f32_stats)
    return VbVideoModel(vid_cfg, num_classes=num_classes).eval()


def build_vb_model(cfg, comm) -> VbVideoModel:
    """SFBase with its verb head, in eval mode: float32 parameters, products
    in ``train.dtype``; ``train.remat`` / ``remat_stages`` /
    ``bn_f32_stats`` as the JAX package reads them."""
    return _build(cfg, len(comm.vb_id_vocab))


def build_feat_extractor(cfg) -> VbVideoModel:
    """The feature extractor, in eval mode: float32 parameters, products in
    ``train.dtype``."""
    return _build(cfg, 0)
