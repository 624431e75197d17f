"""Bounding-box IoU utilities (reference: utils/box_utils.py — unused in
the main path, kept for capability parity). Pure numpy/jax-compatible."""

from __future__ import annotations

import numpy as np


def box_area(boxes):
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1, boxes2):
    """(N, 4) x (M, 4) xyxy -> (N, M) IoU."""
    boxes1 = np.asarray(boxes1, dtype=np.float64)
    boxes2 = np.asarray(boxes2, dtype=np.float64)
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def bbox_overlaps_batch(anchors, gt_boxes):
    """(N, 4) x (B, K, 4) -> (B, N, K) IoU (batched variant)."""
    anchors = np.asarray(anchors, dtype=np.float64)
    gt_boxes = np.asarray(gt_boxes, dtype=np.float64)
    return np.stack([box_iou(anchors, gt) for gt in gt_boxes])
