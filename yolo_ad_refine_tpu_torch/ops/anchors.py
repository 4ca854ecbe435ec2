"""Anchor-free grid points and the distance <-> box transforms.

Counterpart of ``yolo_ad_refine_tpu/ops/anchors.py`` (reference
ultralytics/utils/tal.py:303 make_anchors, :318 dist2bbox, :330 bbox2dist).
"""

from __future__ import annotations

import torch


def make_anchors(feat_shapes, strides, grid_cell_offset: float = 0.5,
                 dtype=torch.float32, device=None):
    """Anchor centers from per-level (h, w) feature shapes.

    Returns anchor_points (N, 2) xy in grid units and stride_tensor (N, 1).
    """
    anchor_points, stride_tensor = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=dtype, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=dtype, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        anchor_points.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        stride_tensor.append(torch.full((h * w, 1), float(s), dtype=dtype, device=device))
    return torch.cat(anchor_points), torch.cat(stride_tensor)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True):
    """Decode (l, t, r, b) distances at anchor points into xywh or xyxy boxes."""
    lt, rb = distance[..., :2], distance[..., 2:4]
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1)
    return torch.cat([x1y1, x2y2], dim=-1)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max: float):
    """Encode xyxy boxes as (l, t, r, b) distances clamped to
    [0, reg_max - 0.01], the DFL targets (reference tal.py:330)."""
    x1y1, x2y2 = bbox[..., :2], bbox[..., 2:4]
    dist = torch.cat([anchor_points - x1y1, x2y2 - anchor_points], dim=-1)
    return dist.clamp(0, reg_max - 0.01)
