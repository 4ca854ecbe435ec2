"""Elementwise IoU (with the CIoU variant), the NWD similarity and the
probabilistic IoU of oriented boxes.

Counterpart of ``yolo_ad_refine_tpu/ops/iou.py`` (reference
ultralytics/utils/metrics.py:74 bbox_iou, :539 wasserstein_loss, :804
probiou). All broadcast over leading dimensions of (..., 4) xyxy / xywh or
(..., 5) xywhr box tensors.
"""

from __future__ import annotations

import math

import torch


def _corners(box, xywh: bool):
    if xywh:
        xy, wh = box[..., :2], box[..., 2:4]
        half = wh * 0.5
        return xy - half, xy + half
    return box[..., :2], box[..., 2:4]


def bbox_iou(box1, box2, xywh: bool = True, GIoU: bool = False, DIoU: bool = False,
             CIoU: bool = False, eps: float = 1e-7):
    """Elementwise IoU between broadcastable (..., 4) boxes. CIoU's
    aspect-ratio factor ``alpha`` carries no gradient (reference
    metrics.py:124-126)."""
    p1, p2 = _corners(box1, xywh)
    g1, g2 = _corners(box2, xywh)
    wh1 = p2 - p1
    wh2 = g2 - g1
    w1, h1 = wh1[..., 0], wh1[..., 1] + (0.0 if xywh else eps)
    w2, h2 = wh2[..., 0], wh2[..., 1] + (0.0 if xywh else eps)

    inter_wh = (torch.minimum(p2, g2) - torch.maximum(p1, g1)).clamp(min=0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (GIoU or DIoU or CIoU):
        return iou

    cwh = torch.maximum(p2, g2) - torch.minimum(p1, g1)  # convex hull
    cw, ch = cwh[..., 0], cwh[..., 1]
    if GIoU:
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    c2 = cw**2 + ch**2 + eps  # convex diagonal squared
    rho2 = (((g1[..., 0] + g2[..., 0]) - (p1[..., 0] + p2[..., 0])) ** 2
            + ((g1[..., 1] + g2[..., 1]) - (p1[..., 1] + p2[..., 1])) ** 2) / 4
    if DIoU:
        return iou - rho2 / c2
    v = (4 / math.pi**2) * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)


def wasserstein_similarity(pred, target, eps: float = 1e-7, constant: float = 12.8):
    """exp(-sqrt(W2) / constant) NWD similarity between xyxy boxes
    (reference metrics.py:539-565; eps is added to heights only, as there)."""
    w1 = pred[..., 2] - pred[..., 0]
    h1 = pred[..., 3] - pred[..., 1] + eps
    w2 = target[..., 2] - target[..., 0]
    h2 = target[..., 3] - target[..., 1] + eps
    cx1 = pred[..., 0] + w1 / 2
    cy1 = pred[..., 1] + h1 / 2
    cx2 = target[..., 0] + w2 / 2
    cy2 = target[..., 1] + h2 / 2
    center_d = (cx1 - cx2) ** 2 + (cy1 - cy2) ** 2 + eps
    wh_d = ((w1 - w2) ** 2 + (h1 - h2) ** 2) / 4
    return torch.exp(-torch.sqrt(center_d + wh_d) / constant)


def _obb_covariance(obb):
    """Gaussian covariance terms (a, b, c) of xywhr boxes (reference
    metrics.py _get_covariance_matrix)."""
    w, h, r = obb[..., 2], obb[..., 3], obb[..., 4]
    a = w**2 / 12.0
    b = h**2 / 12.0
    cos, sin = torch.cos(r), torch.sin(r)
    return a * cos**2 + b * sin**2, a * sin**2 + b * cos**2, (a - b) * cos * sin


def probiou(obb1, obb2, CIoU: bool = False, eps: float = 1e-7):
    """Probabilistic IoU of broadcastable xywhr boxes: 1 - the Hellinger
    distance of their Gaussians (reference metrics.py:804, arXiv:2106.06072).
    CIoU's aspect-ratio factor carries no gradient, as in ``bbox_iou``."""
    x1, y1 = obb1[..., 0], obb1[..., 1]
    x2, y2 = obb2[..., 0], obb2[..., 1]
    a1, b1, c1 = _obb_covariance(obb1)
    a2, b2, c2 = _obb_covariance(obb2)
    denom = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / denom * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / denom * 0.5
    t3 = 0.5 * torch.log(
        ((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2)
        / (4 * torch.sqrt((a1 * b1 - c1**2).clamp(min=0) * (a2 * b2 - c2**2).clamp(min=0)) + eps)
        + eps)
    bd = (t1 + t2 + t3).clamp(eps, 100.0)
    iou = 1.0 - torch.sqrt(1.0 - torch.exp(-bd) + eps)
    if CIoU:
        w1, h1 = obb1[..., 2], obb1[..., 3]
        w2, h2 = obb2[..., 2], obb2[..., 3]
        v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
        with torch.no_grad():
            alpha = v / (v - iou + (1 + eps))
        return iou - v * alpha
    return iou


def batch_probiou(obb1, obb2, eps: float = 1e-7):
    """Pairwise probiou (N, 5) x (M, 5) -> (N, M) (reference metrics.py
    batch_probiou)."""
    return probiou(obb1[:, None, :], obb2[None, :, :], eps=eps)
