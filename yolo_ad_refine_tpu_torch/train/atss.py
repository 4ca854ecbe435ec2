"""ATSS, the fork's selectable alternative to the TAL assigner.

Counterpart of ``yolo_ad_refine_tpu/train/atss.py`` (reference
utils/atss.py:396-549 ATSSAssigner, generate_anchors:52, bbox_overlaps:118),
reached through ``DetectionLoss(assigner="atss")``. Adaptive training sample
selection: per GT, the ``topk`` anchors closest to its centre on each level
are candidates (ties to the lower index, as ``lax.top_k``); the IoU
threshold is the candidates' mean + std; the positives are candidates over
it whose centres lie inside the GT; an anchor claimed by several GTs goes to
the one of highest IoU. The target scores are the one-hot classes scaled by
the IoU of the prediction with its target.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolo_ad_refine_tpu_torch.ops.iou import bbox_iou
from yolo_ad_refine_tpu_torch.train.tal import AssignResult


def generate_cell_anchors(feat_shapes, strides, grid_cell_size: float = 5.0,
                          offset: float = 0.5, device=None):
    """Each level's cell anchors, boxes of grid_cell_size x stride around
    the cell centres, as (A, 4) xyxy, and the anchor count of each level."""
    anchors, counts = [], []
    for (h, w), s in zip(feat_shapes, strides):
        half = grid_cell_size * s * 0.5
        sx = (torch.arange(w, dtype=torch.float32, device=device) + offset) * s
        sy = (torch.arange(h, dtype=torch.float32, device=device) + offset) * s
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        centers = torch.stack([gx, gy], -1).reshape(-1, 2)
        anchors.append(torch.cat([centers - half, centers + half], -1))
        counts.append(h * w)
    return torch.cat(anchors), counts


class ATSSAssigner:
    """Adaptive training sample selection over masked, fixed-size GT rows."""

    def __init__(self, topk: int = 9, num_classes: int = 80, eps: float = 1e-9):
        self.topk = topk
        self.nc = num_classes
        self.eps = eps

    @torch.no_grad()
    def __call__(self, anchors, counts, gt_labels, gt_bboxes, mask_gt, pd_bboxes) -> AssignResult:
        """anchors (A, 4) xyxy cell anchors; counts: the levels' anchor
        counts; gt_labels (B, N, 1), gt_bboxes (B, N, 4) xyxy in pixels,
        mask_gt (B, N, 1); pd_bboxes (B, A, 4) decoded predictions in pixels
        (for the soft target scores)."""
        b, n = gt_bboxes.shape[:2]
        a = anchors.shape[0]
        mask_gt_b = mask_gt[..., 0] > 0
        ious = bbox_iou(gt_bboxes[:, :, None, :], anchors[None, None], xywh=False)  # (B, N, A)
        anchor_centers = (anchors[:, :2] + anchors[:, 2:]) / 2
        gt_centers = (gt_bboxes[..., :2] + gt_bboxes[..., 2:]) / 2
        dist = (gt_centers[:, :, None, :] - anchor_centers[None, None]).norm(dim=-1)

        is_candidate = torch.zeros((b, n, a), dtype=torch.bool, device=gt_bboxes.device)
        start = 0
        for c in counts:
            k = min(self.topk, c)
            idx = torch.sort(dist[:, :, start:start + c], dim=-1, stable=True).indices[..., :k]
            is_candidate[:, :, start:start + c].scatter_(-1, idx, True)
            start += c

        cand_ious = torch.where(is_candidate, ious, 0.0)
        n_cand = is_candidate.sum(-1, keepdim=True).clamp(min=1)
        mean_iou = cand_ious.sum(-1, keepdim=True) / n_cand
        var = torch.where(is_candidate, (ious - mean_iou) ** 2, 0.0).sum(-1, keepdim=True) / n_cand
        thresh = mean_iou + var.sqrt()

        lt, rb = gt_bboxes[..., None, :2], gt_bboxes[..., None, 2:4]
        inside = torch.cat([anchor_centers[None, None] - lt, rb - anchor_centers[None, None]],
                           -1).amin(-1) > self.eps
        mask_pos = (is_candidate & (ious >= thresh) & inside & mask_gt_b[..., None]).float()

        # an anchor of several GTs goes to the GT of the highest IoU (as TAL)
        fg_counts = mask_pos.sum(-2)
        is_max = F.one_hot(torch.where(mask_gt_b[..., None], ious, -1.0).argmax(1), n).permute(
            0, 2, 1).float()
        mask_pos = torch.where(fg_counts[:, None, :] > 1, is_max, mask_pos)
        fg_mask = mask_pos.sum(-2) > 0
        target_gt_idx = mask_pos.argmax(-2)

        labels = gt_labels[..., 0].long().clamp(0, self.nc - 1)
        target_labels = torch.gather(labels, 1, target_gt_idx)
        target_bboxes = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(-1, -1, 4))
        pred_iou = bbox_iou(pd_bboxes, target_bboxes, xywh=False).clamp(min=0.0)
        target_scores = F.one_hot(target_labels, self.nc).to(pd_bboxes.dtype) * \
            (pred_iou * fg_mask)[..., None]
        target_labels = torch.where(fg_mask, target_labels, self.nc)
        return AssignResult(target_labels, target_bboxes, target_scores, fg_mask, target_gt_idx)
