"""Task-Aligned Assigner (TOOD / TAL), batched over padded GT rows.

Counterpart of ``yolo_ad_refine_tpu/train/tal.py`` (reference
ultralytics/utils/tal.py:13-266) with the fork's topk=10, alpha=0.5,
beta=6.0. GT comes as fixed (B, max_boxes) rows with a validity mask. The
per-GT top-k uses ``topk`` rounds of argmax + mask, as the JAX package does:
``torch.argmax`` returns the first maximal index, like ``jnp.argmax``,
whereas ``torch.topk`` leaves the order of ties unspecified.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from yolo_ad_refine_tpu_torch.ops.iou import bbox_iou


class AssignResult(NamedTuple):
    target_labels: torch.Tensor  # (B, A) int64
    target_bboxes: torch.Tensor  # (B, A, 4) xyxy (units of the inputs)
    target_scores: torch.Tensor  # (B, A, nc) soft targets
    fg_mask: torch.Tensor        # (B, A) bool
    target_gt_idx: torch.Tensor  # (B, A) int64


def select_candidates_in_gts(anc_points, gt_bboxes, eps: float = 1e-9):
    """Anchors strictly inside GT boxes: anc (A, 2), gt (B, N, 4) -> (B, N, A)."""
    lt = gt_bboxes[..., None, :2]
    rb = gt_bboxes[..., None, 2:4]
    deltas = torch.cat([anc_points[None, None] - lt, rb - anc_points[None, None]], dim=-1)
    return deltas.amin(dim=-1) > eps


def select_topk_candidates(metrics, topk: int, row_valid):
    """Per-GT top-k anchor mask (B, N, A) in metrics.dtype: ``topk`` rounds
    of argmax (first index on ties) with the winner masked to -inf; rows
    that are not valid GT select nothing (tal.py:59-86)."""
    sel = torch.zeros(metrics.shape, dtype=torch.bool, device=metrics.device)
    m = metrics.clone()
    for _ in range(topk):
        hit = F.one_hot(m.argmax(dim=-1), metrics.shape[-1]).bool()
        sel |= hit
        m.masked_fill_(hit, float("-inf"))
    return (sel & row_valid[..., None]).to(metrics.dtype)


class TaskAlignedAssigner:
    def __init__(self, topk: int = 10, num_classes: int = 80, alpha: float = 0.5,
                 beta: float = 6.0, eps: float = 1e-9):
        self.topk, self.nc, self.alpha, self.beta, self.eps = topk, num_classes, alpha, beta, eps

    @torch.no_grad()
    def __call__(self, pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes,
                 mask_gt) -> AssignResult:
        """pd_scores (B, A, nc) sigmoided, pd_bboxes (B, A, 4) xyxy, anc_points
        (A, 2), gt_labels (B, N, 1), gt_bboxes (B, N, 4) xyxy, mask_gt
        (B, N, 1); all in image pixels."""
        b, a = pd_scores.shape[:2]
        n = gt_bboxes.shape[1]
        dev = pd_scores.device
        if n == 0:
            return AssignResult(
                torch.full((b, a), self.nc, dtype=torch.long, device=dev),
                torch.zeros((b, a, 4), dtype=pd_bboxes.dtype, device=dev),
                torch.zeros((b, a, self.nc), dtype=pd_scores.dtype, device=dev),
                torch.zeros((b, a), dtype=torch.bool, device=dev),
                torch.zeros((b, a), dtype=torch.long, device=dev))

        mask_gt_b = mask_gt[..., 0] > 0  # (B, N)
        valid = select_candidates_in_gts(anc_points, gt_bboxes, self.eps) & mask_gt_b[..., None]

        labels = gt_labels[..., 0].long().clamp(0, self.nc - 1)  # (B, N)
        bbox_scores = torch.gather(pd_scores.transpose(1, 2), 1,
                                   labels[:, :, None].expand(b, n, a))  # (B, N, A)
        bbox_scores = torch.where(valid, bbox_scores, 0.0)
        overlaps = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :], xywh=False,
                            CIoU=True)
        overlaps = torch.where(valid, overlaps.clamp(min=0), 0.0)
        align_metric = bbox_scores.pow(self.alpha) * overlaps.pow(self.beta)

        mask_topk = select_topk_candidates(align_metric, min(self.topk, a), mask_gt_b)
        mask_pos = mask_topk * valid.to(align_metric.dtype)  # (B, N, A)

        # an anchor claimed by several GTs goes to the one it overlaps most
        fg_counts = mask_pos.sum(dim=-2)  # (B, A)
        is_max = F.one_hot(overlaps.argmax(dim=1), n).to(mask_pos.dtype).transpose(1, 2)
        mask_pos = torch.where(fg_counts[:, None, :] > 1, is_max, mask_pos)
        fg_mask = mask_pos.sum(dim=-2) > 0
        target_gt_idx = mask_pos.argmax(dim=-2)  # (B, A)

        target_labels = torch.gather(labels, 1, target_gt_idx)
        target_bboxes = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(b, a, 4))
        target_scores = F.one_hot(target_labels, self.nc).to(pd_scores.dtype)
        target_scores = torch.where(fg_mask[..., None], target_scores, 0.0)
        target_labels = torch.where(fg_mask, target_labels, self.nc)

        align_metric = align_metric * mask_pos
        pos_align = align_metric.amax(dim=-1, keepdim=True)  # (B, N, 1)
        pos_overlaps = (overlaps * mask_pos).amax(dim=-1, keepdim=True)
        norm = (align_metric * pos_overlaps / (pos_align + self.eps)).amax(dim=-2)  # (B, A)
        target_scores = target_scores * norm[..., None]
        return AssignResult(target_labels, target_bboxes, target_scores, fg_mask, target_gt_idx)
