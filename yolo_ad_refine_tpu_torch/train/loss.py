"""Detection training loss: the fork-modified v8DetectionLoss.

Counterpart of ``yolo_ad_refine_tpu/train/loss.py`` (reference
ultralytics/utils/loss.py: SlideLoss:18-42, BboxLoss:264-311 with CIoU mixed
50/50 with NWD, DFL:238-261, v8DetectionLoss:355-520): TAL assignment
(topk=10, alpha=0.5, beta=6.0), SlideLoss-weighted BCE with the mean
foreground CIoU as ``auto_iou``, gains box=7.5 / cls=0.5 / dfl=1.5, and
total = sum(components) * batch. The loss math runs in fp32 outside any
autocast, whatever type the model computed in (in fp64 for fp64 maps, which
the tests use as a reference).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from yolo_ad_refine_tpu_torch.ops.anchors import bbox2dist, dist2bbox, make_anchors
from yolo_ad_refine_tpu_torch.ops.iou import bbox_iou, wasserstein_similarity
from yolo_ad_refine_tpu_torch.train.tal import TaskAlignedAssigner


class LossOutputs(NamedTuple):
    total: torch.Tensor       # scalar: loss.sum() * batch_size
    components: torch.Tensor  # (3,) detached [box, cls, dfl], gain-scaled


def bce_with_logits(logits, targets):
    """Per-element binary cross-entropy with logits."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def slide_weight(targets, auto_iou):
    """SlideLoss weight over the target score: 1 below auto_iou - 0.1,
    e^(1 - auto_iou) inside the band, e^(1 - t) from auto_iou up; auto_iou
    is floored at 0.2."""
    auto_iou = torch.clamp(auto_iou, min=0.2)
    b1 = (targets <= auto_iou - 0.1).to(targets.dtype)
    b2 = ((targets > auto_iou - 0.1) & (targets < auto_iou)).to(targets.dtype)
    b3 = (targets >= auto_iou).to(targets.dtype)
    return 1.0 * b1 + torch.exp(1.0 - auto_iou) * b2 + torch.exp(-(targets - 1.0)) * b3


def dfl_loss(pred_dist, target, reg_max: int = 16):
    """Distribution focal loss as the hat-weighted sum over bins: pred_dist
    (..., 4, reg_max) logits, target (..., 4) in [0, reg_max - 1). Returns
    (...,), the mean over the 4 sides."""
    logp = torch.log_softmax(pred_dist, dim=-1)
    bins = torch.arange(reg_max, dtype=target.dtype, device=target.device)
    w = (1.0 - (target[..., None] - bins).abs()).clamp(min=0.0)
    return (-(logp * w).sum(dim=-1)).mean(dim=-1)


class DetectionLoss:
    def __init__(self, nc: int, strides, reg_max: int = 16, tal_topk: int = 10,
                 box_gain: float = 7.5, cls_gain: float = 0.5, dfl_gain: float = 1.5,
                 nwd_ratio: float = 0.5, use_slide_loss: bool = True):
        self.nc = nc
        self.strides = tuple(strides)
        self.reg_max = reg_max
        self.no = nc + reg_max * 4
        self.gains = (box_gain, cls_gain, dfl_gain)
        self.nwd_ratio = nwd_ratio
        self.use_slide_loss = use_slide_loss
        self.assigner = TaskAlignedAssigner(topk=tal_topk, num_classes=nc, alpha=0.5, beta=6.0)

    def __call__(self, feats, gt_labels, gt_bboxes, mask_gt) -> LossOutputs:
        """feats: per-level (B, 4*reg_max + nc, H, W) maps, the head's
        train-mode output; gt_labels (B, N, 1), gt_bboxes (B, N, 4) xyxy in
        input pixels (padded rows 0), mask_gt (B, N, 1)."""
        with torch.autocast(feats[0].device.type, enabled=False):
            return self._loss(feats, gt_labels, gt_bboxes, mask_gt)

    def _loss(self, feats, gt_labels, gt_bboxes, mask_gt) -> LossOutputs:
        b = feats[0].shape[0]
        dev = feats[0].device
        acc = torch.float64 if feats[0].dtype == torch.float64 else torch.float32
        rm4 = self.reg_max * 4
        x = torch.cat([f.permute(0, 2, 3, 1).reshape(b, -1, self.no).to(acc) for f in feats], 1)
        pred_distri, pred_scores = x[..., :rm4], x[..., rm4:]

        shapes = [(f.shape[2], f.shape[3]) for f in feats]
        anchor_points, stride_tensor = make_anchors(shapes, self.strides, 0.5, dtype=acc,
                                                    device=dev)

        dist = torch.softmax(pred_distri.reshape(b, -1, 4, self.reg_max), dim=-1)
        dist = torch.einsum("banr,r->ban", dist,
                            torch.arange(self.reg_max, dtype=acc, device=dev))
        pred_bboxes = dist2bbox(dist, anchor_points[None], xywh=False)  # grid units

        gt_bboxes = gt_bboxes.to(acc)
        mask_gt = mask_gt.to(acc)
        assign = self.assigner(pred_scores.detach().sigmoid(),
                               pred_bboxes.detach() * stride_tensor[None],
                               anchor_points * stride_tensor, gt_labels, gt_bboxes, mask_gt)
        target_bboxes, target_scores, fg_mask = (assign.target_bboxes, assign.target_scores,
                                                 assign.fg_mask)
        target_scores_sum = torch.clamp(target_scores.sum(), min=1.0)

        target_bboxes_g = target_bboxes / stride_tensor[None]
        weight = target_scores.sum(dim=-1) * fg_mask  # (B, A)
        iou = bbox_iou(pred_bboxes, target_bboxes_g, xywh=False, CIoU=True)
        loss_box = ((1.0 - iou) * weight).sum() / target_scores_sum
        nwd = wasserstein_similarity(pred_bboxes, target_bboxes_g)
        loss_nwd = ((1.0 - nwd) * weight).sum() / target_scores_sum
        loss_box = self.nwd_ratio * loss_box + (1.0 - self.nwd_ratio) * loss_nwd

        target_ltrb = bbox2dist(anchor_points[None], target_bboxes_g, self.reg_max - 1)
        ldfl = dfl_loss(pred_distri.reshape(b, -1, 4, self.reg_max), target_ltrb, self.reg_max)
        loss_dfl = (ldfl * weight).sum() / target_scores_sum

        bce = bce_with_logits(pred_scores, target_scores)
        if self.use_slide_loss:
            n_fg = fg_mask.to(acc).sum()
            mean_iou = (iou.detach() * fg_mask).sum() / torch.clamp(n_fg, min=1.0)
            auto_iou = torch.where(n_fg > 0, mean_iou, -1.0)
            bce = bce * slide_weight(target_scores, auto_iou)
        loss_cls = bce.sum() / target_scores_sum

        comps = torch.stack([loss_box * self.gains[0], loss_cls * self.gains[1],
                             loss_dfl * self.gains[2]])
        return LossOutputs(comps.sum() * b, comps.detach())
