"""OBB task loss: the rotated TAL assigner and v8OBBLoss.

Counterpart of ``yolo_ad_refine_tpu/train/obb.py`` (reference
utils/loss.py v8OBBLoss, tal.py RotatedTaskAlignedAssigner,
RotatedBboxLoss): TAL with probiou overlaps and a point-in-rotated-box
candidate test; the box loss is 1 - probiou, the class loss plain BCE (the
flagship's SlideLoss and NWD are not part of it, as in the JAX package) and
DFL on the axis-aligned ltrb of the target in grid units; gains 7.5 / 0.5 /
1.5, total = sum(components) * batch. GT comes as (B, N, 5) xywhr pixels.
Within a data-parallel step (``parallel.global_batch``),
target_scores_sum and the batch factor are the global batch's
(``train/loss.py global_total``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from yolo_ad_refine_tpu_torch.nn.head import dist2rbox
from yolo_ad_refine_tpu_torch.ops.anchors import bbox2dist, make_anchors
from yolo_ad_refine_tpu_torch.ops.iou import probiou
from yolo_ad_refine_tpu_torch.parallel import all_reduce_sum, in_global_batch
from yolo_ad_refine_tpu_torch.train.loss import bce_with_logits, dfl_loss, total_of
from yolo_ad_refine_tpu_torch.train.tal import (
    AssignResult, TaskAlignedAssigner, select_topk_candidates)


def select_candidates_in_rotated_gts(anc_points, gt_bboxes, eps: float = 1e-9):
    """Anchor centers inside rotated GT boxes by the corner-vector test:
    anc (A, 2), gt (B, N, 5) xywhr -> (B, N, A) bool."""
    cx, cy, w, h, r = gt_bboxes.unbind(-1)
    cos, sin = torch.cos(r), torch.sin(r)
    vec1 = torch.stack([w / 2 * cos, w / 2 * sin], -1)  # half-extent vectors (B, N, 2)
    vec2 = torch.stack([-h / 2 * sin, h / 2 * cos], -1)
    ctr = torch.stack([cx, cy], -1)
    a = ctr - vec1 - vec2  # corners
    b = ctr + vec1 - vec2
    d = ctr - vec1 + vec2
    ap = anc_points[None, None] - a[..., None, :]  # (B, N, A, 2)
    ab = (b - a)[..., None, :]
    ad = (d - a)[..., None, :]
    norm_ab = (ab * ab).sum(-1)
    norm_ad = (ad * ad).sum(-1)
    ap_dot_ab = (ap * ab).sum(-1)
    ap_dot_ad = (ap * ad).sum(-1)
    return (ap_dot_ab >= eps) & (ap_dot_ab <= norm_ab) & (ap_dot_ad >= eps) & (ap_dot_ad <= norm_ad)


class RotatedTaskAlignedAssigner(TaskAlignedAssigner):
    """TAL with probiou overlaps and the rotated candidate test."""

    @torch.no_grad()
    def __call__(self, pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes,
                 mask_gt) -> AssignResult:
        """pd_scores (B, A, nc) sigmoided; pd_bboxes (B, A, 5) and gt_bboxes
        (B, N, 5) xywhr in pixels; anc_points (A, 2) pixels; gt_labels and
        mask_gt (B, N, 1)."""
        b, a = pd_scores.shape[:2]
        n = gt_bboxes.shape[1]
        mask_gt_b = mask_gt[..., 0] > 0
        valid = select_candidates_in_rotated_gts(anc_points, gt_bboxes) & mask_gt_b[..., None]

        labels = gt_labels[..., 0].long().clamp(0, self.nc - 1)
        bbox_scores = torch.gather(pd_scores.transpose(1, 2), 1,
                                   labels[:, :, None].expand(b, n, a))
        bbox_scores = torch.where(valid, bbox_scores, 0.0)
        overlaps = probiou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :])
        overlaps = torch.where(valid, overlaps.clamp(min=0.0), 0.0)
        align_metric = bbox_scores.pow(self.alpha) * overlaps.pow(self.beta)

        mask_topk = select_topk_candidates(align_metric, min(self.topk, a), mask_gt_b)
        mask_pos = mask_topk * valid.to(align_metric.dtype)
        # an anchor claimed by several GTs goes to the one it overlaps most
        fg_counts = mask_pos.sum(dim=-2)
        is_max = F.one_hot(overlaps.argmax(dim=1), n).to(mask_pos.dtype).transpose(1, 2)
        mask_pos = torch.where(fg_counts[:, None, :] > 1, is_max, mask_pos)
        fg_mask = mask_pos.sum(dim=-2) > 0
        target_gt_idx = mask_pos.argmax(dim=-2)

        target_labels = torch.gather(labels, 1, target_gt_idx)
        target_bboxes = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(b, a, 5))
        target_scores = F.one_hot(target_labels, self.nc).to(pd_scores.dtype)
        target_scores = torch.where(fg_mask[..., None], target_scores, 0.0)
        target_labels = torch.where(fg_mask, target_labels, self.nc)

        align_metric = align_metric * mask_pos
        pos_align = align_metric.amax(dim=-1, keepdim=True)
        pos_overlaps = (overlaps * mask_pos).amax(dim=-1, keepdim=True)
        norm = (align_metric * pos_overlaps / (pos_align + self.eps)).amax(dim=-2)
        target_scores = target_scores * norm[..., None]
        return AssignResult(target_labels, target_bboxes, target_scores, fg_mask, target_gt_idx)


class OBBLossOutputs(NamedTuple):
    total: torch.Tensor       # scalar: sum(components) * batch size
    components: torch.Tensor  # (3,) detached [box, cls, dfl], gain-scaled


class OBBLoss:
    """v8OBBLoss: 1 - probiou box loss, BCE class loss and DFL."""

    def __init__(self, nc: int, strides, reg_max: int = 16, box_gain: float = 7.5,
                 cls_gain: float = 0.5, dfl_gain: float = 1.5):
        self.nc = nc
        self.strides = tuple(strides)
        self.reg_max = reg_max
        self.no = nc + reg_max * 4
        self.gains = (box_gain, cls_gain, dfl_gain)
        self.assigner = RotatedTaskAlignedAssigner(topk=10, num_classes=nc, alpha=0.5, beta=6.0)

    def __call__(self, preds, gt_labels, gt_rboxes, mask_gt) -> OBBLossOutputs:
        """preds = (feats, angle), the OBB head's train output (and the second
        half of its eval output): per-level (B, 4*reg_max + nc, H, W) maps
        and the angle (B, A, 1); gt_labels (B, N, 1), gt_rboxes (B, N, 5)
        xywhr in input pixels (padded rows 0), mask_gt (B, N, 1)."""
        with torch.autocast(preds[0][0].device.type, enabled=False):
            return self._loss(preds, gt_labels, gt_rboxes, mask_gt)

    def _loss(self, preds, gt_labels, gt_rboxes, mask_gt) -> OBBLossOutputs:
        feats, pred_angle = preds
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
        angle = pred_angle.to(acc)[..., 0]
        pred_rboxes = torch.cat([dist2rbox(dist, angle, anchor_points[None]), angle[..., None]],
                                -1)  # (B, A, 5) grid units + angle

        assign = self.assigner(
            pred_scores.detach().sigmoid(),
            torch.cat([pred_rboxes[..., :4].detach() * stride_tensor[None],
                       angle.detach()[..., None]], -1),
            anchor_points * stride_tensor, gt_labels, gt_rboxes.to(acc), mask_gt.to(acc))
        global_ = in_global_batch()
        tss = assign.target_scores.sum()
        target_scores_sum = torch.clamp(all_reduce_sum(tss) if global_ else tss, min=1.0)

        loss_cls = bce_with_logits(pred_scores, assign.target_scores).sum() / target_scores_sum

        tb = assign.target_bboxes
        tb_g = torch.cat([tb[..., :4] / stride_tensor[None], tb[..., 4:]], -1)
        weight = assign.target_scores.sum(dim=-1) * assign.fg_mask
        iou = probiou(pred_rboxes, tb_g)
        loss_box = ((1.0 - iou) * weight).sum() / target_scores_sum

        xy, wh = tb_g[..., :2], tb_g[..., 2:4]
        target_ltrb = bbox2dist(anchor_points[None], torch.cat([xy - wh / 2, xy + wh / 2], -1),
                                self.reg_max - 1)
        ldfl = dfl_loss(pred_distri.reshape(b, -1, 4, self.reg_max), target_ltrb, self.reg_max)
        loss_dfl = (ldfl * weight).sum() / target_scores_sum

        comps = torch.stack([loss_box * self.gains[0], loss_cls * self.gains[1],
                             loss_dfl * self.gains[2]])
        return OBBLossOutputs(*total_of(comps, b))
