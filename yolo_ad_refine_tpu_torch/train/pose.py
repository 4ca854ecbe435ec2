"""Pose task loss.

Counterpart of ``yolo_ad_refine_tpu/train/pose.py`` (reference
utils/loss.py v8PoseLoss, KeypointLoss): the fork's detection loss
(``train/loss.py``) plus, over each image's ``max_fg`` anchors (the
foreground first, lowest index first, as ``train/segment.py`` keeps
them), the OKS-style keypoint location loss of the keypoints decoded as
(k * 2 + anchor - 0.5) * stride against the assigned GT's, and the
visibility BCE against (visibility > 0) on the foreground. kpt_loc is the
mean over images times the pose gain (12), kpt_vis likewise with kobj (1);
the components are [box, kpt_loc, kpt_vis, cls, dfl] and total =
sum(components) * batch. Within a data-parallel step
(``parallel.global_batch``) the means are over the global batch.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_ad_refine_tpu_torch.parallel import in_global_batch
from yolo_ad_refine_tpu_torch.parallel.multihost import world_size
from yolo_ad_refine_tpu_torch.train.loss import (
    DetectionLoss, LossOutputs, bce_with_logits, total_of)
from yolo_ad_refine_tpu_torch.train.segment import take, top_foreground

# COCO's 17 keypoints' OKS sigmas (reference utils/metrics.py OKS_SIGMA)
OKS_SIGMA = np.array([0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62,
                      1.07, 1.07, 0.87, 0.87, 0.89, 0.89]) / 10.0


def keypoint_loss(pred_kpts, gt_kpts, kpt_mask, area, sigmas):
    """OKS-style distance loss (reference loss.py:338-352 KeypointLoss) of
    (..., k, K, 2) predictions against (..., k, K, 2) GT: each row weighted
    by K over its count of masked keypoints. Returns the mean over the last
    two dimensions (..., ), area (..., k, 1)."""
    d = (pred_kpts[..., 0] - gt_kpts[..., 0]) ** 2 + (pred_kpts[..., 1] - gt_kpts[..., 1]) ** 2
    factor = kpt_mask.shape[-1] / ((kpt_mask != 0).sum(-1) + 1e-9)
    e = d / ((2 * sigmas) ** 2 * (area + 1e-9) * 2)
    return (factor[..., None] * ((1 - torch.exp(-e)) * kpt_mask)).mean(dim=(-2, -1))


class PoseLoss:
    """The detection loss plus the keypoint location and visibility losses."""

    extra_keys = ("keypoints",)  # the batch's targets past cls, bboxes, mask (train/step.py)

    def __init__(self, nc: int, strides, kpt_shape=(17, 3), reg_max: int = 16,
                 max_fg: int = 64, box_gain: float = 7.5, cls_gain: float = 0.5,
                 dfl_gain: float = 1.5, pose_gain: float = 12.0, kobj_gain: float = 1.0):
        self.det = DetectionLoss(nc=nc, strides=strides, reg_max=reg_max, box_gain=box_gain,
                                 cls_gain=cls_gain, dfl_gain=dfl_gain)
        self.kpt_shape = tuple(kpt_shape)
        self.max_fg = max_fg
        self.pose_gain, self.kobj_gain = pose_gain, kobj_gain
        nk = self.kpt_shape[0]
        self.sigmas = OKS_SIGMA if self.kpt_shape == (17, 3) else np.ones(nk) / nk

    def __call__(self, preds, gt_labels, gt_bboxes, mask_gt, gt_kpts) -> LossOutputs:
        """preds = (feats, kpt), the Pose head's train output, kpt (B, A,
        K * ndim) raw; gt_kpts (B, N, K, 3) input pixels with the
        visibility last (padded rows zero)."""
        feats, kpt_raw = preds
        with torch.autocast(feats[0].device.type, enabled=False):
            comps, parts = self.det.components(feats, gt_labels, gt_bboxes, mask_gt)
            b = feats[0].shape[0]
            k_n, ndim = self.kpt_shape
            kp = kpt_raw.to(parts.acc).reshape(b, -1, k_n, ndim)
            xy = (kp[..., :2] * 2.0 + (parts.anchor_points[None, :, None, :] - 0.5)) \
                * parts.stride_tensor[None, :, None, :]
            a = parts.assign
            sel = top_foreground(a.fg_mask, min(self.max_fg, a.fg_mask.shape[1]))
            valid = take(a.fg_mask, sel).to(parts.acc)
            boxes = take(a.target_bboxes, sel)
            area = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])).clamp(
                min=1e-9)
            gk = take(gt_kpts.to(device=xy.device, dtype=parts.acc), take(a.target_gt_idx, sel))
            kpt_mask = (gk[..., 2] > 0).to(parts.acc) * valid[..., None]
            sigmas = torch.as_tensor(self.sigmas, dtype=parts.acc, device=xy.device)
            loc = keypoint_loss(take(xy, sel), gk[..., :2], kpt_mask, area[..., None], sigmas)
            vis = ((bce_with_logits(take(kp[..., 2], sel), kpt_mask) * valid[..., None]).mean(
                dim=(1, 2)) if ndim == 3 else torch.zeros_like(loc))
            n_img = b * world_size() if in_global_batch() else b  # the global batch's mean
            kpt_loc = loc.sum() / n_img * self.pose_gain
            kpt_vis = vis.sum() / n_img * self.kobj_gain
            return total_of(torch.stack([comps[0], kpt_loc, kpt_vis, comps[1], comps[2]]), b)
