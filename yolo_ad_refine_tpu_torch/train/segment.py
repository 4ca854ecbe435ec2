"""Segment task loss and its index masks.

Counterpart of ``yolo_ad_refine_tpu/train/segment.py`` (reference
utils/loss.py v8SegmentationLoss, data/utils.py polygons2masks_overlap):
the fork's detection loss (``train/loss.py``, SlideLoss and NWD at 0.5)
plus a mask BCE over the foreground anchors, each anchor's mask
sigmoid-free logits coeffs @ proto against its GT instance's mask,
averaged over the box's crop window and divided by the box's normalised
area (clipped at 1e-4). As in the JAX package each image keeps a fixed
``max_fg`` anchors, the foreground first: once an image has more
foreground anchors than that, which are kept is decided by index, the
lowest first (``jax.lax.top_k``'s tie order, here a stable sort; a
``torch.topk`` leaves the order of ties unspecified).
seg = sum over images / max(foreground count, 1) * box gain, the
components [box, seg, cls, dfl] and total = sum(components) * batch, that
is the detection total + seg * batch. Within a data-parallel step
(``parallel.global_batch``) the foreground count and the batch factor are
the global batch's.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_ad_refine_tpu_torch.ops.masks import crop_mask
from yolo_ad_refine_tpu_torch.train.loss import (
    DetectionLoss, LossOutputs, bce_with_logits, total_of)


def top_foreground(fg_mask: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) anchor indices: each image's foreground anchors first, in
    index order, then the rest in index order (``jax.lax.top_k`` of the 0/1
    mask)."""
    return torch.sort(fg_mask.to(torch.uint8), dim=1, descending=True, stable=True)[1][:, :k]


def take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (B, k) of t (B, A, ...) along dim 1."""
    return torch.gather(t, 1, idx.reshape(*idx.shape, *([1] * (t.ndim - 2))).expand(
        *idx.shape, *t.shape[2:]))


class SegmentationLoss:
    """The detection loss plus the mask BCE over the foreground anchors."""

    extra_keys = ("masks",)  # the batch's targets past cls, bboxes, mask (train/step.py)

    def __init__(self, nc: int, strides, reg_max: int = 16, max_fg: int = 128,
                 box_gain: float = 7.5, cls_gain: float = 0.5, dfl_gain: float = 1.5,
                 nwd_ratio: float = 0.5):
        self.det = DetectionLoss(nc=nc, strides=strides, reg_max=reg_max, box_gain=box_gain,
                                 cls_gain=cls_gain, dfl_gain=dfl_gain, nwd_ratio=nwd_ratio)
        self.max_fg = max_fg
        self.box_gain = box_gain

    def __call__(self, preds, gt_labels, gt_bboxes, mask_gt, index_masks) -> LossOutputs:
        """preds = (feats, mc, proto), the Segment head's train output:
        mc (B, A, nm), proto (B, nm, mh, mw); index_masks (B, mh, mw) int,
        0 the background and i + 1 GT row i (the collate's ``masks``)."""
        feats, mc, proto = preds
        with torch.autocast(feats[0].device.type, enabled=False):
            comps, parts = self.det.components(feats, gt_labels, gt_bboxes, mask_gt)
            b = feats[0].shape[0]
            mh, mw = proto.shape[2:]
            s0 = self.det.strides[0]
            ih, iw = feats[0].shape[2] * s0, feats[0].shape[3] * s0
            a = parts.assign
            sel = top_foreground(a.fg_mask, min(self.max_fg, a.fg_mask.shape[1]))
            valid = take(a.fg_mask, sel).to(parts.acc)
            gti = take(a.target_gt_idx, sel)
            boxes = take(a.target_bboxes, sel)  # (B, k, 4) xyxy input pixels
            coeffs = take(mc.to(parts.acc), sel)
            gt_masks = (index_masks.to(gti.device)[:, None] == (gti[..., None, None] + 1)).to(
                parts.acc)
            pred = torch.einsum("bkn,bnhw->bkhw", coeffs, proto.to(parts.acc))
            scale = torch.tensor([mw / iw, mh / ih, mw / iw, mh / ih], dtype=parts.acc,
                                 device=boxes.device)
            bce = crop_mask(bce_with_logits(pred, gt_masks), boxes * scale)
            area = ((boxes[..., 2] - boxes[..., 0]) / iw * (boxes[..., 3] - boxes[..., 1]) / ih
                    ).clamp(min=1e-4)
            per_anchor = bce.mean(dim=(2, 3)) / area
            seg = (per_anchor * valid).sum() / parts.n_fg.clamp(min=1.0) * self.box_gain
            return total_of(torch.stack([comps[0], seg, comps[1], comps[2]]), b)


def polygons_to_index_mask(polygons: list[np.ndarray], shape: tuple[int, int]) -> np.ndarray:
    """Instance polygons (pixels) drawn into an (h, w) int32 index mask,
    i + 1 for polygon i (reference data/utils.py polygons2masks_overlap):
    each is filled with cv2 at its int32-truncated points, the larger
    first, so that where instances overlap the smaller one wins."""
    import cv2

    h, w = shape
    filled = []
    for poly in polygons:
        m = np.zeros((h, w), np.uint8)
        cv2.fillPoly(m, [poly.astype(np.int32).reshape(-1, 2)], 1)
        filled.append(m)
    mask = np.zeros((h, w), np.int32)
    for i in np.argsort(-np.asarray([m.sum() for m in filled])) if filled else []:
        mask[filled[i] > 0] = i + 1
    return mask
