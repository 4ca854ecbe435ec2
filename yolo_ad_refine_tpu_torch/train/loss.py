"""Detection training loss: the fork-modified v8DetectionLoss, and YOLOv10's
dual-assignment E2EDetectLoss over two of it.

Counterpart of ``yolo_ad_refine_tpu/train/loss.py`` (reference
ultralytics/utils/loss.py: SlideLoss:18-42, BboxLoss:264-311 with CIoU mixed
50/50 with NWD, DFL:238-261, v8DetectionLoss:355-520): TAL assignment
(topk=10, alpha=0.5, beta=6.0), or ATSS with ``assigner="atss"``
(``train/atss.py``, JAX train/loss.py:93-108,139-148), SlideLoss-weighted
BCE with the mean foreground CIoU as ``auto_iou``, gains box=7.5 / cls=0.5
/ dfl=1.5, and
total = sum(components) * batch. The loss math runs in fp32 outside any
autocast, whatever type the model computed in (in fp64 for fp64 maps, which
the tests use as a reference). Within a data-parallel step
(``parallel.global_batch``), the normalisers (target_scores_sum, SlideLoss's foreground
count and IoU sum) and the batch factor are the global batch's, as under
the JAX package's mesh (``global_total``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from yolo_ad_refine_tpu_torch.train.tal import AssignResult

from yolo_ad_refine_tpu_torch.ops.anchors import bbox2dist, dist2bbox, make_anchors
from yolo_ad_refine_tpu_torch.ops.iou import bbox_iou, wasserstein_similarity
from yolo_ad_refine_tpu_torch.parallel import all_reduce_sum, in_global_batch
from yolo_ad_refine_tpu_torch.parallel.multihost import world_size
from yolo_ad_refine_tpu_torch.train.atss import ATSSAssigner, generate_cell_anchors
from yolo_ad_refine_tpu_torch.train.tal import TaskAlignedAssigner


class LossOutputs(NamedTuple):
    total: torch.Tensor       # scalar: loss.sum() * batch_size
    components: torch.Tensor  # (3,) detached [box, cls, dfl], gain-scaled


class DetectionParts(NamedTuple):
    """What the task losses (``train/segment.py``, ``train/pose.py``) take
    from the detection loss besides its components."""

    assign: AssignResult
    anchor_points: torch.Tensor  # (A, 2) grid units, in ``acc``
    stride_tensor: torch.Tensor  # (A, 1)
    n_fg: torch.Tensor           # the batch's foreground count (the global batch's within one)
    acc: torch.dtype             # fp32, or fp64 for fp64 maps


def global_total(comps: torch.Tensor, b: int) -> LossOutputs:
    """The outputs of a rank's share of a data-parallel step: ``comps``
    holds this rank's sums over the global normalisers. The components
    are the global batch's (summed over the ranks) and the total's value
    is the global batch's loss, sum(components) * global batch; its
    gradient is this rank's share times the world size, which the DDP /
    FSDP2 mean over the ranks makes the global batch's gradient."""
    n = world_size()
    glob = all_reduce_sum(comps.detach())
    share = comps.sum() * (b * n) * n
    return LossOutputs(share + (glob.sum() * (b * n) - share).detach(), glob)


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
                 nwd_ratio: float = 0.5, use_slide_loss: bool = True, assigner: str = "tal"):
        if assigner not in ("tal", "atss"):
            raise ValueError(f"assigner must be 'tal' or 'atss', got {assigner}")
        self.nc = nc
        self.strides = tuple(strides)
        self.reg_max = reg_max
        self.no = nc + reg_max * 4
        self.gains = (box_gain, cls_gain, dfl_gain)
        self.nwd_ratio = nwd_ratio
        self.use_slide_loss = use_slide_loss
        self.assigner_kind = assigner
        self.assigner = TaskAlignedAssigner(topk=tal_topk, num_classes=nc, alpha=0.5, beta=6.0)
        self.atss = ATSSAssigner(topk=9, num_classes=nc) if assigner == "atss" else None

    def __call__(self, feats, gt_labels, gt_bboxes, mask_gt) -> LossOutputs:
        """feats: per-level (B, 4*reg_max + nc, H, W) maps, the head's
        train-mode output; gt_labels (B, N, 1), gt_bboxes (B, N, 4) xyxy in
        input pixels (padded rows 0), mask_gt (B, N, 1)."""
        with torch.autocast(feats[0].device.type, enabled=False):
            comps, _ = self.components(feats, gt_labels, gt_bboxes, mask_gt)
            return total_of(comps, feats[0].shape[0])

    def components(self, feats, gt_labels, gt_bboxes, mask_gt):
        """(comps, parts): the gain-scaled [box, cls, dfl] with their
        gradient (this rank's shares of the global batch's within
        ``parallel.global_batch``), and the ``DetectionParts`` the task
        losses build on. Call outside autocast."""
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
        if self.atss is not None:
            cell_anchors, counts = generate_cell_anchors(shapes, self.strides, device=dev)
            assign = self.atss(cell_anchors.to(acc), counts, gt_labels, gt_bboxes, mask_gt,
                               pred_bboxes.detach() * stride_tensor[None])
        else:
            assign = self.assigner(pred_scores.detach().sigmoid(),
                                   pred_bboxes.detach() * stride_tensor[None],
                                   anchor_points * stride_tensor, gt_labels, gt_bboxes, mask_gt)
        target_bboxes, target_scores, fg_mask = (assign.target_bboxes, assign.target_scores,
                                                 assign.fg_mask)
        target_bboxes_g = target_bboxes / stride_tensor[None]
        weight = target_scores.sum(dim=-1) * fg_mask  # (B, A)
        iou = bbox_iou(pred_bboxes, target_bboxes_g, xywh=False, CIoU=True)
        # the batch's sums: target_scores_sum, SlideLoss's foreground count and IoU sum
        sums = torch.stack([target_scores.sum(), fg_mask.to(acc).sum(),
                            (iou.detach() * fg_mask).sum()])
        global_ = in_global_batch()
        if global_:
            sums = all_reduce_sum(sums)
        target_scores_sum = torch.clamp(sums[0], min=1.0)
        loss_box = ((1.0 - iou) * weight).sum() / target_scores_sum
        nwd = wasserstein_similarity(pred_bboxes, target_bboxes_g)
        loss_nwd = ((1.0 - nwd) * weight).sum() / target_scores_sum
        loss_box = self.nwd_ratio * loss_box + (1.0 - self.nwd_ratio) * loss_nwd

        target_ltrb = bbox2dist(anchor_points[None], target_bboxes_g, self.reg_max - 1)
        ldfl = dfl_loss(pred_distri.reshape(b, -1, 4, self.reg_max), target_ltrb, self.reg_max)
        loss_dfl = (ldfl * weight).sum() / target_scores_sum

        bce = bce_with_logits(pred_scores, target_scores)
        if self.use_slide_loss:
            n_fg = sums[1]
            mean_iou = sums[2] / torch.clamp(n_fg, min=1.0)
            auto_iou = torch.where(n_fg > 0, mean_iou, -1.0)
            bce = bce * slide_weight(target_scores, auto_iou)
        loss_cls = bce.sum() / target_scores_sum

        comps = torch.stack([loss_box * self.gains[0], loss_cls * self.gains[1],
                             loss_dfl * self.gains[2]])
        return comps, DetectionParts(assign, anchor_points, stride_tensor, sums[1], acc)


def total_of(comps: torch.Tensor, b: int) -> LossOutputs:
    """The outputs of gain-scaled components ``comps`` (with their gradient)
    of a batch of ``b``: total = sum(comps) * b, or within a data-parallel
    step the global batch's (``global_total``)."""
    return global_total(comps, b) if in_global_batch() else LossOutputs(comps.sum() * b,
                                                                       comps.detach())


class E2EDetectLoss:
    """YOLOv10's dual-assignment loss (JAX train/loss.py:190-205, reference
    utils/loss.py E2EDetectLoss): the one-to-many maps train with TAL
    topk=10, the one-to-one maps (on detached inputs) with topk=1, both
    with SlideLoss and NWD; totals and components are the two losses'
    sums."""

    def __init__(self, nc: int, strides, **kw):
        self.one2many = DetectionLoss(nc, strides, tal_topk=10, **kw)
        self.one2one = DetectionLoss(nc, strides, tal_topk=1, **kw)

    def __call__(self, preds: dict, gt_labels, gt_bboxes, mask_gt) -> LossOutputs:
        """preds: {"one2many": maps, "one2one": maps}, v10Detect's train
        output (its eval output's second value)."""
        m = self.one2many(preds["one2many"], gt_labels, gt_bboxes, mask_gt)
        o = self.one2one(preds["one2one"], gt_labels, gt_bboxes, mask_gt)
        return LossOutputs(m.total + o.total, m.components + o.components)
