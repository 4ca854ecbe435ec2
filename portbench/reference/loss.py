"""The flagship's training loss in plain PyTorch: a frozen copy of the port's
``train/loss.py`` DetectionLoss (TAL assignment with topk 10, alpha 0.5,
beta 6; SlideLoss-weighted BCE; CIoU mixed 50/50 with NWD; DFL; gains
7.5 / 0.5 / 1.5) with ``train/tal.py`` and ``ops/iou.py``, for one process
(no data-parallel normalisers).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.modules import bbox2dist, dist2bbox, make_anchors


def bbox_iou_ciou(box1, box2, eps: float = 1e-7):
    """Elementwise CIoU of broadcastable xyxy boxes; the aspect factor
    ``alpha`` carries no gradient."""
    p1, p2 = box1[..., :2], box1[..., 2:4]
    g1, g2 = box2[..., :2], box2[..., 2:4]
    wh1, wh2 = p2 - p1, g2 - g1
    w1, h1 = wh1[..., 0], wh1[..., 1] + eps
    w2, h2 = wh2[..., 0], wh2[..., 1] + eps
    inter_wh = (torch.minimum(p2, g2) - torch.maximum(p1, g1)).clamp(min=0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cwh = torch.maximum(p2, g2) - torch.minimum(p1, g1)
    c2 = cwh[..., 0] ** 2 + cwh[..., 1] ** 2 + eps
    rho2 = (((g1[..., 0] + g2[..., 0]) - (p1[..., 0] + p2[..., 0])) ** 2
            + ((g1[..., 1] + g2[..., 1]) - (p1[..., 1] + p2[..., 1])) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)


def wasserstein_similarity(pred, target, eps: float = 1e-7, constant: float = 12.8):
    w1 = pred[..., 2] - pred[..., 0]
    h1 = pred[..., 3] - pred[..., 1] + eps
    w2 = target[..., 2] - target[..., 0]
    h2 = target[..., 3] - target[..., 1] + eps
    center_d = ((pred[..., 0] + w1 / 2) - (target[..., 0] + w2 / 2)) ** 2 + \
        ((pred[..., 1] + h1 / 2) - (target[..., 1] + h2 / 2)) ** 2 + eps
    wh_d = ((w1 - w2) ** 2 + (h1 - h2) ** 2) / 4
    return torch.exp(-torch.sqrt(center_d + wh_d) / constant)


@torch.no_grad()
def assign(pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt, nc: int,
           topk: int = 10, alpha: float = 0.5, beta: float = 6.0, eps: float = 1e-9):
    """Task-aligned assignment; all boxes xyxy in image pixels. Returns
    (target_bboxes, target_scores, fg_mask)."""
    b, a = pd_scores.shape[:2]
    n = gt_bboxes.shape[1]
    mask_gt_b = mask_gt[..., 0] > 0
    lt, rb = gt_bboxes[..., None, :2], gt_bboxes[..., None, 2:4]
    inside = torch.cat([anc_points[None, None] - lt, rb - anc_points[None, None]], -1)
    valid = (inside.amin(-1) > eps) & mask_gt_b[..., None]
    labels = gt_labels[..., 0].long().clamp(0, nc - 1)
    bbox_scores = torch.gather(pd_scores.transpose(1, 2), 1, labels[:, :, None].expand(b, n, a))
    bbox_scores = torch.where(valid, bbox_scores, 0.0)
    overlaps = bbox_iou_ciou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :])
    overlaps = torch.where(valid, overlaps.clamp(min=0), 0.0)
    align = bbox_scores.pow(alpha) * overlaps.pow(beta)
    sel = torch.zeros(align.shape, dtype=torch.bool, device=align.device)
    m = align.clone()
    for _ in range(min(topk, a)):  # argmax rounds: the first index wins a tie
        hit = F.one_hot(m.argmax(-1), a).bool()
        sel |= hit
        m.masked_fill_(hit, float("-inf"))
    mask_pos = (sel & mask_gt_b[..., None]).to(align.dtype) * valid.to(align.dtype)
    fg_counts = mask_pos.sum(-2)
    is_max = F.one_hot(overlaps.argmax(1), n).to(mask_pos.dtype).transpose(1, 2)
    mask_pos = torch.where(fg_counts[:, None, :] > 1, is_max, mask_pos)
    fg_mask = mask_pos.sum(-2) > 0
    gt_idx = mask_pos.argmax(-2)
    target_labels = torch.gather(labels, 1, gt_idx)
    target_bboxes = torch.gather(gt_bboxes, 1, gt_idx[..., None].expand(b, a, 4))
    target_scores = torch.where(fg_mask[..., None], F.one_hot(target_labels, nc).to(pd_scores.dtype),
                                0.0)
    align = align * mask_pos
    pos_align = align.amax(-1, keepdim=True)
    pos_overlaps = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align * pos_overlaps / (pos_align + eps)).amax(-2)
    return target_bboxes, target_scores * norm[..., None], fg_mask


def detection_loss(maps, gt_labels, gt_bboxes, mask_gt, nc: int, strides=(8, 16, 32),
                   reg_max: int = 16, gains=(7.5, 0.5, 1.5)):
    """The gain-scaled [box, cls, dfl] of the head's train-mode maps, and
    the total sum(components) * batch, in fp32."""
    b, dev = maps[0].shape[0], maps[0].device
    no = nc + reg_max * 4
    x = torch.cat([f.permute(0, 2, 3, 1).reshape(b, -1, no).float() for f in maps], 1)
    pred_distri, pred_scores = x[..., :reg_max * 4], x[..., reg_max * 4:]
    anchors, stride_t = make_anchors([(f.shape[2], f.shape[3]) for f in maps], strides, 0.5,
                                     device=dev)
    dist = torch.softmax(pred_distri.reshape(b, -1, 4, reg_max), -1)
    dist = torch.einsum("banr,r->ban", dist, torch.arange(reg_max, dtype=torch.float32, device=dev))
    pred_bboxes = dist2bbox(dist, anchors[None], xywh=False)
    gt_bboxes, mask_gt = gt_bboxes.float(), mask_gt.float()
    target_bboxes, target_scores, fg_mask = assign(
        pred_scores.detach().sigmoid(), pred_bboxes.detach() * stride_t[None], anchors * stride_t,
        gt_labels, gt_bboxes, mask_gt, nc)
    tb = target_bboxes / stride_t[None]
    weight = target_scores.sum(-1) * fg_mask
    iou = bbox_iou_ciou(pred_bboxes, tb)
    tss = torch.clamp(target_scores.sum(), min=1.0)
    n_fg = fg_mask.float().sum()
    loss_box = ((1.0 - iou) * weight).sum() / tss
    loss_nwd = ((1.0 - wasserstein_similarity(pred_bboxes, tb)) * weight).sum() / tss
    loss_box = 0.5 * loss_box + 0.5 * loss_nwd
    target = bbox2dist(anchors[None], tb, reg_max - 1)
    logp = torch.log_softmax(pred_distri.reshape(b, -1, 4, reg_max), -1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=dev)
    hat = (1.0 - (target[..., None] - bins).abs()).clamp(min=0.0)
    loss_dfl = ((-(logp * hat).sum(-1)).mean(-1) * weight).sum() / tss
    bce = pred_scores.clamp(min=0) - pred_scores * target_scores + \
        torch.log1p(torch.exp(-pred_scores.abs()))
    auto_iou = torch.where(n_fg > 0, (iou.detach() * fg_mask).sum() / torch.clamp(n_fg, min=1.0),
                           -1.0).clamp(min=0.2)
    t = target_scores
    slide = (1.0 * (t <= auto_iou - 0.1) + torch.exp(1.0 - auto_iou) * ((t > auto_iou - 0.1) & (t < auto_iou))
             + torch.exp(-(t - 1.0)) * (t >= auto_iou))
    loss_cls = (bce * slide).sum() / tss
    comps = torch.stack([loss_box * gains[0], loss_cls * gains[1], loss_dfl * gains[2]])
    return comps, comps.sum() * b
