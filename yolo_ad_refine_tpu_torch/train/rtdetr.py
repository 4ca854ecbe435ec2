"""RT-DETR training: the DETR loss with Hungarian matching, and contrastive
denoising.

Counterpart of ``yolo_ad_refine_tpu/train/rtdetr.py`` (reference
models/utils/loss.py:13-358 DETRLoss / RTDETRDetectionLoss,
models/utils/ops.py:12-259 HungarianMatcher / get_cdn_group). As in the
JAX package every shape is fixed: GT slots are (B, max_boxes) masked rows,
and the denoising layout is static (group_size = max_boxes, num_group =
max(1, num_dn // max_boxes)).

- The denoising group is split into its random draw (``draw_cdn_noise``,
  from a torch.Generator; the JAX draw comes from a JAX PRNG, which the
  port cannot reproduce) and its construction (``build_cdn_group``, equal
  to the JAX construction given the same noise arrays);
  ``make_cdn_group`` is the two together.
- The matcher's cost matrices of every level (the encoder's selection as
  level 0, then each decoder layer) go to ``ops/lap.py
  linear_sum_assignment`` in one call: one kernel launch a step on the
  card, one thread block a matrix, where the JAX loss solves level by
  level. Each level's assignment is the same.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from yolo_ad_refine_tpu_torch.ops.boxes import xywh2xyxy, xyxy2xywh
from yolo_ad_refine_tpu_torch.ops.iou import bbox_iou
from yolo_ad_refine_tpu_torch.ops.lap import linear_sum_assignment
from yolo_ad_refine_tpu_torch.train.loss import LossOutputs, bce_with_logits


class DNConfig(NamedTuple):
    """The static contrastive-denoising layout (reference get_cdn_group)."""

    group_size: int  # GT slots a half-group (= max_boxes)
    num_group: int   # (positive, negative) group pairs
    cls_noise_ratio: float = 0.5
    box_noise_scale: float = 1.0

    @property
    def ndn(self) -> int:
        return 2 * self.group_size * self.num_group


def make_dn_config(max_boxes: int, num_dn: int = 100) -> DNConfig:
    return DNConfig(group_size=max_boxes, num_group=max(1, num_dn // max_boxes))


def build_dn_attn_blocked(cfg: DNConfig, nq: int) -> np.ndarray:
    """The static (T, T) bool mask, T = ndn + nq, True where attention is
    blocked (reference ops.py:235-247): the denoising groups are blind to
    each other, the matching queries do not see the denoising ones, and the
    denoising queries see the matching ones."""
    ndn = cfg.ndn
    t = ndn + nq
    blocked = np.zeros((t, t), bool)
    blocked[ndn:, :ndn] = True
    s2 = 2 * cfg.group_size
    for g in range(cfg.num_group):
        r = slice(g * s2, (g + 1) * s2)
        blocked[r, : g * s2] = True
        blocked[r, (g + 1) * s2: ndn] = True
    return blocked


def draw_cdn_noise(b: int, nc: int, cfg: DNConfig, generator: torch.Generator,
                   device=None) -> dict:
    """The denoising group's random draw for a batch of ``b``, laid out
    (B, num_group, 2, group_size[, 4]) with axis 2 (positive, negative):
    ``flip`` (the label is replaced, probability cls_noise_ratio / 2),
    ``new_label`` (uniform in [0, nc)), ``sign`` (+-1 a box side) and
    ``part`` (uniform in [0, 1) a box side)."""
    shape = (b, cfg.num_group, 2, cfg.group_size)
    device = device if device is not None else generator.device
    kw = dict(generator=generator, device=device)
    return {"flip": torch.rand(shape, **kw) < (cfg.cls_noise_ratio * 0.5),
            "new_label": torch.randint(0, nc, shape, **kw),
            "sign": torch.randint(0, 2, (*shape, 4), **kw).float() * 2.0 - 1.0,
            "part": torch.rand((*shape, 4), **kw)}


def build_cdn_group(cls, bboxes_xyxy_px, mask, noise: dict, *, imgsz: float, cfg: DNConfig,
                    attn_blocked: torch.Tensor) -> dict:
    """The fixed-shape denoising queries (reference ops.py:150) from the GT
    cls (B, M, 1), bboxes (B, M, 4) xyxy in pixels and mask (B, M, 1), and a
    draw of ``draw_cdn_noise``'s layout: the class ids, the noised box
    logits and the validity of each of the ndn queries, and the attention
    mask, as RTDETRDecoder takes them."""
    b, m = cls.shape[:2]
    s, g = cfg.group_size, cfg.num_group
    assert m == s, f"dn group_size ({s}) must equal max_boxes ({m})"
    maskf = mask.reshape(b, m).float()
    gt_cls = cls.reshape(b, m).long()
    gt_xywh = xyxy2xywh(bboxes_xyxy_px[..., :4].float()) / imgsz
    dn_cls = gt_cls[:, None, None].expand(b, g, 2, m)
    dn_box = gt_xywh[:, None, None].expand(b, g, 2, m, 4)
    dn_valid = maskf[:, None, None].expand(b, g, 2, m)
    if cfg.cls_noise_ratio > 0:
        dn_cls = torch.where(noise["flip"], noise["new_label"].to(dn_cls.device), dn_cls)
    if cfg.box_noise_scale > 0:
        known = xywh2xyxy(dn_box)
        diff = (dn_box[..., 2:4] * 0.5).repeat(1, 1, 1, 1, 2) * cfg.box_noise_scale
        is_neg = torch.zeros((1, 1, 2, 1, 1), device=known.device)
        is_neg[:, :, 1] = 1.0
        part = (noise["part"] + is_neg) * noise["sign"]
        known = (known + part * diff).clamp(0.0, 1.0)
        dn_box = xyxy2xywh(known)
    dn_box = dn_box.clamp(1e-6, 1 - 1e-6)
    logit = torch.log(dn_box / (1.0 - dn_box))
    ndn = cfg.ndn
    return {"cls": dn_cls.reshape(b, ndn), "bbox_logit": (logit * dn_valid[..., None]).reshape(
        b, ndn, 4), "valid": dn_valid.reshape(b, ndn), "attn_blocked": attn_blocked}


def make_cdn_group(cls, bboxes_xyxy_px, mask, generator: torch.Generator, *, nc: int,
                   imgsz: float, cfg: DNConfig, attn_blocked: torch.Tensor) -> dict:
    """The denoising group of a batch: a fresh ``draw_cdn_noise`` on the
    targets' device built by ``build_cdn_group``."""
    noise = draw_cdn_noise(cls.shape[0], nc, cfg, generator, cls.device)
    return build_cdn_group(cls, bboxes_xyxy_px, mask, noise, imgsz=imgsz, cfg=cfg,
                           attn_blocked=attn_blocked)


def _focal_loss(logits, one_hot, gamma: float = 1.5, alpha: float = 0.25):
    """Reference FocalLoss: per element, then .mean(1).sum()."""
    loss = bce_with_logits(logits, one_hot)
    p = torch.sigmoid(logits)
    p_t = one_hot * p + (1.0 - one_hot) * (1.0 - p)
    loss = loss * (1.0 - p_t) ** gamma
    loss = loss * (one_hot * alpha + (1.0 - one_hot) * (1.0 - alpha))
    return loss.mean(dim=1).sum()


def _varifocal_loss(logits, gt_scores, one_hot, alpha: float = 0.75, gamma: float = 2.0):
    """Reference VarifocalLoss (.mean(1).sum()), in the logits' fp32 (fp64)."""
    p = torch.sigmoid(logits)
    weight = alpha * p ** gamma * (1.0 - one_hot) + gt_scores * one_hot
    return (bce_with_logits(logits, gt_scores) * weight).mean(dim=1).sum()


class RTDETRLoss:
    """The fixed-shape DETR loss over the encoder's selection and every
    decoder layer, plus the denoising branch with its fixed matches.

    ``__call__(preds, cls, bboxes, mask)``: preds = (dec_bboxes (L, B, T,
    4), dec_scores (L, B, T, nc), enc_bboxes (B, nq, 4), enc_scores (B, nq,
    nc)), T = nq, or ndn + nq with the denoising group; cls (B, M, 1),
    bboxes (B, M, 4) xyxy in pixels, mask (B, M, 1). The components are
    [giou, class, bbox] of the last layer, as the JAX loss shows them; it
    runs in fp32 outside any autocast (in fp64 for fp64 predictions, the
    tests' reference; the matcher's costs are fp32 either way, as the
    JAX solver's)."""

    def __init__(self, nc: int, nq: int = 300, imgsz: float = 640.0, max_boxes: int = 128,
                 num_dn: int = 100, use_vfl: bool = True, gain_class: float = 1.0,
                 gain_bbox: float = 5.0, gain_giou: float = 2.0, cost_class: float = 2.0,
                 cost_bbox: float = 5.0, cost_giou: float = 2.0,
                 # the trainer's gains, unused: RT-DETR takes the DETR gains
                 box_gain: float | None = None, cls_gain: float | None = None,
                 dfl_gain: float | None = None):
        self.nc, self.nq, self.imgsz = nc, nq, float(imgsz)
        self.use_vfl = use_vfl
        self.gain = (gain_class, gain_bbox, gain_giou)
        self.cost = (cost_class, cost_bbox, cost_giou)
        self.dn_cfg = make_dn_config(max_boxes, num_dn)

    def cost_matrix(self, pred_bboxes, pred_scores, gt_cls, gt_bboxes):
        """The HungarianMatcher's cost (reference models/utils/ops.py:46-117)
        of one level, (B, M, nq), on detached predictions: the focal class
        cost at the GT class (alpha 0.25, gamma 2), L1 and 1 - GIoU."""
        pb = pred_bboxes.detach().float()
        ps = torch.sigmoid(pred_scores.detach().float())
        b, nq = ps.shape[:2]
        psc = torch.gather(ps, 2, gt_cls.long()[:, None, :].expand(b, nq, -1))  # (B, nq, M)
        neg = (1 - 0.25) * psc ** 2.0 * (-torch.log(1 - psc + 1e-8))
        pos = 0.25 * (1 - psc) ** 2.0 * (-torch.log(psc + 1e-8))
        cost_class = pos - neg
        l1 = (pb[:, :, None, :] - gt_bboxes[:, None, :, :]).abs().sum(-1)
        giou = bbox_iou(pb[:, :, None, :], gt_bboxes[:, None, :, :], xywh=True, GIoU=True)
        c = self.cost[0] * cost_class + self.cost[1] * l1 + self.cost[2] * (1.0 - giou)
        return torch.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0).transpose(1, 2)

    def match(self, levels, gt_cls, gt_bboxes, gt_mask) -> list[torch.Tensor]:
        """Each level's match_q (B, M), the query of each GT slot, from one
        ``linear_sum_assignment`` over every level's cost matrices."""
        gt_bboxes = gt_bboxes.float()
        costs = torch.cat([self.cost_matrix(pb, ps, gt_cls, gt_bboxes) for pb, ps in levels])
        col4row = linear_sum_assignment(costs, gt_mask.repeat(len(levels), 1))
        return list(col4row.long().chunk(len(levels)))

    def level_loss(self, pred_bboxes, pred_scores, gt_cls, gt_bboxes, gt_mask, match_q):
        """Class, L1 and GIoU losses of one level at fixed shapes (reference
        DETRLoss._get_loss, loss.py:217-251), each with its gain."""
        b, nq = pred_scores.shape[:2]
        maskf = gt_mask.to(pred_scores.dtype)
        num_gts = maskf.sum()
        denom = num_gts.clamp(min=1.0)
        idx = torch.where(gt_mask > 0, match_q, nq)  # padded slots -> an overflow column
        targets = torch.full((b, nq + 1), self.nc, dtype=torch.long, device=pred_scores.device)
        targets = targets.scatter(1, idx, gt_cls.long())[:, :nq]
        acc = pred_scores.dtype
        one_hot = F.one_hot(targets, self.nc + 1)[..., :-1].to(acc)

        pb = torch.gather(pred_bboxes, 1, match_q[..., None].expand(-1, -1, 4))  # (B, M, 4)
        iou_m = bbox_iou(pb.detach(), gt_bboxes, xywh=True)
        gt_sc = torch.zeros((b, nq + 1), dtype=acc, device=pred_scores.device)
        gt_sc = gt_sc.scatter(1, idx, (iou_m * maskf).to(acc))[:, :nq]

        logits = pred_scores
        fl = _focal_loss(logits, one_hot)
        if self.use_vfl:  # reference: varifocal when there is a GT, else focal
            vfl = _varifocal_loss(logits, gt_sc[..., None] * one_hot, one_hot)
            loss_cls = torch.where(num_gts > 0, vfl, fl)
        else:
            loss_cls = fl
        loss_cls = loss_cls / denom * nq
        loss_bbox = ((pb - gt_bboxes).abs() * maskf[..., None]).sum() / denom
        giou = bbox_iou(pb, gt_bboxes, xywh=True, GIoU=True)
        loss_giou = ((1.0 - giou) * maskf).sum() / denom
        g = self.gain
        return g[0] * loss_cls, g[1] * loss_bbox, g[2] * loss_giou

    def __call__(self, preds, cls, bboxes, mask) -> LossOutputs:
        acc = torch.float64 if preds[0].dtype == torch.float64 else torch.float32
        with torch.autocast(preds[0].device.type, enabled=False):
            return self._loss(*(p.to(acc) for p in preds[:4]), cls, bboxes, mask)

    def _loss(self, dec_bboxes, dec_scores, enc_bboxes, enc_scores, cls, bboxes, mask):
        b, m = cls.shape[:2]
        gt_cls = cls.reshape(b, m)
        gt_mask = mask.reshape(b, m)
        gt_b = xyxy2xywh(bboxes[..., :4].to(dec_bboxes.dtype)) / self.imgsz

        t = dec_bboxes.shape[2]
        dn_active = t > self.nq
        if dn_active:
            ndn = self.dn_cfg.ndn
            assert t == ndn + self.nq, f"unexpected query count {t}"
            dn_bboxes, dec_bboxes = dec_bboxes[:, :, :ndn], dec_bboxes[:, :, ndn:]
            dn_scores, dec_scores = dec_scores[:, :, :ndn], dec_scores[:, :, ndn:]

        # the encoder's selection is level 0 (reference tasks.py: cat([enc, dec]))
        levels = [(enc_bboxes, enc_scores)] + list(zip(dec_bboxes, dec_scores))
        total_cls = total_bbox = total_giou = 0.0
        main = None
        for (lb, ls), match_q in zip(levels, self.match(levels, gt_cls, gt_b, gt_mask)):
            out = self.level_loss(lb, ls, gt_cls, gt_b, gt_mask, match_q)
            total_cls, total_bbox, total_giou = (total_cls + out[0], total_bbox + out[1],
                                                 total_giou + out[2])
            main = out  # the last layer's is the main loss

        if dn_active:
            # the fixed denoising match: positive slot (g, j) <-> GT j
            # (reference RTDETRDetectionLoss.get_dn_match_indices, loss.py:334-358)
            s, g = self.dn_cfg.group_size, self.dn_cfg.num_group
            gt_cls_t, gt_b_t, gt_mask_t = gt_cls.repeat(1, g), gt_b.repeat(1, g, 1), \
                gt_mask.repeat(1, g)
            slot = (torch.arange(g)[:, None] * 2 * s + torch.arange(s)[None, :]).reshape(-1)
            match_dn = slot[None].expand(b, -1).to(gt_cls.device)
            for i in range(dn_bboxes.shape[0]):
                out = self.level_loss(dn_bboxes[i], dn_scores[i], gt_cls_t, gt_b_t, gt_mask_t,
                                      match_dn)
                total_cls, total_bbox, total_giou = (total_cls + out[0], total_bbox + out[1],
                                                     total_giou + out[2])

        total = total_cls + total_bbox + total_giou
        return LossOutputs(total, torch.stack([main[2], main[0], main[1]]).detach())
