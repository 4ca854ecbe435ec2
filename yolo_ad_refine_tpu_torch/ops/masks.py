"""Instance masks from mask coefficients and prototypes.

Counterpart of ``yolo_ad_refine_tpu/ops/masks.py`` (reference
utils/ops.py process_mask, crop_mask): sigmoid(coeffs @ proto), cropped to
each box in prototype coordinates, upsampled bilinearly to the input size.
Plain torch ops on the tensors' device, as the JAX package computes them in
plain ``jnp`` outside any Pallas kernel. Prototypes are in the port's
layout, (nm, mh, mw); any leading batch dimensions ride along.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero the pixels of each mask outside its box: masks (..., K, h, w),
    boxes (..., K, 4) xyxy in mask pixels; a pixel (row, col) is inside
    when y1 <= row < y2 and x1 <= col < x2."""
    h, w = masks.shape[-2:]
    rows = torch.arange(h, dtype=torch.float32, device=masks.device)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=masks.device)[None, :]
    x1, y1, x2, y2 = (boxes[..., i, None, None] for i in range(4))
    inside = (rows >= y1) & (rows < y2) & (cols >= x1) & (cols < x2)
    return masks * inside.to(masks.dtype)


def process_mask(proto: torch.Tensor, coeffs: torch.Tensor, boxes_xyxy: torch.Tensor,
                 img_hw: tuple[int, int], upsample: bool = True) -> torch.Tensor:
    """Masks of K detections: proto (..., nm, mh, mw), coeffs (..., K, nm),
    boxes_xyxy (..., K, 4) in input pixels, img_hw the input size. Returns
    (..., K, H, W) fp32 in [0, 1], or (..., K, mh, mw) without ``upsample``.
    The upsample is bilinear with half-pixel centres
    (``jax.image.resize``'s, which only upsamples here, so its antialias
    does not act)."""
    mh, mw = proto.shape[-2:]
    ih, iw = img_hw
    masks = torch.sigmoid(torch.einsum("...kn,...nhw->...khw", coeffs.float(), proto.float()))
    scale = torch.tensor([mw / iw, mh / ih, mw / iw, mh / ih], dtype=torch.float32,
                         device=masks.device)
    masks = crop_mask(masks, boxes_xyxy.float() * scale)
    if upsample:
        lead = masks.shape[:-2]
        masks = F.interpolate(masks.reshape(1, -1, mh, mw), size=(ih, iw), mode="bilinear",
                              align_corners=False).reshape(*lead, ih, iw)
    return masks


def mask_iou_matrix(proto: torch.Tensor, coeffs: torch.Tensor, boxes_xyxy: torch.Tensor,
                    img_hw: tuple[int, int], gt_index_mask: torch.Tensor,
                    max_gt: int) -> torch.Tensor:
    """Mask IoU of one image's predictions against its GT instances at
    prototype resolution: proto (nm, mh, mw), coeffs (K, nm), boxes (K, 4)
    input pixels, gt_index_mask (mh, mw) integer, overlap-encoded (0 the
    background, i + 1 GT row i). Returns (max_gt, K)."""
    pred = process_mask(proto, coeffs, boxes_xyxy, img_hw, upsample=False) > 0.5
    pred_f = pred.reshape(pred.shape[0], -1).float()  # (K, P)
    ids = torch.arange(1, max_gt + 1, device=gt_index_mask.device)
    gt = (gt_index_mask.reshape(1, -1) == ids[:, None]).float()  # (G, P)
    inter = gt @ pred_f.T
    union = gt.sum(-1, keepdim=True) + pred_f.sum(-1)[None] - inter
    return inter / (union + 1e-7)


def scale_masks(masks: torch.Tensor, pad: tuple[float, float], ratio: float,
                shape0: tuple[int, int]) -> torch.Tensor:
    """(K, H, W) masks over a letterboxed input -> (K, h0, w0) bool over the
    original image: the pad cropped (its sides rounded), the rest resized
    bilinearly with half-pixel centres (cv2's INTER_LINEAR rule, in fp32 on
    the masks' device), then thresholded at 0.5, as the JAX predictor does
    with cv2 on the host."""
    h0, w0 = shape0
    top, left = int(round(pad[1])), int(round(pad[0]))
    bh, bw = int(round(h0 * ratio)), int(round(w0 * ratio))
    m = masks[:, top:top + bh, left:left + bw]
    if m.shape[1:] != (h0, w0):
        m = F.interpolate(m[None], size=(h0, w0), mode="bilinear", align_corners=False)[0]
    return m > 0.5
