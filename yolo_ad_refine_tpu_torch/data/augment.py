"""Letterbox: aspect-preserving resize + gray pad, in torch.

Counterpart of ``letterbox`` in ``yolo_ad_refine_tpu/data/augment.py``
(reference ultralytics/data/augment.py:1475 LetterBox), without cv2: the
resize is bilinear with half-pixel centers (cv2's INTER_LINEAR rule) on the
tensor's own device. cv2 rounds in 11-bit fixed point, so pixels may differ
from it by one grey level; the ratio and the pad are the reference's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def letterbox(img, new_shape=(640, 640), color: int = 114, auto: bool = False,
              scaleup: bool = True, center: bool = True, stride: int = 32):
    """Resize an (H, W, C) uint8 image (numpy or tensor) into ``new_shape``
    keeping its aspect, then pad with ``color``. Returns (img (h, w, C) uint8
    tensor, (r, r), (dw, dh)); the pad is split round(d -+ 0.1)."""
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(np.ascontiguousarray(img))
    shape = img.shape[:2]  # h, w
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))  # w, h
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    if center:
        dw /= 2
        dh /= 2
    if tuple(shape[::-1]) != new_unpad:
        x = img.permute(2, 0, 1)[None].float()
        x = F.interpolate(x, size=(new_unpad[1], new_unpad[0]), mode="bilinear",
                          align_corners=False, antialias=False)
        img = x[0].round_().clamp_(0, 255).to(torch.uint8).permute(1, 2, 0)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    out = torch.full((new_unpad[1] + top + bottom, new_unpad[0] + left + right, img.shape[2]),
                     color, dtype=torch.uint8, device=img.device)
    out[top:top + new_unpad[1], left:left + new_unpad[0]] = img
    return out, (r, r), (dw, dh)
