"""What serving does around the forward, in plain PyTorch: letterbox, the
non-maximum suppression and the rescale into the original image.

Frozen copies of the port's ``data/augment.py letterbox``,
``engine/predictor.py preprocess``, ``ops/nms.py`` (candidate selection by a
stable descending sort, class-offset boxes, the greedy walk of
``suppress_plain``, the fixed-shape rows) and ``ops/boxes.py scale_boxes``:
the semantics the program's K4 kernel and host path are held to.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def letterbox(img: torch.Tensor, size: int, color: int = 114):
    """(H, W, 3) uint8 into (size, size, 3) keeping its aspect; the pad is
    split round(d -+ 0.1). Returns (image, ratio, (dw, dh))."""
    h0, w0 = img.shape[:2]
    r = min(size / h0, size / w0)
    new_w, new_h = int(round(w0 * r)), int(round(h0 * r))
    dw, dh = (size - new_w) / 2, (size - new_h) / 2
    if (w0, h0) != (new_w, new_h):
        x = F.interpolate(img.permute(2, 0, 1)[None].float(), size=(new_h, new_w),
                          mode="bilinear", align_corners=False, antialias=False)
        img = x[0].round_().clamp_(0, 255).to(torch.uint8).permute(1, 2, 0)
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    out = torch.full((size, size, 3), color, dtype=torch.uint8, device=img.device)
    out[top:top + new_h, left:left + new_w] = img
    return out, r, (dw, dh)


def preprocess(images: list, size: int, device, dtype=torch.float32):
    """BGR uint8 arrays -> (B, 3, size, size) RGB in [0, 1], and each
    image's (ratio, pad)."""
    boxed = [letterbox(torch.from_numpy(np.ascontiguousarray(im)).to(device), size)
             for im in images]
    x = torch.stack([b[0] for b in boxed]).flip(-1).permute(0, 3, 1, 2).to(dtype) / 255.0
    return x.contiguous(memory_format=torch.channels_last), [(b[1], b[2]) for b in boxed]


def xywh2xyxy(x):
    half = x[..., 2:4] * 0.5
    return torch.cat([x[..., :2] - half, x[..., :2] + half], -1)


def suppress(boxes, scores, iou_thres: float, conf_thres: float):
    """Greedy keep mask (B, K) over score-sorted class-offset xyxy boxes."""
    b, k = scores.shape
    area = (boxes[..., 2:4] - boxes[..., :2]).clamp(min=0).prod(-1)
    lt = torch.maximum(boxes[:, :, None, :2], boxes[:, None, :, :2])
    rb = torch.minimum(boxes[:, :, None, 2:4], boxes[:, None, :, 2:4])
    inter = (rb - lt).clamp(min=0).prod(-1)
    iou = inter / (area[:, :, None] + area[:, None, :] - inter + 1e-7)
    over = (iou > iou_thres) & torch.ones(k, k, dtype=torch.bool, device=iou.device).triu(1)
    valid = scores > conf_thres
    alive = torch.ones(b, k, dtype=torch.bool, device=iou.device)
    keep = torch.zeros(b, k, dtype=torch.bool, device=iou.device)
    for i in range(int(valid.sum(1).max())):  # the sorted candidates past the last valid stay out
        cur = alive[:, i] & valid[:, i]
        keep[:, i] = cur
        alive &= ~(over[:, i] & cur[:, None])
    return keep


def nms(y, conf: float, iou: float, max_det: int = 300, max_nms: int = 2048,
        max_wh: float = 7680.0):
    """y (B, N, 4+nc) -> (rows (B, max_det, 6) xyxy, conf, cls; counts (B,)),
    and the count of candidates over ``conf`` an image."""
    pred = y.float()
    b, n = pred.shape[:2]
    score, cls = pred[..., 4:].max(dim=-1)
    score = torch.where(score > conf, score, torch.full_like(score, -1.0))
    k = min(max_nms, n)
    top, idx = torch.sort(score, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    cls = torch.gather(cls, 1, idx).float()
    rows = xywh2xyxy(torch.gather(pred[..., :4], 1, idx[..., None].expand(b, k, 4)))
    keep = suppress(rows + cls[..., None] * max_wh, top, iou, conf)
    full = torch.cat([rows, top[..., None], cls[..., None]], -1)
    rank = torch.cumsum(keep.long(), 1) - 1
    dst = torch.where(keep & (rank < max_det), rank, torch.full_like(rank, max_det))
    out = torch.zeros((b, max_det + 1, 6), device=y.device)
    out.scatter_(1, dst[..., None].expand(b, k, 6), full)
    return out[:, :max_det], keep.sum(1).clamp(max=max_det), (top > conf).sum(1)


def scale_boxes(boxes: torch.Tensor, ratio: float, pad, shape0) -> torch.Tensor:
    """xyxy boxes of the letterboxed image back into the original (h, w),
    clipped."""
    dw, dh = pad
    b = (boxes - torch.tensor([dw, dh, dw, dh], dtype=torch.float32, device=boxes.device)) / ratio
    h, w = shape0
    return torch.stack([b[..., 0].clamp(0, w), b[..., 1].clamp(0, h),
                        b[..., 2].clamp(0, w), b[..., 3].clamp(0, h)], -1)
