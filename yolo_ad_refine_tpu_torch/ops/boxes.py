"""Box format conversions and rescaling, and the rescaling of rotated
boxes on host-side numpy.

Counterpart of ``yolo_ad_refine_tpu/ops/boxes.py`` (reference
ultralytics/utils/ops.py:88 scale_boxes, :337 clip_boxes, :392-599) and of
the JAX validator's ``_scale_rboxes`` (reference models/yolo/obb/val.py).
The conversions and ``clip_boxes`` take torch tensors or numpy arrays, as
the JAX ones take either array kind, and return the kind they were given.
"""

from __future__ import annotations

import numpy as np
import torch


def _cat(parts: list, like):
    return torch.cat(parts, dim=-1) if isinstance(like, torch.Tensor) else np.concatenate(parts, -1)


def _scale(x, values):
    """``values`` as a float vector of ``x``'s kind and of float32 or wider."""
    if isinstance(x, torch.Tensor):
        dtype = torch.promote_types(x.dtype, torch.float32)
        return torch.tensor(values, dtype=dtype, device=x.device)
    return np.asarray(values, np.result_type(x, np.float32))


def xywh2xyxy(x):
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh * 0.5
    return _cat([xy - half, xy + half], x)


def xyxy2xywh(x):
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    p1, p2 = x[..., :2], x[..., 2:4]
    return _cat([(p1 + p2) * 0.5, p2 - p1], x)


def xywhn2xyxy(x, w: float = 640.0, h: float = 640.0, padw: float = 0.0, padh: float = 0.0):
    """Normalized (cx, cy, w, h) -> pixel (x1, y1, x2, y2) with optional pad offset."""
    return xywh2xyxy(x * _scale(x, [w, h, w, h])) + _scale(x, [padw, padh, padw, padh])


def xyxy2xywhn(x, w: float = 640.0, h: float = 640.0, clip: bool = False, eps: float = 0.0):
    """Pixel (x1, y1, x2, y2) -> normalized (cx, cy, w, h)."""
    if clip:
        x = clip_boxes(x, (h - eps, w - eps))
    return xyxy2xywh(x) / _scale(x, [w, h, w, h])


def xywh2ltwh(x):
    """(cx, cy, w, h) -> (x1, y1, w, h)."""
    xy, wh = x[..., :2], x[..., 2:4]
    return _cat([xy - wh * 0.5, wh], x)


def xyxy2ltwh(x):
    """(x1, y1, x2, y2) -> (x1, y1, w, h)."""
    p1, p2 = x[..., :2], x[..., 2:4]
    return _cat([p1, p2 - p1], x)


def ltwh2xywh(x):
    """(x1, y1, w, h) -> (cx, cy, w, h)."""
    xy, wh = x[..., :2], x[..., 2:4]
    return _cat([xy + wh * 0.5, wh], x)


def ltwh2xyxy(x):
    """(x1, y1, w, h) -> (x1, y1, x2, y2)."""
    xy, wh = x[..., :2], x[..., 2:4]
    return _cat([xy, xy + wh], x)


def clip_boxes(boxes, shape):
    """Clip (..., 4) xyxy boxes to image shape (h, w)."""
    h, w = shape[0], shape[1]
    if not isinstance(boxes, torch.Tensor):
        return np.clip(boxes, 0, np.asarray([w, h, w, h], np.result_type(boxes, np.float32)))
    return torch.stack([boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)], dim=-1)


def scale_boxes(img1_shape, boxes: torch.Tensor, img0_shape, ratio_pad=None,
                padding: bool = True) -> torch.Tensor:
    """Rescale xyxy boxes from img1_shape (letterboxed) back to img0_shape.

    The pad follows the reference rounding, round((img1 - img0*gain)/2 - 0.1).
    """
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad_w = round((img1_shape[1] - img0_shape[1] * gain) / 2 - 0.1)
        pad_h = round((img1_shape[0] - img0_shape[0] * gain) / 2 - 0.1)
    else:
        gain = ratio_pad[0][0]
        pad_w, pad_h = ratio_pad[1]
    if padding:
        pad = torch.tensor([pad_w, pad_h, pad_w, pad_h], dtype=torch.float32, device=boxes.device)
        boxes = boxes - pad.to(torch.promote_types(boxes.dtype, torch.float32))
    boxes = boxes / gain
    return clip_boxes(boxes, img0_shape)


def scale_rboxes(rboxes, ratio_pad):
    """(n, 5) xywhr numpy boxes from letterboxed to native pixels, given
    ``ratio_pad`` ((gain, gain), (padw, padh)): centres lose the pad and the
    gain, w and h the gain, the angle stays. Returns a new array."""
    gain = ratio_pad[0][0]
    padw, padh = ratio_pad[1]
    rb = rboxes.copy()
    rb[:, 0] = (rb[:, 0] - padw) / gain
    rb[:, 1] = (rb[:, 1] - padh) / gain
    rb[:, 2:4] /= gain
    return rb
