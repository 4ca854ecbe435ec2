"""Image / label augmentations, and the letterbox.

Counterpart of ``yolo_ad_refine_tpu/data/augment.py`` (reference
ultralytics/data/augment.py: Mosaic:489, MixUp:866, RandomPerspective:951,
RandomHSV:1301, RandomFlip:1381, LetterBox:1475):

- ``letterbox`` resizes and pads in torch on the tensor's own device, for
  the predictor: the resize is bilinear with half-pixel centers (cv2's
  INTER_LINEAR rule); cv2 rounds in 11-bit fixed point, so pixels may
  differ from it by one grey level; the ratio and the pad are the
  reference's.
- the train augments and ``letterbox_np`` (validation) are numpy + cv2
  copies of the JAX package's, host-side. Each takes an explicit
  ``np.random.Generator`` and draws from it in the same order as the JAX
  copy, so the same seeds give bit-equal images.

Boxes are (n, 4) xyxy pixels with (n,) class ids throughout; the segment
task's instances are lists of (P, 2) pixel polygons (``mosaic4_segments``,
``random_perspective_segments``, ``copy_paste_flip``).
"""

from __future__ import annotations

import math

import cv2
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


def letterbox_np(img, new_shape=(640, 640), color=(114, 114, 114), auto: bool = False,
              scale_fill: bool = False, scaleup: bool = True, center: bool = True,
              stride: int = 32):
    """Aspect-preserving resize + pad of a numpy image with cv2, as the
    validation loader does. Returns (img, ratio, (dw, dh)).

    Matches reference LetterBox rounding: pad split round(d-0.1)/round(d+0.1).
    """
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
    if shape[::-1] != new_unpad:
        img = cv2.resize(img, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    img = cv2.copyMakeBorder(img, top, bottom, left, right, cv2.BORDER_CONSTANT, value=color)
    return img, (r, r), (dw, dh)


def apply_letterbox_to_boxes(boxes, ratio, pad):
    out = boxes.copy()
    out[:, [0, 2]] = out[:, [0, 2]] * ratio[0] + pad[0]
    out[:, [1, 3]] = out[:, [1, 3]] * ratio[1] + pad[1]
    return out


def augment_hsv(img, rng: np.random.Generator, hgain: float = 0.015, sgain: float = 0.7,
                vgain: float = 0.4):
    """In-place LUT-based HSV jitter (reference augment.py:1301-1380). BGR in/out."""
    if hgain or sgain or vgain:
        r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
        hue, sat, val = cv2.split(cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
        x = np.arange(0, 256, dtype=r.dtype)
        lut_hue = ((x * r[0]) % 180).astype(img.dtype)
        lut_sat = np.clip(x * r[1], 0, 255).astype(img.dtype)
        lut_val = np.clip(x * r[2], 0, 255).astype(img.dtype)
        im_hsv = cv2.merge((cv2.LUT(hue, lut_hue), cv2.LUT(sat, lut_sat), cv2.LUT(val, lut_val)))
        cv2.cvtColor(im_hsv, cv2.COLOR_HSV2BGR, dst=img)
    return img


def box_candidates(box1, box2, wh_thr: float = 2.0, ar_thr: float = 100.0,
                   area_thr: float = 0.1, eps: float = 1e-16):
    """Filter warped boxes (reference augment.py:1266-1300): min size, aspect
    ratio, area-retention thresholds. box1 = before (4,n), box2 = after (4,n)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def random_perspective(img, boxes, cls, rng: np.random.Generator, degrees: float = 0.0,
                       translate: float = 0.1, scale: float = 0.5, shear: float = 0.0,
                       perspective: float = 0.0, border=(0, 0)):
    """Combined affine/perspective warp of image + boxes (reference augment.py:951).

    border < 0 crops a mosaic canvas back to the target size.
    """
    # center -> perspective -> rotation+scale -> shear -> translation
    M, height, width, s = _warp_matrix(img, rng, degrees, translate, scale, shear, perspective,
                                       border)
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = cv2.warpPerspective(img, M, dsize=(width, height), borderValue=(114, 114, 114))
        else:
            img = cv2.warpAffine(img, M[:2], dsize=(width, height), borderValue=(114, 114, 114))

    n = len(boxes)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)  # corners
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.concatenate((x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = box_candidates(boxes.T * s, new.T, area_thr=0.1)
        boxes, cls = new[keep], cls[keep]
    return img, boxes.astype(np.float32), cls


def mosaic4(items, imgsz: int, rng: np.random.Generator):
    """4-image mosaic on a 2*imgsz canvas (reference augment.py:489-864).

    items: list of 4 (img BGR, boxes xyxy px, cls). Returns canvas + merged
    labels (clipped to the canvas); caller follows with random_perspective
    using border=(-imgsz//2, -imgsz//2).
    """
    s = imgsz
    yc = int(rng.uniform(s // 2, 3 * s // 2))
    xc = int(rng.uniform(s // 2, 3 * s // 2))
    canvas = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
    all_boxes, all_cls = [], []
    for i, (img, boxes, cls) in enumerate(items):
        h, w = img.shape[:2]
        (x1a, y1a, x2a, y2a), (x1b, y1b) = _mosaic_corner(i, xc, yc, w, h, s)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y1b + (y2a - y1a), x1b:x1b + (x2a - x1a)]
        padw, padh = x1a - x1b, y1a - y1b
        if len(boxes):
            b = boxes.copy()
            b[:, [0, 2]] += padw
            b[:, [1, 3]] += padh
            all_boxes.append(b)
            all_cls.append(cls)
    if all_boxes:
        boxes = np.concatenate(all_boxes)
        cls = np.concatenate(all_cls)
        boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, 2 * s)
        boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, 2 * s)
    else:
        boxes = np.zeros((0, 4), np.float32)
        cls = np.zeros((0,), np.float32)
    return canvas, boxes.astype(np.float32), cls


def _mosaic_corner(i: int, xc: int, yc: int, w: int, h: int, s: int):
    """Tile i's canvas box (x1a, y1a, x2a, y2a) and its crop's top-left
    (x1b, y1b) in the image (reference augment.py Mosaic._mosaic4)."""
    if i == 0:  # top-left
        x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
        return (x1a, y1a, x2a, y2a), (w - (x2a - x1a), h - (y2a - y1a))
    if i == 1:  # top-right
        x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
        return (x1a, y1a, x2a, y2a), (0, h - (y2a - y1a))
    if i == 2:  # bottom-left
        x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
        return (x1a, y1a, x2a, y2a), (w - (x2a - x1a), 0)
    x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)  # bottom-right
    return (x1a, y1a, x2a, y2a), (0, 0)


def mosaic4_segments(items, imgsz: int, rng: np.random.Generator):
    """The 4-image mosaic with instance polygons (reference augment.py:489
    with segments): items = [(img BGR, [(P, 2) px polygons], cls)]. The
    polygons take their tile's offset; they are clipped after the warp.
    Returns (canvas, polygons, cls)."""
    s = imgsz
    yc = int(rng.uniform(s // 2, 3 * s // 2))
    xc = int(rng.uniform(s // 2, 3 * s // 2))
    canvas = np.full((s * 2, s * 2, 3), 114, dtype=np.uint8)
    all_polys, all_cls = [], []
    for i, (img, polys, cls) in enumerate(items):
        h, w = img.shape[:2]
        (x1a, y1a, x2a, y2a), (x1b, y1b) = _mosaic_corner(i, xc, yc, w, h, s)
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y1b + (y2a - y1a), x1b:x1b + (x2a - x1a)]
        off = np.asarray([x1a - x1b, y1a - y1b], np.float32)
        for p, c in zip(polys, cls):
            all_polys.append(p + off)
            all_cls.append(c)
    return canvas, all_polys, np.asarray(all_cls, np.float32)


def _warp_matrix(img, rng: np.random.Generator, degrees, translate, scale, shear, perspective,
                 border):
    """``random_perspective``'s matrix, drawn in its order, and the output
    (height, width)."""
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2
    C = np.eye(3)
    C[0, 2] = -img.shape[1] / 2
    C[1, 2] = -img.shape[0] / 2
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height
    return T @ S @ R @ P @ C, height, width, s


def random_perspective_segments(img, segments, cls, rng: np.random.Generator,
                                degrees: float = 0.0, translate: float = 0.1,
                                scale: float = 0.5, shear: float = 0.0,
                                perspective: float = 0.0, border=(0, 0)):
    """``random_perspective`` for polygons (reference augment.py:1026): the
    image warped by the same matrix, each polygon point-wise, clipped to the
    output; instances whose clipped extent is not over 2 px both ways are
    dropped. Returns (img, polygons, cls)."""
    M, height, width, _ = _warp_matrix(img, rng, degrees, translate, scale, shear, perspective,
                                       border)
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            img = cv2.warpPerspective(img, M, dsize=(width, height), borderValue=(114, 114, 114))
        else:
            img = cv2.warpAffine(img, M[:2], dsize=(width, height), borderValue=(114, 114, 114))
    out_polys, out_cls = [], []
    for poly, c in zip(segments, cls):
        xy = np.ones((len(poly), 3), np.float64)
        xy[:, :2] = poly
        xy = xy @ M.T
        xy = xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]
        xy[:, 0] = xy[:, 0].clip(0, width)
        xy[:, 1] = xy[:, 1].clip(0, height)
        if np.ptp(xy[:, 0]) > 2 and np.ptp(xy[:, 1]) > 2:
            out_polys.append(xy.astype(np.float32))
            out_cls.append(c)
    return img, out_polys, np.asarray(out_cls, np.float32)


def bbox_ioa(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Intersection over box2's area, (N, M) (reference utils/metrics.py
    bbox_ioa)."""
    if not len(box1) or not len(box2):
        return np.zeros((len(box1), len(box2)), np.float32)
    ix1 = np.maximum(box1[:, None, 0], box2[None, :, 0])
    iy1 = np.maximum(box1[:, None, 1], box2[None, :, 1])
    ix2 = np.minimum(box1[:, None, 2], box2[None, :, 2])
    iy2 = np.minimum(box1[:, None, 3], box2[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return inter / (area2[None] + eps)


def polygon_boxes(segments: list) -> np.ndarray:
    """(n, 4) xyxy extents of (P, 2) polygons, float32."""
    if not segments:
        return np.zeros((0, 4), np.float32)
    return np.stack([np.asarray([s[:, 0].min(), s[:, 1].min(), s[:, 0].max(), s[:, 1].max()])
                     for s in segments]).astype(np.float32)


def copy_paste_flip(img: np.ndarray, segments: list, cls: np.ndarray, p: float,
                    rng: np.random.Generator):
    """CopyPaste in its default ``flip`` mode (reference augment.py:1631-1727):
    the instances whose left-right mirrored box overlaps every existing box
    by IoA < 0.30 are candidates; the round(p * n) least overlapping are
    pasted, mirrored, with their pixels from the flipped image. Draws
    nothing from ``rng`` (as the JAX copy). Returns (img, segments, cls)."""
    if p <= 0 or not segments:
        return img, segments, cls
    w = img.shape[1]
    boxes = polygon_boxes(segments)
    flipped_segs = [np.stack([w - s[:, 0], s[:, 1]], -1) for s in segments]
    flipped_boxes = boxes.copy()
    flipped_boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    ioa = bbox_ioa(flipped_boxes, boxes)
    candidates = np.nonzero((ioa < 0.30).all(1))[0]
    if not len(candidates):
        return img, segments, cls
    candidates = candidates[np.argsort(ioa.max(1)[candidates])]
    chosen = candidates[: round(p * len(candidates))]
    if not len(chosen):
        return img, segments, cls
    paste = np.zeros(img.shape, np.uint8)
    out_segments, out_cls = list(segments), [cls]
    for j in chosen:
        out_cls.append(cls[[j]])
        out_segments.append(flipped_segs[j])
        cv2.drawContours(paste, [flipped_segs[j].astype(np.int32)], -1, (1, 1, 1), cv2.FILLED)
    flipped = cv2.flip(img, 1)
    img = img.copy()
    m = paste.astype(bool)
    img[m] = flipped[m]
    return img, out_segments, np.concatenate(out_cls, 0)


def mixup(img1, boxes1, cls1, img2, boxes2, cls2, rng: np.random.Generator):
    """beta(32,32) image blend, labels concatenated (reference augment.py:866)."""
    r = rng.beta(32.0, 32.0)
    img = (img1.astype(np.float32) * r + img2.astype(np.float32) * (1 - r)).astype(np.uint8)
    return img, np.concatenate([boxes1, boxes2]), np.concatenate([cls1, cls2])


def extra_augment(img, rng: np.random.Generator, p: float = 0.01):
    """Low-probability photometric extras (reference augment.py:1732-1918
    Albumentations wrapper: blur / median blur / CLAHE / grayscale, p=0.01
    each), implemented directly in cv2 — no optional dependency.

    copy_paste note: the reference's CopyPaste requires instance segments;
    box-only datasets (this fork's) skip it upstream too.
    """
    if rng.random() < p:
        k = int(rng.integers(1, 4)) * 2 + 1
        img = cv2.blur(img, (k, k))
    if rng.random() < p:
        k = int(rng.integers(1, 4)) * 2 + 1
        img = cv2.medianBlur(img, k)
    if rng.random() < p:
        lab = cv2.cvtColor(img, cv2.COLOR_BGR2LAB)
        lab[..., 0] = cv2.createCLAHE(clipLimit=4.0, tileGridSize=(8, 8)).apply(lab[..., 0])
        img = cv2.cvtColor(lab, cv2.COLOR_LAB2BGR)
    if rng.random() < p:
        gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        img = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
    return img


def flip_lr(img, boxes):
    img = np.fliplr(img)
    if len(boxes):
        w = img.shape[1]
        boxes = boxes.copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return np.ascontiguousarray(img), boxes


def flip_ud(img, boxes):
    img = np.flipud(img)
    if len(boxes):
        h = img.shape[0]
        boxes = boxes.copy()
        boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
    return np.ascontiguousarray(img), boxes
