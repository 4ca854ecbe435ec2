"""Fixed-shape non-maximum suppression on torch tensors.

Counterpart of ``yolo_ad_refine_tpu/ops/nms.py`` (reference
ultralytics/utils/ops.py:163): confidence filter -> top ``max_nms``
candidates -> class-offset boxes -> greedy IoU suppression -> a fixed
(max_det, 6) output per image plus counts.

The suppression is the TPU kernel ``ops/nms_pallas.py::_suppress_kernel``:
``suppress`` launches its Hopper port (``csrc/nms.cu``) on CUDA tensors and
runs ``suppress_plain``, a port of ``_suppress``, on CPU tensors. Candidate
selection uses a stable descending sort, which keeps ``jax.lax.top_k``'s
tie order (lower index first); ``torch.topk`` leaves ties unspecified.
"""

from __future__ import annotations

import ctypes

import torch

from yolo_ad_refine_tpu_torch.ops.boxes import xywh2xyxy
from yolo_ad_refine_tpu_torch.utils import kernels


def suppress_plain(boxes, scores, iou_thres: float, conf_thres: float):
    """Greedy NMS keep mask in plain PyTorch. boxes (B, K, 4) xyxy, already
    class-offset; scores (B, K) descending. Returns keep (B, K) bool, the
    mask of the JAX ``_suppress`` for each image."""
    b, k = scores.shape
    area = (boxes[..., 2:4] - boxes[..., :2]).clamp(min=0).prod(-1)  # (B, K)
    lt = torch.maximum(boxes[:, :, None, :2], boxes[:, None, :, :2])
    rb = torch.minimum(boxes[:, :, None, 2:4], boxes[:, None, :, 2:4])
    inter = (rb - lt).clamp(min=0).prod(-1)  # (B, K, K): row i, column j
    iou = inter / (area[:, :, None] + area[:, None, :] - inter + 1e-7)
    over = iou > iou_thres
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    over &= later
    alive = torch.ones(b, k, dtype=torch.bool, device=boxes.device)
    keep = torch.zeros(b, k, dtype=torch.bool, device=boxes.device)
    valid = scores > conf_thres
    for i in range(k):
        cur = alive[:, i] & valid[:, i]
        keep[:, i] = cur
        alive &= ~(over[:, i] & cur[:, None])
    return keep


def suppress(boxes, scores, iou_thres: float, conf_thres: float):
    """Greedy NMS keep mask (B, K) bool. A CPU tensor runs
    ``suppress_plain``; a CUDA tensor launches ``csrc/nms.cu``."""
    if boxes.device.type == "cpu":
        return suppress_plain(boxes, scores, iou_thres, conf_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"suppress: unsupported device {boxes.device}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or tuple(scores.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"boxes (B, K, 4) and scores (B, K) expected, got "
                         f"{tuple(boxes.shape)}, {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"boxes and scores must be float32, got {boxes.dtype}, {scores.dtype}")
    if scores.device != boxes.device:
        raise ValueError("boxes and scores must be on one device")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("boxes and scores must be contiguous")
    b, k = scores.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    nwords = -(-k // 64)
    mask_ws = torch.empty((b, k, nwords), dtype=torch.int64, device=boxes.device)
    lib = kernels.load("nms")
    fn = lib.nms_suppress
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p]
    status = fn(boxes.data_ptr(), scores.data_ptr(), mask_ws.data_ptr(), keep.data_ptr(), b, k,
                float(iou_thres), float(conf_thres),
                torch.cuda.current_stream(boxes.device).cuda_stream)
    kernels.check(lib, status, "nms_suppress")
    suppress.launches += 1
    return keep


suppress.launches = 0


def non_max_suppression(prediction, conf_thres: float = 0.25, iou_thres: float = 0.45,
                        max_det: int = 300, max_nms: int = 2048, max_wh: float = 7680.0,
                        multi_label: bool = False, agnostic: bool = False, nc: int = 80,
                        rotated: bool = False):
    """Batched fixed-shape NMS.

    prediction: (B, N, 4+nc[+E]) xywh boxes + sigmoided class scores; columns
    beyond 4+nc are carried through. Returns detections (B, max_det, 6) rows
    of (x1, y1, x2, y2, conf, cls) with zero rows past each image's count,
    counts (B,) int32 and extras (B, max_det, E).
    """
    if rotated:
        raise NotImplementedError(
            "rotated NMS (OBB) needs the probiou suppression kernel K5 "
            "(ops/nms_pallas.py::_suppress_rotated_kernel), not ported yet: ROADMAP Queue 2")
    pred = prediction[..., : 4 + nc].float()
    extra = prediction[..., 4 + nc:]
    b, n = pred.shape[:2]
    boxes_xywh = pred[..., :4]
    scores_all = pred[..., 4: 4 + nc]

    if multi_label and nc > 1:
        flat = scores_all.reshape(b, -1)
        flat = torch.where(flat > conf_thres, flat, torch.full_like(flat, -1.0))
        k = min(max_nms, flat.shape[1])
        top_scores, top_idx = torch.sort(flat, dim=1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        anchor_idx = top_idx // nc
        cls_idx = (top_idx % nc).float()
    else:
        conf, cls = scores_all.max(dim=-1)
        conf = torch.where(conf > conf_thres, conf, torch.full_like(conf, -1.0))
        k = min(max_nms, n)
        top_scores, anchor_idx = torch.sort(conf, dim=1, descending=True, stable=True)
        top_scores, anchor_idx = top_scores[:, :k], anchor_idx[:, :k]
        cls_idx = torch.gather(cls, 1, anchor_idx).float()

    offset = torch.zeros_like(cls_idx) if agnostic else cls_idx * max_wh
    cand = torch.gather(boxes_xywh, 1, anchor_idx[..., None].expand(b, k, 4))
    cand_boxes = xywh2xyxy(cand)
    keep = suppress((cand_boxes + offset[..., None]).contiguous(), top_scores.contiguous(),
                    iou_thres, conf_thres)

    rows = torch.cat([cand_boxes, top_scores[..., None], cls_idx[..., None]], dim=-1)
    rank = torch.cumsum(keep.long(), dim=1) - 1
    dst = torch.where(keep & (rank < max_det), rank, torch.full_like(rank, max_det))
    out = torch.zeros((b, max_det + 1, 6), dtype=rows.dtype, device=rows.device)
    out.scatter_(1, dst[..., None].expand(b, k, 6), rows)
    counts = keep.sum(dim=1).clamp(max=max_det).to(torch.int32)
    e = extra.shape[-1]
    extra_rows = torch.gather(extra, 1, anchor_idx[..., None].expand(b, k, e))
    extra_out = torch.zeros((b, max_det + 1, e), dtype=extra.dtype, device=extra.device)
    extra_out.scatter_(1, dst[..., None].expand(b, k, e), extra_rows)
    return out[:, :max_det], counts, extra_out[:, :max_det]
