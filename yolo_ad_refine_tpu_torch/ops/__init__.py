"""Tensor ops and geometry of the PyTorch port (counterpart of
``yolo_ad_refine_tpu/ops``; reference ultralytics/utils/{ops,tal,metrics}.py).

Importing the package builds no kernel: each CUDA kernel is built at its
first call on a CUDA tensor (``utils/kernels.py``).
"""

from yolo_ad_refine_tpu_torch.ops.boxes import (
    clip_boxes,
    ltwh2xywh,
    ltwh2xyxy,
    scale_boxes,
    xywh2ltwh,
    xywh2xyxy,
    xywhn2xyxy,
    xyxy2ltwh,
    xyxy2xywh,
    xyxy2xywhn,
)
from yolo_ad_refine_tpu_torch.ops.iou import bbox_iou, box_iou, wasserstein_similarity
from yolo_ad_refine_tpu_torch.ops.anchors import bbox2dist, dist2bbox, make_anchors
from yolo_ad_refine_tpu_torch.ops.nms import non_max_suppression

__all__ = [
    "clip_boxes", "scale_boxes", "xywh2xyxy", "xyxy2xywh", "xywhn2xyxy", "xyxy2xywhn",
    "ltwh2xyxy", "ltwh2xywh", "xywh2ltwh", "xyxy2ltwh",
    "bbox_iou", "box_iou", "wasserstein_similarity",
    "make_anchors", "dist2bbox", "bbox2dist",
    "non_max_suppression",
]
