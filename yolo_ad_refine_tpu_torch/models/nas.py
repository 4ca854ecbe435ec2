"""YOLO-NAS adapter of the PyTorch port.

Counterpart of ``yolo_ad_refine_tpu/models/nas.py`` (reference models/nas/:
the network comes from the external ``super_gradients`` package, whose raw
output is boxes xyxy and per-class scores). ``nas_postprocess`` turns that
layout into detections through the port's NMS (``ops/nms.py``: K4,
``csrc/nms.cu``, on the card); ``NAS`` raises ``ImportError`` without
``super_gradients``, as the JAX facade does.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_ad_refine_tpu_torch.ops.boxes import xyxy2xywh
from yolo_ad_refine_tpu_torch.ops.nms import non_max_suppression
from yolo_ad_refine_tpu_torch.utils import select_device


def nas_postprocess(boxes_xyxy, scores, conf_thres: float = 0.25, iou_thres: float = 0.45,
                    max_det: int = 300, device: str | torch.device = "cuda"):
    """NAS raw output -> detections (reference nas/predict.py postprocess).

    boxes_xyxy (B, N, 4) and scores (B, N, nc), tensors (which stay on
    their device) or arrays (which go to ``device``, the card unless
    "cpu"). Returns numpy (det (B, max_det, 6) rows (x1, y1, x2, y2, conf,
    cls), counts (B,)).
    """
    if not isinstance(boxes_xyxy, torch.Tensor):
        dev = select_device(device)
        boxes_xyxy = torch.as_tensor(np.asarray(boxes_xyxy, np.float32), device=dev)
        scores = torch.as_tensor(np.asarray(scores, np.float32), device=dev)
    boxes, scores = boxes_xyxy.float(), scores.float().to(boxes_xyxy.device)
    pred = torch.cat([xyxy2xywh(boxes), scores], -1)
    det, cnt, _ = non_max_suppression(pred, conf_thres=conf_thres, iou_thres=iou_thres,
                                      max_det=max_det, nc=scores.shape[-1])
    return det.cpu().numpy(), cnt.cpu().numpy()


class NAS:
    """YOLO-NAS facade (reference nas/model.py NAS): the network needs
    ``super_gradients``."""

    def __init__(self, model: str = "yolo_nas_s"):
        if str(model).endswith((".yaml", ".yml")):
            raise AssertionError("YOLO-NAS models only support pre-trained models.")
        try:
            import super_gradients  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "YOLO-NAS networks are defined by the `super_gradients` package (the reference "
                "has no in-repo NAS architecture either), which this build does not ship; run "
                "an exported NAS program and pass its raw output to "
                "models.nas.nas_postprocess") from e
        self.model_name = model
