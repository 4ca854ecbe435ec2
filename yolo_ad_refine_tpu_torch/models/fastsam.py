"""FastSAM of the PyTorch port: segment anything with a single-class
YOLO segmentation model.

Counterpart of ``yolo_ad_refine_tpu/models/fastsam.py`` (reference
models/fastsam/ model.py, predict.py, utils.py). ``FastSAM`` is the port's
``YOLO`` segment facade at nc 1 (``yolov8-seg.yaml``, or FastSAM-x's
``yolov8x-seg.yaml``); ``predict`` serves everything mode at conf 0.4
through the segment predictor, whose NMS launches K4 (``csrc/nms.cu``) once
a batch on the card, snaps near-border boxes onto the border and replaces
near-full-frame boxes by the exact frame, then selects instances by bbox or
point prompts on the host. A text prompt needs the ``clip`` package and
raises ``ImportError`` without it, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from yolo_ad_refine_tpu_torch.models.yolo import YOLO


def adjust_bboxes_to_image_border(boxes: np.ndarray, image_shape: tuple,
                                  threshold: int = 20) -> np.ndarray:
    """Snap boxes within ``threshold`` px of the border onto it (reference
    fastsam/utils.py:4)."""
    h, w = image_shape
    boxes = boxes.copy()
    boxes[boxes[:, 0] < threshold, 0] = 0
    boxes[boxes[:, 1] < threshold, 1] = 0
    boxes[boxes[:, 2] > w - threshold, 2] = w
    boxes[boxes[:, 3] > h - threshold, 3] = h
    return boxes


def _box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy IoU."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area_a = np.clip(a[:, 2:] - a[:, :2], 0, None).prod(-1)
    area_b = np.clip(b[:, 2:] - b[:, :2], 0, None).prod(-1)
    return inter / (area_a[:, None] + area_b[None] - inter + 1e-12)


class FastSAM(YOLO):
    """Everything-mode segmentation and prompt selection. ``model``: a
    segment yaml, by default ``yolov8-seg.yaml`` at nc 1; the other
    arguments are ``YOLO``'s (the card unless ``device="cpu"``)."""

    def __init__(self, model: str = "yolov8-seg.yaml", **kwargs):
        kwargs.setdefault("task", "segment")
        kwargs.setdefault("nc", 1)
        super().__init__(model, **kwargs)
        self.model.names = {0: "object"}

    def predict(self, source=None, bboxes=None, points=None, labels=None, texts=None, **kwargs):
        """Everything mode (conf 0.4 unless given), the border snap, then
        the prompt selection (reference fastsam/predict.py postprocess)."""
        kwargs.setdefault("conf", 0.4)
        results = super().predict(source, **kwargs)
        for r in results:
            h, w = r.orig_shape
            xyxy = adjust_bboxes_to_image_border(np.asarray(r.boxes.xyxy), (h, w))
            full = np.asarray([[0.0, 0.0, w, h]], np.float32)
            xyxy[_box_iou(full, xyxy)[0] > 0.9] = full[0]
            r.boxes.data[:, :4] = xyxy
        return self.prompt(results, bboxes=bboxes, points=points, labels=labels, texts=texts)

    def prompt(self, results, bboxes=None, points=None, labels=None, texts=None):
        """The instances that match the prompts (reference predict.py:60):
        ``bboxes`` (N, 4) xyxy px keep, for each box, the instance whose mask
        has the largest IoU with it; ``points`` (N, 2) px with ``labels``
        (1 foreground, 0 background) keep the instances whose mask holds a
        foreground point and drop those a background point hits; ``texts``
        need CLIP."""
        if bboxes is None and points is None and texts is None:
            return results
        out = []
        for r in results:
            if r.masks is None or not len(r.masks.data):
                out.append(r)
                continue
            masks = np.asarray(r.masks.data) > 0.5  # (n, H, W) over the original image
            n = masks.shape[0]
            idx = np.zeros(n, bool)
            if bboxes is not None:
                bb = np.atleast_2d(np.asarray(bboxes, np.int32))
                mask_areas = np.stack([masks[:, b[1]:b[3], b[0]:b[2]].sum((1, 2)) for b in bb])
                bbox_areas = (bb[:, 3] - bb[:, 1]) * (bb[:, 2] - bb[:, 0])
                union = bbox_areas[:, None] + masks.sum((1, 2))[None] - mask_areas
                idx[np.argmax(mask_areas / np.maximum(union, 1e-12), 1)] = True
            if points is not None:
                pts = np.atleast_2d(np.asarray(points, np.int32))
                lbl = (np.ones(len(pts), np.int32) if labels is None
                       else np.asarray(labels, np.int32))
                if len(lbl) != len(pts):
                    raise ValueError(f"{len(lbl)} labels for {len(pts)} points")
                point_idx = np.ones(n, bool) if lbl.sum() == 0 else np.zeros(n, bool)
                for p, lab in zip(pts, lbl):
                    point_idx[masks[:, p[1], p[0]]] = bool(lab)
                idx |= point_idx
            if texts is not None:
                idx |= self._text_prompt_idx(r, masks, texts)
            out.append(self._take(r, idx))
        return out

    def _text_prompt_idx(self, r, masks, texts):
        try:
            import clip  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "text prompts need the `clip` package (openai CLIP), which this build does not "
                "ship; use bbox or point prompts instead") from e
        raise NotImplementedError("text prompts: CLIP scoring is not built")

    @staticmethod
    def _take(r, idx: np.ndarray):
        """The port's Results of ``r`` with the rows ``idx`` selects."""
        from yolo_ad_refine_tpu_torch.engine.results import Results

        keep = np.nonzero(idx)[0]
        return Results(r.orig_img, r.path, r.names, np.asarray(r.boxes.data)[keep],
                       speed=r.speed,
                       masks=np.asarray(r.masks.data)[keep] if r.masks is not None else None)
