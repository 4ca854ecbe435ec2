"""Detection heatmap accumulation.

Parity surface: reference solutions/heatmap.py — the radial
``heatmap_effect`` (inscribed-circle mask, +2 per frame, heatmap.py:24-45)
and the ``generate_heatmap`` pipeline (track-gated accumulation, optional
region counting inherited from ObjectCounter, min-max normalized colormap
blend at 0.5 alpha, heatmap.py:47-93). The simple rectangular
``update``/``render`` API is kept for callers that just want a presence
map.

Counterpart of ``yolo_ad_refine_tpu/solutions/heatmap.py``: the same
host-side code over the port's ``Results``.
"""

from __future__ import annotations

import numpy as np

from yolo_ad_refine_tpu_torch.solutions.object_counter import ObjectCounter


class Heatmap:
    """Accumulates per-pixel presence of detections, renders a color overlay."""

    def __init__(self, shape: tuple[int, int], decay: float = 0.99,
                 colormap: int | None = None,
                 region: list[tuple] | None = None,
                 names: dict | None = None, line_width: int = 2):
        self.heat = np.zeros(shape, np.float32)
        self.decay = decay
        self.colormap = colormap
        # optional region counting rides the ObjectCounter machinery,
        # mirroring the reference's Heatmap(ObjectCounter) inheritance
        self.counter = (ObjectCounter(region, names=names,
                                      line_width=line_width)
                        if region is not None else None)

    # -- simple rectangular accumulation ------------------------------------

    def update(self, results):
        self.heat *= self.decay
        h, w = self.heat.shape
        for row in results.boxes.data:
            x1, y1, x2, y2 = (int(max(0, v)) for v in row[:4])
            self.heat[min(y1, h) : min(y2, h), min(x1, w) : min(x2, w)] += 1.0
        return self.heat

    # -- reference-exact radial accumulation --------------------------------

    def heatmap_effect(self, box):
        """Inscribed-circle +2 accumulation (reference heatmap.py:24-45)."""
        h, w = self.heat.shape
        x0, y0, x1, y1 = (int(v) for v in box[:4])
        x0, y0 = max(0, x0), max(0, y0)
        x1, y1 = min(w, x1), min(h, y1)
        if x1 <= x0 or y1 <= y0:
            return
        r2 = (min(x1 - x0, y1 - y0) // 2) ** 2
        xv, yv = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
        d2 = (xv - (x0 + x1) // 2) ** 2 + (yv - (y0 + y1) // 2) ** 2
        self.heat[y0:y1, x0:x1][d2 <= r2] += 2

    def generate_heatmap(self, im0: np.ndarray, results) -> np.ndarray:
        """Track-gated radial accumulation + optional region counting +
        0.5-alpha colormap blend (reference generate_heatmap)."""
        import cv2

        boxes = results.boxes
        if boxes is None or boxes.id is None:
            return im0
        if self.counter is not None:
            # draws region/labels/trails and updates IN/OUT counts in place
            self.counter.count(im0, results)
        for row in np.asarray(boxes.data, np.float64):
            self.heatmap_effect(row[:4])
        norm = cv2.normalize(self.heat, None, 0, 255, cv2.NORM_MINMAX)
        cmap = self.colormap if self.colormap is not None else cv2.COLORMAP_JET
        colored = cv2.applyColorMap(norm.astype(np.uint8), cmap)
        blended = cv2.addWeighted(im0, 0.5, colored, 0.5, 0)
        im0[:] = blended
        return im0

    def render(self, frame: np.ndarray | None = None, alpha: float = 0.5) -> np.ndarray:
        import cv2

        norm = self.heat / (self.heat.max() + 1e-9)
        cmap = self.colormap if self.colormap is not None else cv2.COLORMAP_JET
        colored = cv2.applyColorMap((norm * 255).astype(np.uint8), cmap)
        if frame is None:
            return colored
        return cv2.addWeighted(frame, 1 - alpha, colored, alpha, 0)
