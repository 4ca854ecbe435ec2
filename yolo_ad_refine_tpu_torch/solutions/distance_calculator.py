"""Pairwise distance between selected tracks (parity: reference solutions/distance_calculation.py).

Counterpart of ``yolo_ad_refine_tpu/solutions/distance_calculator.py``: the same
host-side code over the port's ``Results``.
"""

from __future__ import annotations

import numpy as np


class DistanceCalculator:
    def __init__(self, pixels_per_meter: float = 10.0):
        self.ppm = pixels_per_meter

    def update(self, results, ids: tuple[int, int] | None = None) -> dict:
        """Distance between two track ids (or all pairs when ids is None)."""
        boxes = results.boxes
        if boxes.id is None or len(boxes) < 2:
            return {}
        centers = {
            int(r[4]): ((r[0] + r[2]) / 2, (r[1] + r[3]) / 2) for r in boxes.data
        }
        out = {}
        keys = sorted(centers)
        pairs = [ids] if ids else [(a, b) for i, a in enumerate(keys) for b in keys[i + 1 :]]
        for a, b in pairs:
            if a in centers and b in centers:
                d_px = float(np.hypot(centers[a][0] - centers[b][0],
                                      centers[a][1] - centers[b][1]))
                out[(a, b)] = {"pixels": d_px, "meters": d_px / self.ppm}
        return out
