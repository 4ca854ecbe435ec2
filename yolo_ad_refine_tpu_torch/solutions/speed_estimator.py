"""Per-track speed estimation (parity: reference solutions/speed_estimation.py).

Pixel displacement of track centers per frame, scaled by pixels-per-meter and
frame rate into km/h.

Counterpart of ``yolo_ad_refine_tpu/solutions/speed_estimator.py``: the same
host-side code over the port's ``Results``.
"""

from __future__ import annotations

import numpy as np


class SpeedEstimator:
    def __init__(self, fps: float = 30.0, pixels_per_meter: float = 10.0, smooth: int = 5):
        self.fps = fps
        self.ppm = pixels_per_meter
        self.smooth = smooth
        self._history: dict[int, list[tuple[float, float]]] = {}
        self.speeds: dict[int, float] = {}

    def update(self, results) -> dict[int, float]:
        boxes = results.boxes
        if boxes.id is None:
            return self.speeds
        for row in boxes.data:
            tid = int(row[4])
            cx, cy = float((row[0] + row[2]) / 2), float((row[1] + row[3]) / 2)
            hist = self._history.setdefault(tid, [])
            hist.append((cx, cy))
            if len(hist) > self.smooth:
                hist.pop(0)
            if len(hist) >= 2:
                d = np.diff(np.asarray(hist), axis=0)
                px_per_frame = float(np.linalg.norm(d, axis=1).mean())
                m_per_s = px_per_frame / self.ppm * self.fps
                self.speeds[tid] = m_per_s * 3.6  # km/h
        return self.speeds
