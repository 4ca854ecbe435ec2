"""Parking lot occupancy from polygon slot regions.

Parity surface: reference solutions/parking_management.py ParkingManagement
.process_data — each slot is a polygon from a JSON file
([{"points": [[x, y], ...]}, ...], the format the reference's Tkinter
ParkingPtsSelection tool saves); a slot is occupied when any detection's box
center falls inside it. The reference's interactive Tkinter selector is a
desktop GUI and is out of scope for this headless build — author the JSON
with any tool (the format is four corner points per slot).

Counterpart of ``yolo_ad_refine_tpu/solutions/parking_manager.py``: the same
host-side code over the port's ``Results``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from yolo_ad_refine_tpu_torch.solutions.base import point_in_polygon


class ParkingManager:
    """Tracks per-slot occupancy. json_path: slot polygons file."""

    def __init__(self, json_path: str | Path):
        self.slots = json.loads(Path(json_path).read_text())
        if not (isinstance(self.slots, list) and all("points" in s for s in self.slots)):
            raise ValueError(f"{json_path}: expected a list of {{\"points\": [[x, y], ...]}} slots")
        self.occupancy: list[bool] = [False] * len(self.slots)

    def update(self, results) -> dict:
        """Feed one frame's Results; returns occupancy summary."""
        boxes = results.boxes
        centers = []
        if len(boxes):
            xyxy = np.asarray(boxes.xyxy, np.float64)
            centers = np.stack([(xyxy[:, 0] + xyxy[:, 2]) / 2,
                                (xyxy[:, 1] + xyxy[:, 3]) / 2], -1)
        for i, slot in enumerate(self.slots):
            poly = [tuple(map(float, p)) for p in slot["points"]]
            self.occupancy[i] = any(point_in_polygon(tuple(c), poly) for c in centers)
        return self.summary()

    def summary(self) -> dict:
        filled = int(sum(self.occupancy))
        return {"Occupancy": filled, "Available": len(self.slots) - filled,
                "slots": list(self.occupancy)}

    def annotate(self, img: np.ndarray) -> np.ndarray:
        """Draw slot polygons (green available / red occupied) on a frame."""
        import cv2

        img = np.ascontiguousarray(img)
        for slot, occ in zip(self.slots, self.occupancy):
            pts = np.asarray(slot["points"], np.int32).reshape(-1, 1, 2)
            color = (0, 0, 255) if occ else (0, 255, 0)
            cv2.polylines(img, [pts], isClosed=True, color=color, thickness=2)
        return img
