"""Inference result containers (host-side numpy).

Counterpart of ``Boxes`` / ``OBBoxes`` / ``Results`` in
``yolo_ad_refine_tpu/engine/results.py`` (reference engine/results.py);
plotting and saving come in a later slice.
"""

from __future__ import annotations

import json

import numpy as np


class Boxes:
    """(n, 6) detections [x1, y1, x2, y2, conf, cls] in original-image pixels."""

    def __init__(self, data: np.ndarray, orig_shape: tuple):
        data = np.asarray(data, dtype=np.float32)
        if data.ndim == 1:
            data = data.reshape(-1, 6)
        if data.shape[-1] != 6:
            raise ValueError(f"expected 6 columns, got {data.shape}")
        self.data = data
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, 4]

    @property
    def cls(self):
        return self.data[:, 5]

    @property
    def xywh(self):
        b = self.data[:, :4]
        return np.concatenate([(b[:, :2] + b[:, 2:]) / 2, b[:, 2:] - b[:, :2]], -1)

    @property
    def xyxyn(self):
        h, w = self.orig_shape
        return self.xyxy / np.asarray([w, h, w, h], np.float32)

    @property
    def xywhn(self):
        h, w = self.orig_shape
        return self.xywh / np.asarray([w, h, w, h], np.float32)


class OBBoxes:
    """(n, 7) oriented detections [cx, cy, w, h, r, conf, cls] in
    original-image pixels, r in radians (reference results.py OBB)."""

    def __init__(self, data: np.ndarray, orig_shape: tuple):
        self.data = np.asarray(data, np.float32).reshape(-1, 7)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xywhr(self):
        return self.data[:, :5]

    @property
    def conf(self):
        return self.data[:, 5]

    @property
    def cls(self):
        return self.data[:, 6]

    @property
    def xyxyxyxy(self):
        """(n, 4, 2) corner points."""
        cx, cy, w, h, r = (self.data[:, i] for i in range(5))
        c, s = np.cos(r), np.sin(r)
        dx = np.stack([-w / 2, w / 2, w / 2, -w / 2], -1)
        dy = np.stack([-h / 2, -h / 2, h / 2, h / 2], -1)
        return np.stack([cx[:, None] + dx * c[:, None] - dy * s[:, None],
                         cy[:, None] + dx * s[:, None] + dy * c[:, None]], -1)

    @property
    def xyxy(self):
        """(n, 4) axis-aligned hulls of the rotated boxes."""
        pts = self.xyxyxyxy
        return np.concatenate([pts.min(1), pts.max(1)], -1)


class Results:
    """Per-image result: boxes (for OBB their axis-aligned hulls, with the
    rotated boxes in ``obb``) and metadata."""

    def __init__(self, orig_img: np.ndarray, path: str, names: dict, boxes: np.ndarray,
                 speed: dict | None = None, obb: np.ndarray | None = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes, self.orig_shape)
        self.obb = OBBoxes(obb, self.orig_shape) if obb is not None else None
        self.speed = speed or {}

    def __len__(self):
        return len(self.boxes)

    def tojson(self) -> str:
        out = []
        for i, row in enumerate(self.boxes.data):
            x1, y1, x2, y2, conf, cls = row.tolist()
            entry = {"name": str(self.names.get(int(cls), int(cls))), "class": int(cls),
                     "confidence": round(conf, 5),
                     "box": {"x1": x1, "y1": y1, "x2": x2, "y2": y2}}
            if self.obb is not None and i < len(self.obb):
                entry["rbox"] = {k: round(float(v), 3) for k, v in zip("xywhr", self.obb.xywhr[i])}
            out.append(entry)
        return json.dumps(out, indent=2)

    def verbose(self) -> str:
        if not len(self.boxes):
            return "(no detections)"
        counts: dict = {}
        for c in self.boxes.cls.astype(int):
            counts[c] = counts.get(c, 0) + 1
        return ", ".join(f"{n} {self.names.get(c, c)}{'s' * (n > 1)}" for c, n in counts.items())
