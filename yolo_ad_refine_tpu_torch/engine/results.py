"""Inference result containers (host-side numpy).

Counterpart of ``Boxes`` / ``Results`` in
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


class Results:
    """Per-image result: boxes and metadata."""

    def __init__(self, orig_img: np.ndarray, path: str, names: dict, boxes: np.ndarray,
                 speed: dict | None = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes, self.orig_shape)
        self.speed = speed or {}

    def __len__(self):
        return len(self.boxes)

    def tojson(self) -> str:
        out = []
        for row in self.boxes.data:
            x1, y1, x2, y2, conf, cls = row.tolist()
            out.append({"name": str(self.names.get(int(cls), int(cls))), "class": int(cls),
                        "confidence": round(conf, 5),
                        "box": {"x1": x1, "y1": y1, "x2": x2, "y2": y2}})
        return json.dumps(out, indent=2)

    def verbose(self) -> str:
        if not len(self.boxes):
            return "(no detections)"
        counts: dict = {}
        for c in self.boxes.cls.astype(int):
            counts[c] = counts.get(c, 0) + 1
        return ", ".join(f"{n} {self.names.get(c, c)}{'s' * (n > 1)}" for c, n in counts.items())
