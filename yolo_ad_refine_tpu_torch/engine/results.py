"""Inference result containers (host-side numpy).

Counterpart of ``Boxes`` / ``Masks`` / ``Keypoints`` / ``OBBoxes`` /
``Results`` in ``yolo_ad_refine_tpu/engine/results.py`` (reference
engine/results.py), with its ``plot``, ``save``, ``save_txt``,
``save_crop`` and ``tojson`` for boxes, instance masks, keypoints and
oriented boxes, drawn with cv2 on the host. ``Boxes`` also takes the
tracker's 7-column rows (``is_track``, ``id``; ``plot`` labels them
``id:<n>`` and ``tojson`` writes ``track_id``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


class Boxes:
    """(n, 6) detections [x1, y1, x2, y2, conf, cls] or (n, 7) track rows
    [x1, y1, x2, y2, track id, conf, cls] in original-image pixels."""

    def __init__(self, data: np.ndarray, orig_shape: tuple):
        data = np.asarray(data, dtype=np.float32)
        if data.ndim == 1:
            data = data.reshape(-1, 6)
        if data.shape[-1] not in (6, 7):
            raise ValueError(f"expected 6 or 7 columns, got {data.shape}")
        self.data = data
        self.is_track = data.shape[-1] == 7
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def id(self):
        """The track ids of track rows, else None."""
        return self.data[:, 4] if self.is_track else None

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

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


class Masks:
    """(n, H, W) binary instance masks over the original image (reference
    results.py Masks); the predictor gives them as bool."""

    def __init__(self, data: np.ndarray, orig_shape: tuple):
        self.data = np.asarray(data)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xy(self) -> list[np.ndarray]:
        """Each mask's largest external contour, (P, 2) pixels (reference
        masks2segments)."""
        import cv2

        out = []
        for m in self.data:
            cs, _ = cv2.findContours((m > 0.5).astype(np.uint8), cv2.RETR_EXTERNAL,
                                     cv2.CHAIN_APPROX_SIMPLE)
            out.append(max(cs, key=cv2.contourArea).reshape(-1, 2).astype(np.float32)
                       if cs else np.zeros((0, 2), np.float32))
        return out


class Keypoints:
    """(n, K, 2 or 3) keypoints in original-image pixels (reference
    results.py Keypoints): ``xy`` pixels, ``xyn`` normalised, ``conf`` the
    visibility where there is one."""

    def __init__(self, data: np.ndarray, orig_shape: tuple):
        self.data = np.asarray(data, np.float32)
        self.orig_shape = orig_shape

    def __len__(self):
        return len(self.data)

    @property
    def xy(self):
        return self.data[..., :2]

    @property
    def xyn(self):
        h, w = self.orig_shape
        return self.xy / np.asarray([w, h], np.float32)

    @property
    def conf(self):
        return self.data[..., 2] if self.data.shape[-1] == 3 else None


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
    rotated boxes in ``obb``), the instance masks (segment), the keypoints
    (pose) and metadata."""

    def __init__(self, orig_img: np.ndarray, path: str, names: dict, boxes: np.ndarray,
                 speed: dict | None = None, masks: np.ndarray | None = None,
                 keypoints: np.ndarray | None = None, obb: np.ndarray | None = None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes, self.orig_shape)
        self.masks = Masks(masks, self.orig_shape) if masks is not None else None
        self.keypoints = Keypoints(keypoints, self.orig_shape) if keypoints is not None else None
        self.obb = OBBoxes(obb, self.orig_shape) if obb is not None else None
        self.speed = speed or {}

    def __len__(self):
        return len(self.boxes)

    @staticmethod
    def _color(c: int) -> tuple:
        return tuple(int(v) for v in np.array([37, 255, 153]) * ((c * 17 + 29) % 7 + 1) % 255)

    def plot(self, line_width: int | None = None, font_scale: float = 0.5) -> np.ndarray:
        """Draw the detections on a copy of the original BGR image: the
        masks blended in at half weight, the rotated boxes' outlines, the
        keypoints whose visibility passes 0.25, then the boxes and labels."""
        import cv2

        img = self.orig_img.copy()
        lw = line_width or max(round(sum(img.shape) / 2 * 0.003), 2)
        if self.masks is not None and len(self.masks):
            overlay = img.copy()
            for i, m in enumerate(self.masks.data):
                on = m > 0.5
                overlay[on] = 0.5 * overlay[on] + 0.5 * np.array(self._color(i))
            img = overlay.astype(img.dtype)
        if self.obb is not None and len(self.obb):
            for i, pts in enumerate(self.obb.xyxyxyxy):
                cv2.polylines(img, [pts.astype(np.int32)], True, self._color(int(self.obb.cls[i])),
                              lw)
        if self.keypoints is not None and len(self.keypoints):
            for kps in self.keypoints.data:
                for x, y, *v in kps:
                    if not v or v[0] > 0.25:
                        cv2.circle(img, (int(x), int(y)), max(lw, 2), (0, 0, 255), -1)
        for row in self.boxes.data:
            x1, y1, x2, y2 = row[:4]
            conf, c = row[-2], int(row[-1])
            color = self._color(c)
            p1, p2 = (int(x1), int(y1)), (int(x2), int(y2))
            cv2.rectangle(img, p1, p2, color, lw)
            tid = f"id:{int(row[4])} " if self.boxes.is_track else ""
            label = f"{tid}{self.names.get(c, c)} {conf:.2f}"
            tw, th = cv2.getTextSize(label, 0, font_scale, 1)[0]
            cv2.rectangle(img, p1, (p1[0] + tw, p1[1] - th - 3), color, -1)
            cv2.putText(img, label, (p1[0], p1[1] - 2), 0, font_scale, (255, 255, 255), 1)
        return img

    def save(self, filename: str | Path):
        """Write ``plot()`` to ``filename``, making its directory."""
        import cv2

        Path(filename).parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(filename), self.plot())
        return filename

    def save_txt(self, txt_file: str | Path, save_conf: bool = False) -> Path:
        """YOLO-format label rows, one a detection: ``cls cx cy w h`` of the
        box normalised by the image (OBB: ``cls`` and the 4 normalised
        corner points; segment: ``cls`` and the mask's normalised contour;
        pose: the box, then each keypoint's normalised x, y and
        visibility), with the confidence last under ``save_conf``."""
        h, w = self.orig_shape
        lines = []
        for i in range(len(self.obb if self.obb is not None else self.boxes)):
            if self.obb is not None:
                c, conf = int(self.obb.cls[i]), float(self.obb.conf[i])
                coords = (self.obb.xyxyxyxy[i] / np.asarray([w, h], np.float32)).reshape(-1)
            elif self.masks is not None and i < len(self.masks):
                c, conf = int(self.boxes.cls[i]), float(self.boxes.conf[i])
                coords = (self.masks.xy[i] / np.asarray([w, h], np.float32)).reshape(-1)
            else:
                c, conf = int(self.boxes.cls[i]), float(self.boxes.conf[i])
                coords = self.boxes.xywhn[i]
                if self.keypoints is not None:
                    kd = self.keypoints.data[i].copy()
                    kd[:, 0] /= w
                    kd[:, 1] /= h
                    coords = np.concatenate([coords, kd.reshape(-1)])
            row = (c, *np.asarray(coords).tolist()) + ((conf,) if save_conf else ())
            lines.append(("%g " * len(row)).rstrip() % row)
        p = Path(txt_file)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("\n".join(lines) + ("\n" if lines else ""))
        return p

    def save_crop(self, save_dir: str | Path, file_name: str | Path = "im.jpg") -> Path:
        """One crop a detection, ``save_dir/<class name>/<stem>[_i].jpg``:
        the box grown by 2 % and 10 px a side, clipped to the image
        (reference utils/plotting.py save_one_box)."""
        import cv2

        h, w = self.orig_shape
        stem = Path(file_name).stem
        for i in range(len(self.boxes)):
            x1, y1, x2, y2 = self.boxes.xyxy[i]
            cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
            bw, bh = (x2 - x1) * 1.02 + 20, (y2 - y1) * 1.02 + 20
            xa, xb = int(max(0, cx - bw / 2)), int(min(w, cx + bw / 2))
            ya, yb = int(max(0, cy - bh / 2)), int(min(h, cy + bh / 2))
            if xb <= xa or yb <= ya:
                continue
            name = str(self.names.get(int(self.boxes.cls[i]), int(self.boxes.cls[i])))
            out = Path(save_dir) / name / f"{stem}{'' if i == 0 else f'_{i}'}.jpg"
            out.parent.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(out), self.orig_img[ya:yb, xa:xb])
        return Path(save_dir)

    def tojson(self) -> str:
        out = []
        for i, row in enumerate(self.boxes.data):
            x1, y1, x2, y2 = row[:4].tolist()
            conf, cls = float(row[-2]), int(row[-1])
            entry = {"name": str(self.names.get(cls, cls)), "class": cls,
                     "confidence": round(conf, 5),
                     "box": {"x1": x1, "y1": y1, "x2": x2, "y2": y2}}
            if self.boxes.is_track:
                entry["track_id"] = int(row[4])
            if self.keypoints is not None and i < len(self.keypoints):
                entry["keypoints"] = {"x": self.keypoints.xy[i, :, 0].round(2).tolist(),
                                      "y": self.keypoints.xy[i, :, 1].round(2).tolist()}
                if self.keypoints.conf is not None:
                    entry["keypoints"]["visible"] = self.keypoints.conf[i].round(3).tolist()
            if self.masks is not None and i < len(self.masks):
                seg = self.masks.xy[i]
                entry["segments"] = {"x": seg[:, 0].round(2).tolist(),
                                     "y": seg[:, 1].round(2).tolist()}
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
