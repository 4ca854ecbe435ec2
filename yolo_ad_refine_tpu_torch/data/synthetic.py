"""Synthetic detection datasets.

``make_shapes_dataset`` is the counterpart of
``yolo_ad_refine_tpu/data/synthetic.py``: a deterministic stand-in for a
real detection set (textured backgrounds with coloured discs, boxes and
triangles) in YOLO layout (images/ + labels/ txt + a data dict), so the
whole train pipeline runs without a download. The same seed writes the same
files as the JAX package's generator. ``make_dota_dataset`` writes an
oriented-box val set in the DOTA layout that ``data/split_dota.py`` tiles
produce (square tiles, 15 DOTA v1 classes, corner-quad labels).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

CLASS_NAMES = {0: "disc", 1: "box", 2: "tri"}
DOTA_NAMES = dict(enumerate((
    "plane", "ship", "storage-tank", "baseball-diamond", "tennis-court", "basketball-court",
    "ground-track-field", "harbor", "bridge", "large-vehicle", "small-vehicle", "helicopter",
    "roundabout", "soccer-ball-field", "swimming-pool")))


def _draw_object(img: np.ndarray, rng: np.random.Generator, cls: int,
                 cx: int, cy: int, r: int) -> tuple[int, int, int, int]:
    """Draw one object; returns its tight xyxy box."""
    import cv2

    # per-instance color jitter around a class hue so classes are separable
    # by shape AND tint, but not by a single constant pixel value
    base = {0: (60, 60, 230), 1: (70, 200, 80), 2: (230, 140, 50)}[cls]
    color = tuple(int(np.clip(c + rng.integers(-40, 40), 0, 255)) for c in base)
    if cls == 0:
        cv2.circle(img, (cx, cy), r, color, -1)
        box = (cx - r, cy - r, cx + r, cy + r)
    elif cls == 1:
        ar = float(rng.uniform(0.6, 1.6))
        hw, hh = max(3, int(r * ar)), max(3, int(r / ar))
        ang = float(rng.uniform(0, 90))
        pts = cv2.boxPoints(((cx, cy), (2 * hw, 2 * hh), ang)).astype(np.int32)
        cv2.fillPoly(img, [pts], color)
        xs, ys = pts[:, 0], pts[:, 1]
        box = (xs.min(), ys.min(), xs.max(), ys.max())
    else:
        ang0 = float(rng.uniform(0, 2 * np.pi))
        pts = np.stack([
            (cx + r * np.cos(ang0 + k * 2 * np.pi / 3),
             cy + r * np.sin(ang0 + k * 2 * np.pi / 3)) for k in range(3)
        ]).astype(np.int32)
        cv2.fillPoly(img, [pts], color)
        box = (pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max())
    return box


def make_shapes_dataset(root: str | Path, n_train: int = 200, n_val: int = 48,
                        imgsz: int = 320, seed: int = 0,
                        max_objects: int = 5,
                        aspect_range: tuple = (1.0, 1.0)) -> dict:
    """Write a YOLO-layout shapes dataset; returns a data dict for train().

    Deterministic in (seed, sizes). Backgrounds are low-frequency noise with
    random distractor lines so the detector must learn shapes, not just
    "non-background pixels". ``aspect_range`` (lo, hi): per-image H/W drawn
    log-uniformly in the range (W = imgsz), for rectangular-val experiments.
    """
    import cv2

    root = Path(root)
    for split, n, s in (("train", n_train, seed), ("val", n_val, seed + 7919)):
        (root / split / "images").mkdir(parents=True, exist_ok=True)
        (root / split / "labels").mkdir(parents=True, exist_ok=True)
        rng = np.random.default_rng(s)
        for i in range(n):
            ar = float(np.exp(rng.uniform(np.log(aspect_range[0]),
                                          np.log(aspect_range[1]))))
            imgh = max(32, int(round(imgsz * ar / 2)) * 2)
            # textured background: blurred noise + gradient
            img = rng.integers(40, 110, (imgh, imgsz, 3), dtype=np.uint8)
            img = cv2.GaussianBlur(img, (0, 0), sigmaX=float(rng.uniform(2, 6)))
            for _ in range(int(rng.integers(0, 4))):  # distractor lines
                p1 = (int(rng.integers(0, imgsz)), int(rng.integers(0, imgh)))
                p2 = (int(rng.integers(0, imgsz)), int(rng.integers(0, imgh)))
                gray = int(rng.integers(60, 140))
                cv2.line(img, p1, p2, (gray, gray, gray), int(rng.integers(1, 4)))
            lines = []
            mind = min(imgsz, imgh)
            for _ in range(int(rng.integers(1, max_objects + 1))):
                cls = int(rng.integers(0, 3))
                r = int(rng.integers(mind // 16, mind // 5))
                cx = int(rng.integers(r + 2, imgsz - r - 2))
                cy = int(rng.integers(r + 2, imgh - r - 2))
                x1, y1, x2, y2 = _draw_object(img, rng, cls, cx, cy, r)
                x1, y1 = max(0, x1), max(0, y1)
                x2, y2 = min(imgsz - 1, x2), min(imgh - 1, y2)
                lines.append(
                    f"{cls} {(x1 + x2) / 2 / imgsz:.5f} {(y1 + y2) / 2 / imgh:.5f} "
                    f"{(x2 - x1) / imgsz:.5f} {(y2 - y1) / imgh:.5f}")
            cv2.imwrite(str(root / split / "images" / f"{i:04d}.jpg"), img)
            (root / split / "labels" / f"{i:04d}.txt").write_text(
                "\n".join(lines) + "\n")
    return {"path": str(root), "train": "train/images", "val": "val/images",
            "names": dict(CLASS_NAMES)}


def make_dota_dataset(root: str | Path, n_val: int = 16, imgsz: int = 1024, seed: int = 0,
                      max_objects: int = 24) -> dict:
    """Write a DOTA-format val set: ``n_val`` square ``imgsz`` PNG tiles of
    blurred noise with filled rotated rectangles of the 15 DOTA v1 classes
    (8-25 % of the tile long, any angle, each inside its tile), labelled
    ``cls x1 y1 x2 y2 x3 y3 x4 y4`` in normalised corners. Deterministic in
    (seed, sizes); returns a data dict for ``val(data=...)``."""
    import cv2

    root = Path(root)
    (root / "val" / "images").mkdir(parents=True, exist_ok=True)
    (root / "val" / "labels").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_val):
        img = rng.integers(40, 110, (imgsz, imgsz, 3), dtype=np.uint8)
        img = cv2.GaussianBlur(img, (0, 0), sigmaX=float(rng.uniform(2, 6)))
        lines = []
        for _ in range(int(rng.integers(1, max_objects + 1))):
            cls = int(rng.integers(0, len(DOTA_NAMES)))
            w, h = rng.uniform(0.08, 0.25, 2) * imgsz * np.array([1.0, rng.uniform(0.3, 1.0)])
            half = 0.5 * float(np.hypot(w, h)) + 1
            cx, cy = rng.uniform(half, imgsz - half, 2)
            pts = cv2.boxPoints(((cx, cy), (w, h), float(rng.uniform(0, 180))))
            color = tuple(int(v) for v in rng.integers(0, 256, 3))
            cv2.fillPoly(img, [np.round(pts).astype(np.int32)], color)
            lines.append(f"{cls} " + " ".join(f"{v / imgsz:.6f}" for v in pts.reshape(-1)))
        cv2.imwrite(str(root / "val" / "images" / f"{i:04d}.png"), img)
        (root / "val" / "labels" / f"{i:04d}.txt").write_text("\n".join(lines) + "\n")
    return {"path": str(root), "val": "val/images", "names": dict(DOTA_NAMES)}
