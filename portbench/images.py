"""Seeded synthetic training images in the YOLO layout.

After the port's ``data/synthetic.py make_shapes_dataset`` (frozen here):
textured backgrounds of blurred noise and distractor lines with small
filled discs, rotated boxes and triangles, each of a class drawn from the
configuration's ``nc`` (its shape and tint from the class), written as
JPEGs with one label file each (``cls cx cy w h``, normalised). Small
objects in the tens an image, as aphids on a leaf. Images are made and
written by a pool of threads (cv2 releases the interpreter lock); image
``i`` depends only on (seed, i).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

TINTS = ((60, 60, 230), (70, 200, 80), (230, 140, 50))


def _draw(img, rng, cls: int, cx: int, cy: int, r: int):
    import cv2

    color = tuple(int(np.clip(c + rng.integers(-40, 40), 0, 255)) for c in TINTS[cls % 3])
    kind = cls % 3
    if kind == 0:
        cv2.circle(img, (cx, cy), r, color, -1)
        return cx - r, cy - r, cx + r, cy + r
    if kind == 1:
        ar = float(rng.uniform(0.6, 1.6))
        pts = cv2.boxPoints(((cx, cy), (2 * max(3, int(r * ar)), 2 * max(3, int(r / ar))),
                             float(rng.uniform(0, 90)))).astype(np.int32)
    else:
        a0 = float(rng.uniform(0, 2 * np.pi))
        pts = np.array([(cx + r * np.cos(a0 + k * 2 * np.pi / 3),
                         cy + r * np.sin(a0 + k * 2 * np.pi / 3)) for k in range(3)], np.int32)
    cv2.fillPoly(img, [pts], color)
    return pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()


def write_image(root: Path, seed: int, i: int, w: int, h: int, nc: int, objects, radius) -> None:
    import cv2

    rng = np.random.default_rng([seed, 4, i])
    img = rng.integers(40, 110, (h, w, 3), dtype=np.uint8)
    img = cv2.GaussianBlur(img, (0, 0), sigmaX=float(rng.uniform(2, 6)))
    for _ in range(int(rng.integers(0, 4))):
        g = int(rng.integers(60, 140))
        cv2.line(img, (int(rng.integers(0, w)), int(rng.integers(0, h))),
                 (int(rng.integers(0, w)), int(rng.integers(0, h))), (g, g, g),
                 int(rng.integers(1, 4)))
    lines = []
    for _ in range(int(rng.integers(objects[0], objects[1] + 1))):
        cls = int(rng.integers(0, nc))
        r = int(rng.integers(radius[0], radius[1] + 1))
        cx, cy = int(rng.integers(r + 2, w - r - 2)), int(rng.integers(r + 2, h - r - 2))
        x1, y1, x2, y2 = _draw(img, rng, cls, cx, cy, r)
        x1, y1, x2, y2 = max(0, x1), max(0, y1), min(w - 1, x2), min(h - 1, y2)
        lines.append(f"{cls} {(x1 + x2) / 2 / w:.5f} {(y1 + y2) / 2 / h:.5f} "
                     f"{(x2 - x1) / w:.5f} {(y2 - y1) / h:.5f}")
    cv2.imwrite(str(root / "images" / f"{i:06d}.jpg"), img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    (root / "labels" / f"{i:06d}.txt").write_text("\n".join(lines) + "\n")


def write_split(root: Path, n: int, seed: int, size, nc: int, objects, radius,
                threads: int = 8) -> None:
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "labels").mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(lambda i: write_image(root, seed, i, size[0], size[1], nc, objects, radius),
                      range(n)))
