"""YOLO-format detection dataset (host-side numpy + cv2).

Counterpart of ``yolo_ad_refine_tpu/data/dataset.py`` for ``task="detect"``
and ``task="obb"`` (reference ultralytics/data/base.py:21, dataset.py:45,
data/utils.py:254): images are globbed, YOLO txt labels parsed (exact
duplicate rows dropped), each image resized so its long side is imgsz
(ceil, base.py:171), and ``get_sample`` runs the train pipeline (mosaic,
perspective, mixup, extras, HSV, flips) or the val letterbox, drawing from
the given generator in the JAX package's order. Samples: img uint8 HWC
BGR, bboxes (n, 4) xyxy px (OBB: (n, 5) xywhr px from DOTA-style corner
rows), cls (n,), ori_shape, ratio_pad, im_file. OBB runs the val case
only: its augments wait for OBB training. ``cache_images`` keeps the
resized decodes in memory (``"ram"`` or True) or in ``.yat<imgsz>.npz``
sidecars beside the images (``"disk"``); ``set_rectangle`` gives rect
validation its static aspect-ratio buckets.
"""

from __future__ import annotations

import math
import os
import threading
from pathlib import Path

import cv2
import numpy as np

from yolo_ad_refine_tpu_torch.data import augment as A
from yolo_ad_refine_tpu_torch.utils import LOGGER, not_ported, yaml_load

IMG_FORMATS = {"bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp", "pfm"}


def check_det_dataset(data: str | Path | dict) -> dict:
    """Parse a data.yaml or dict (path / train / val / names) into resolved
    paths, names as {id: name} and nc (reference data/utils.py:254)."""
    if isinstance(data, (str, Path)):
        d = yaml_load(data)
        d["yaml_file"] = str(data)
        base = Path(d.get("path") or Path(data).parent)
        if not base.is_absolute():
            base = (Path(data).parent / base).resolve()
    else:
        d = dict(data)
        base = Path(d.get("path", "."))
    names = d.get("names")
    if isinstance(names, list):
        names = dict(enumerate(names))
    d["names"] = names or {i: f"class{i}" for i in range(d.get("nc", 80))}
    d["nc"] = len(d["names"])
    for split in ("train", "val", "test"):
        if d.get(split):
            p = Path(d[split])
            d[split] = str(p if p.is_absolute() else base / p)
    return d


def xyxyxyxy2xywhr_np(corners: np.ndarray) -> np.ndarray:
    """(n, 4, 2) corner quads -> (n, 5) xywhr, r in radians [0, pi/2)
    (reference utils/ops.py:xyxyxyxy2xywhr, cv2.minAreaRect)."""
    if not len(corners):
        return np.zeros((0, 5), np.float32)
    out = []
    for pts in corners:
        (cx, cy), (w, h), angle = cv2.minAreaRect(pts.astype(np.float32))
        r = (angle / 180.0 * np.pi) % np.pi  # into [0, pi/2) with the
        if r >= np.pi / 2:                   # (w, h, r) == (h, w, r + pi/2) identity
            w, h, r = h, w, r - np.pi / 2
        out.append([cx, cy, w, h, r])
    return np.asarray(out, np.float32)


def img2label_path(img_path: str) -> str:
    """.../images/xxx.jpg -> .../labels/xxx.txt (the last 'images' part)."""
    p = Path(img_path)
    if "images" in p.parent.parts:
        parts = list(p.parts)
        idx = len(parts) - 1 - parts[::-1].index("images")
        parts[idx] = "labels"
        return str(Path(*parts).with_suffix(".txt"))
    return str(p.with_suffix(".txt"))


class YOLODataset:
    """Detection dataset over an image dir, list file or single image."""

    def __init__(self, img_path: str | Path, imgsz: int = 640, augment: bool = False,
                 hyp: dict | None = None, max_boxes: int = 128, nc: int = 80,
                 fraction: float = 1.0, task: str = "detect", cache_images: str | bool = False):
        if task not in ("detect", "obb"):
            not_ported(f"the {task!r} dataset", "ROADMAP Queue 1 item 12, the other tasks")
        if task == "obb" and augment:
            not_ported("OBB augmentation", "ROADMAP Queue 1 item 12, OBB training")
        self.imgsz = imgsz
        self.augment = augment
        self.hyp = hyp or {}
        self.max_boxes = max_boxes
        self.nc = nc
        self.task = task
        self.im_files = self._glob_images(img_path)
        if fraction < 1.0:
            self.im_files = self.im_files[: max(1, int(len(self.im_files) * fraction))]
        self.label_files = [img2label_path(f) for f in self.im_files]
        self.labels = self._load_labels()
        self.mosaic_enabled = self.augment and self.hyp.get("mosaic", 1.0) > 0
        # image cache (reference base.py:189-259): "ram" keeps each resized
        # decode in memory, "disk" writes it once to an npz sidecar
        self.cache_images = {True: "ram"}.get(cache_images, cache_images)
        if self.cache_images not in (False, None, "ram", "disk"):
            raise ValueError(f"cache={cache_images!r}: use False, True, 'ram' or 'disk'")
        self._ram: list = [None] * len(self.im_files)
        # rect validation: each image's letterbox target (h, w), from
        # set_rectangle; None letterboxes to the square imgsz
        self.rect_shapes: np.ndarray | None = None

    def set_rectangle(self, batch_size: int, nbuckets: int = 4, stride: int = 32,
                      pad: float = 0.5) -> list[np.ndarray]:
        """Rect validation in ``nbuckets`` static aspect-ratio buckets, as the
        JAX package batches it (its data/dataset.py set_rectangle): images
        sorted by h / w and split into contiguous groups, each letterboxed
        to one stride-aligned shape that covers its extreme ratio (the
        reference's ceil(shape * imgsz / stride + pad) * stride, base.py:
        261-284). Sets ``rect_shapes`` and returns the batch plan, whose
        batches never straddle a bucket."""
        n = len(self.im_files)
        ars = np.empty(n, np.float64)
        for i in range(n):
            _, (h0, w0) = self.load_image(i)
            ars[i] = h0 / w0
        order = np.argsort(ars)
        self.rect_shapes = np.full((n, 2), self.imgsz, np.int32)
        groups = np.array_split(order, max(1, min(nbuckets, n)))
        for g in groups:
            if not len(g):
                continue
            mini, maxi = float(ars[g].min()), float(ars[g].max())
            shape = [maxi, 1.0] if maxi < 1 else [1.0, 1.0 / mini] if mini > 1 else [1.0, 1.0]
            hw = np.ceil(np.array(shape) * self.imgsz / stride + pad).astype(int) * stride
            self.rect_shapes[g] = np.minimum(hw, self.imgsz)
        return [np.asarray(g[k:k + batch_size]) for g in groups
                for k in range(0, len(g), batch_size)]

    @staticmethod
    def _glob_images(img_path) -> list[str]:
        p = Path(img_path)
        files: list[str] = []
        if p.is_dir():
            files = [str(f) for f in sorted(p.rglob("*")) if f.suffix[1:].lower() in IMG_FORMATS]
        elif p.is_file() and p.suffix == ".txt":  # a file listing image paths
            root = p.parent
            for line in p.read_text().splitlines():
                line = line.strip()
                if line:
                    f = Path(line)
                    files.append(str(f if f.is_absolute() else (root / f).resolve()))
        elif p.is_file():
            files = [str(p)]
        if not files:
            raise FileNotFoundError(f"no images found in {img_path}")
        return files

    def _load_labels(self) -> list[dict]:
        labels = []
        n_missing = 0
        obb = self.task == "obb"
        for lf in self.label_files:
            rows = np.zeros((0, 5), np.float32)
            corners = np.zeros((0, 4, 2), np.float32)
            if Path(lf).exists():
                raw = [x.split() for x in Path(lf).read_text().splitlines() if x.strip()]
                if raw and obb:
                    # DOTA-style rows: cls x1 y1 x2 y2 x3 y3 x4 y4, normalised
                    # corners; rows keep their axis-aligned hull
                    vals = np.asarray(raw, np.float32)
                    corners = vals[:, 1:9].reshape(-1, 4, 2).clip(0, 1)
                    rows = np.stack([vals[:, 0], corners[..., 0].mean(-1), corners[..., 1].mean(-1),
                                     np.ptp(corners[..., 0], -1), np.ptp(corners[..., 1], -1)], -1)
                elif raw:
                    rows = np.asarray(raw, dtype=np.float32)[:, :5]
                    rows[:, 1:] = rows[:, 1:].clip(0, 1)
            else:
                n_missing += 1
            if len(rows) > 1:  # drop exact duplicates, keep the first, in order
                key = np.concatenate([rows, corners.reshape(len(rows), -1)], 1) if obb else rows
                _, keep = np.unique(key, axis=0, return_index=True)
                if len(keep) < len(rows):
                    keep = np.sort(keep)
                    rows = rows[keep]
                    corners = corners[keep] if obb else corners
            labels.append({"cls": rows[:, 0], "xywhn": rows[:, 1:5],
                           **({"corners": corners} if obb else {})})
        if n_missing:
            LOGGER.warning(f"{n_missing}/{len(self.im_files)} label files missing "
                           "(treated as background)")
        return labels

    def __len__(self):
        return len(self.im_files)

    def load_image(self, i: int):
        """BGR image with its long side resized to imgsz, and (h0, w0); from
        the cache when ``cache_images`` is set, always a fresh array."""
        if self.cache_images == "ram" and self._ram[i] is not None:
            im, shape0 = self._ram[i]
            return im.copy(), shape0
        npy = None
        if self.cache_images == "disk":
            # imgsz is in the name: a sidecar written at another imgsz holds
            # another resize and must not be served
            npy = Path(self.im_files[i]).with_suffix(f".yat{self.imgsz}.npz")
            if npy.exists():
                try:
                    z = np.load(npy)
                    return z["img"], tuple(int(v) for v in z["shape0"])
                except Exception:  # noqa: BLE001 - a stale or torn sidecar is decoded again
                    pass
        im = cv2.imread(self.im_files[i])
        if im is None:
            raise FileNotFoundError(f"image not found: {self.im_files[i]}")
        h0, w0 = im.shape[:2]
        r = self.imgsz / max(h0, w0)
        if r != 1:
            im = cv2.resize(
                im, (min(math.ceil(w0 * r), self.imgsz), min(math.ceil(h0 * r), self.imgsz)),
                interpolation=cv2.INTER_LINEAR)
        if self.cache_images == "ram":
            self._ram[i] = (im.copy(), (h0, w0))
        elif npy is not None:  # written whole, then renamed: loader threads share sidecars
            tmp = npy.with_name(f"{npy.name}.{os.getpid()}.{threading.get_ident()}")
            with open(tmp, "wb") as f:
                np.savez(f, img=im, shape0=np.asarray([h0, w0]))
            os.replace(tmp, npy)
        return im, (h0, w0)

    def load_item(self, i: int, with_shape: bool = False):
        """(img BGR resized, boxes xyxy px in resized coords, cls[, (h0, w0)])."""
        img, (h0, w0) = self.load_image(i)
        h, w = img.shape[:2]
        xywhn = self.labels[i]["xywhn"]
        if len(xywhn):
            cx, cy = xywhn[:, 0] * w, xywhn[:, 1] * h
            bw, bh = xywhn[:, 2] * w, xywhn[:, 3] * h
            boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
        else:
            boxes = np.zeros((0, 4), np.float32)
        out = (img, boxes.astype(np.float32), self.labels[i]["cls"].astype(np.float32))
        return (*out, (h0, w0)) if with_shape else out

    def _perspective(self, img, boxes, cls, rng, border):
        hyp = self.hyp
        return A.random_perspective(
            img, boxes, cls, rng, degrees=hyp.get("degrees", 0.0),
            translate=hyp.get("translate", 0.1), scale=hyp.get("scale", 0.5),
            shear=hyp.get("shear", 0.0), perspective=hyp.get("perspective", 0.0), border=border)

    def get_sample(self, i: int, rng: np.random.Generator | None = None,
                   mosaic: bool | None = None) -> dict:
        """The train or val transform pipeline for one index."""
        rng = rng or np.random.default_rng()
        if self.task == "obb":
            return self._get_obb_sample(i)
        hyp = self.hyp
        if mosaic is None:
            mosaic = self.mosaic_enabled and rng.random() < hyp.get("mosaic", 1.0)
        mosaic_border = (-self.imgsz // 2, -self.imgsz // 2)
        if self.augment and mosaic:
            idxs = [i] + list(rng.integers(0, len(self), 3))
            img, boxes, cls = A.mosaic4([self.load_item(j) for j in idxs], self.imgsz, rng)
            img, boxes, cls = self._perspective(img, boxes, cls, rng, mosaic_border)
            if hyp.get("mixup", 0.0) > 0 and rng.random() < hyp["mixup"]:
                j = int(rng.integers(0, len(self)))
                items2 = [self.load_item(k) for k in [j] + list(rng.integers(0, len(self), 3))]
                img2, boxes2, cls2 = A.mosaic4(items2, self.imgsz, rng)
                img2, boxes2, cls2 = self._perspective(img2, boxes2, cls2, rng, mosaic_border)
                img, boxes, cls = A.mixup(img, boxes, cls, img2, boxes2, cls2, rng)
            ori_shape = (self.imgsz, self.imgsz)
            ratio_pad = ((1.0, 1.0), (0.0, 0.0))
        else:
            img, boxes, cls, (h0, w0) = self.load_item(i, with_shape=True)
            r1 = img.shape[0] / h0  # long-side pre-resize factor
            target = (tuple(int(v) for v in self.rect_shapes[i])
                      if self.rect_shapes is not None else self.imgsz)
            img, ratio, pad = A.letterbox_np(img, target, scaleup=self.augment)
            boxes = A.apply_letterbox_to_boxes(boxes, ratio, pad) if len(boxes) else boxes
            if self.augment:
                img, boxes, cls = self._perspective(img, boxes, cls, rng, (0, 0))
            ori_shape = (h0, w0)
            # total original -> final gain and pad, for scale_boxes at val time
            ratio_pad = ((ratio[0] * r1, ratio[1] * r1), pad)

        if self.augment:
            img = A.extra_augment(np.ascontiguousarray(img), rng)
            A.augment_hsv(img, rng, hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7),
                          hyp.get("hsv_v", 0.4))
            if rng.random() < hyp.get("flipud", 0.0):
                img, boxes = A.flip_ud(img, boxes)
            if rng.random() < hyp.get("fliplr", 0.5):
                img, boxes = A.flip_lr(img, boxes)

        return {"img": np.ascontiguousarray(img), "bboxes": boxes.astype(np.float32),
                "cls": cls.astype(np.float32), "ori_shape": tuple(ori_shape),
                "ratio_pad": ratio_pad, "im_file": self.im_files[i % len(self)]}

    def _get_obb_sample(self, i: int) -> dict:
        """OBB val sample: the letterbox, with the corner quads moved with the
        image and then turned into xywhr px (cv2.minAreaRect, angle in
        [0, pi/2))."""
        img, _, cls, (h0, w0) = self.load_item(i, with_shape=True)
        r1 = img.shape[0] / h0
        h, w = img.shape[:2]
        corners = self.labels[i]["corners"] * np.asarray([w, h], np.float32)
        img, ratio, pad = A.letterbox_np(img, self.imgsz, scaleup=False)
        corners = corners * ratio[0] + np.asarray(pad, np.float32)
        return {"img": np.ascontiguousarray(img),
                "bboxes": xyxyxyxy2xywhr_np(corners).astype(np.float32),
                "cls": cls.astype(np.float32), "ori_shape": (h0, w0),
                "ratio_pad": ((ratio[0] * r1, ratio[1] * r1), pad),
                "im_file": self.im_files[i % len(self)]}
