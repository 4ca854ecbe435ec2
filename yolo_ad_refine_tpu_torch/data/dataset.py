"""YOLO-format detection dataset (host-side numpy + cv2).

Counterpart of ``yolo_ad_refine_tpu/data/dataset.py`` for ``task="detect"``
(reference ultralytics/data/base.py:21, dataset.py:45, data/utils.py:254):
images are globbed, YOLO txt labels parsed (exact duplicate rows dropped),
each image resized so its long side is imgsz (ceil, base.py:171), and
``get_sample`` runs the train pipeline (mosaic, perspective, mixup, extras,
HSV, flips) or the val letterbox, drawing from the given generator in the
JAX package's order. Samples: img uint8 HWC BGR, bboxes (n, 4) xyxy px,
cls (n,), ori_shape, ratio_pad, im_file.
"""

from __future__ import annotations

import math
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
        if task != "detect":
            not_ported(f"the {task!r} dataset", "ROADMAP Queue 1 item 12, the other tasks")
        if cache_images:
            not_ported("image caching (cache=ram/disk)", "ROADMAP Queue 1 item 9, data")
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
        for lf in self.label_files:
            rows = np.zeros((0, 5), np.float32)
            if Path(lf).exists():
                raw = [x.split() for x in Path(lf).read_text().splitlines() if x.strip()]
                if raw:
                    rows = np.asarray(raw, dtype=np.float32)[:, :5]
                    rows[:, 1:] = rows[:, 1:].clip(0, 1)
            else:
                n_missing += 1
            if len(rows) > 1:  # drop exact duplicates, keep the first, in order
                _, keep = np.unique(rows, axis=0, return_index=True)
                if len(keep) < len(rows):
                    rows = rows[np.sort(keep)]
            labels.append({"cls": rows[:, 0], "xywhn": rows[:, 1:5]})
        if n_missing:
            LOGGER.warning(f"{n_missing}/{len(self.im_files)} label files missing "
                           "(treated as background)")
        return labels

    def __len__(self):
        return len(self.im_files)

    def load_image(self, i: int):
        """BGR image with its long side resized to imgsz, and (h0, w0)."""
        im = cv2.imread(self.im_files[i])
        if im is None:
            raise FileNotFoundError(f"image not found: {self.im_files[i]}")
        h0, w0 = im.shape[:2]
        r = self.imgsz / max(h0, w0)
        if r != 1:
            im = cv2.resize(
                im, (min(math.ceil(w0 * r), self.imgsz), min(math.ceil(h0 * r), self.imgsz)),
                interpolation=cv2.INTER_LINEAR)
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
            img, ratio, pad = A.letterbox_np(img, self.imgsz, scaleup=self.augment)
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
