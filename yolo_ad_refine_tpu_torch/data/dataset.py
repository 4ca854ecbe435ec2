"""YOLO-format detection dataset (host-side numpy + cv2).

Counterpart of ``yolo_ad_refine_tpu/data/dataset.py`` for the detect, OBB,
segment and pose tasks (reference ultralytics/data/base.py:21, dataset.py:45,
data/utils.py:254): images are globbed, YOLO txt labels parsed (exact
duplicate rows dropped), each image resized so its long side is imgsz
(ceil, base.py:171), and ``get_sample`` runs the train pipeline (mosaic,
perspective, mixup, extras, HSV, flips) or the val letterbox, drawing from
the given generator in the JAX package's order. Samples: img uint8 HWC
BGR, bboxes (n, 4) xyxy px (OBB: (n, 5) xywhr px from DOTA-style corner
rows), cls (n,), ori_shape, ratio_pad, im_file; segment adds
``segments``, the (P, 2) pixel polygons of the rows ``cls x1 y1 x2 y2 ...``
(the boxes their extents), and pose ``keypoints`` (n, K, 3) pixels with
the visibility last, from the rows ``cls cx cy w h (kx ky [kv]) * K``
(``kpt_shape`` inferred from the row width when not given; without
``flip_idx`` no left-right flip). OBB trains with the letterbox, HSV and
a flip of the corner quads (no mosaic, as in the JAX package); segment
with mosaic, CopyPaste (flip mode), the perspective warp of the polygons,
HSV and a flip; pose with the letterbox, HSV and a flip that swaps the
joints by ``flip_idx``. Labels are parsed on each construction (the JAX
package's label cache, keyed by the task, is not ported). ``cache_images`` keeps the
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
from yolo_ad_refine_tpu_torch.utils import LOGGER, yaml_load

TASKS = ("detect", "obb", "segment", "pose")


def check_task(task: str, classify_entry: str) -> None:
    """Raise ValueError for a task the detection engine does not run:
    classify, which runs through ``train/classify.py`` ``classify_entry``,
    and a task name the port does not know."""
    if task == "classify":
        raise ValueError(
            f"task 'classify' runs through train/classify.py {classify_entry}, not here: "
            "YOLO(<a Classify model>).train / .val (data=<a class-folder dir>) hand the "
            "model to it")
    if task not in TASKS:
        raise ValueError(
            f"unknown task {task!r}: the port's detection engine takes {', '.join(TASKS)} "
            "(YOLOv10, YOLO-World and RT-DETR models are 'detect')")


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
    """Detection dataset over an image dir, list file or single image.

    The parameters are the JAX package's, in its order. ``cache`` is its
    label-cache switch (a ``.yat_labels_<hash>.npz`` beside the images);
    the port keeps no label cache and parses the label files at each
    construction, whatever ``cache`` says. ``cache_images`` is the image
    cache ("ram" or "disk")."""

    def __init__(self, img_path: str | Path, imgsz: int = 640, augment: bool = False,
                 hyp: dict | None = None, max_boxes: int = 128, nc: int = 80,
                 fraction: float = 1.0, cache: bool = True, task: str = "detect",
                 kpt_shape: tuple | None = None, flip_idx: list | None = None,
                 cache_images: str | bool = False):
        check_task(task, "ClassificationDataset")
        self.imgsz = imgsz
        # pose: the (K, ndim) keypoint layout, inferred from the label rows when
        # None; flip_idx is each keypoint's mirror, without which no fliplr
        self.kpt_shape = tuple(kpt_shape) if kpt_shape else None
        self.flip_idx = list(flip_idx) if flip_idx else None
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

    def _parse_rows(self, raw: list[list[str]]):
        """(rows (n, 5) [cls, cx, cy, w, h] normalised, extra) of one label
        file's rows; extra is the task's: corners (n, 4, 2), polygons
        [(P, 2)] or keypoints (n, K, 3), all normalised."""
        if self.task == "obb":
            # DOTA-style rows: cls x1 y1 x2 y2 x3 y3 x4 y4, normalised corners;
            # rows keep their axis-aligned hull
            vals = np.asarray(raw, np.float32)
            corners = vals[:, 1:9].reshape(-1, 4, 2).clip(0, 1)
            return np.stack([vals[:, 0], corners[..., 0].mean(-1), corners[..., 1].mean(-1),
                             np.ptp(corners[..., 0], -1), np.ptp(corners[..., 1], -1)], -1), \
                corners
        if self.task == "pose":
            if self.kpt_shape is None:  # from the first labelled file's row width
                extra = len(raw[0]) - 5
                self.kpt_shape = (extra // 3, 3) if extra % 3 == 0 else (extra // 2, 2)
            nk, ndim = self.kpt_shape
            vals = np.asarray(raw, np.float32)
            rows = vals[:, :5]
            rows[:, 1:] = rows[:, 1:].clip(0, 1)
            k = vals[:, 5:5 + nk * ndim].reshape(-1, nk, ndim)
            if ndim == 2:  # no visibility flag: every keypoint visible
                k = np.concatenate([k, np.ones((*k.shape[:2], 1), np.float32)], -1)
            return rows, k
        if self.task == "segment" and any(len(r) > 5 for r in raw):
            polys, rows = [], []
            for r in raw:
                vals = np.asarray(r, np.float32)
                poly = vals[1:].reshape(-1, 2).clip(0, 1)
                polys.append(poly)
                (x1, y1), (x2, y2) = poly.min(0), poly.max(0)
                rows.append([vals[0], (x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1])
            return np.asarray(rows, np.float32), polys
        rows = np.asarray(raw, dtype=np.float32)[:, :5]
        rows[:, 1:] = rows[:, 1:].clip(0, 1)
        return rows, None

    def _load_labels(self) -> list[dict]:
        labels = []
        n_missing = 0
        for lf in self.label_files:
            rows, extra = np.zeros((0, 5), np.float32), None
            if Path(lf).exists():
                raw = [x.split() for x in Path(lf).read_text().splitlines() if x.strip()]
                if raw:
                    rows, extra = self._parse_rows(raw)
            else:
                n_missing += 1
            if len(rows) > 1:  # drop exact duplicates, keep the first, in order
                key = (np.concatenate([rows, extra.reshape(len(rows), -1)], 1)
                       if self.task in ("obb", "pose") else rows)
                _, keep = np.unique(key, axis=0, return_index=True)
                if len(keep) < len(rows):
                    keep = np.sort(keep)
                    rows = rows[keep]
                    if extra is not None:
                        extra = ([extra[k] for k in keep] if isinstance(extra, list)
                                 else extra[keep])
            lab = {"cls": rows[:, 0], "xywhn": rows[:, 1:5]}
            if self.task == "obb":
                lab["corners"] = extra if extra is not None else np.zeros((0, 4, 2), np.float32)
            elif self.task == "segment":
                lab["segments"] = extra or []
            elif self.task == "pose":
                nk = self.kpt_shape[0] if self.kpt_shape else 0
                lab["keypoints"] = (extra if extra is not None
                                    else np.zeros((len(rows), nk, 3), np.float32))
            labels.append(lab)
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
        hyp = self.hyp
        if mosaic is None:  # drawn for every task, as the JAX package draws it
            mosaic = self.mosaic_enabled and rng.random() < hyp.get("mosaic", 1.0)
        if self.task == "segment":  # which draws its own mosaic, as in the JAX package
            return self._get_segment_sample(i, rng)
        if self.task == "pose":
            return self._get_pose_sample(i, rng)
        if self.task == "obb":  # no mosaic for OBB, as in the JAX package
            return self._get_obb_sample(i, rng)
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

    def _get_obb_sample(self, i: int, rng: np.random.Generator) -> dict:
        """OBB sample (the JAX package's ``_get_obb_sample``): the letterbox
        (scaled up only when augmenting), then with ``augment`` HSV and a
        left-right flip of the image and its corner quads, drawn from
        ``rng`` in that order; the quads then become xywhr px
        (cv2.minAreaRect, angle in [0, pi/2))."""
        img, _, cls, (h0, w0) = self.load_item(i, with_shape=True)
        r1 = img.shape[0] / h0
        h, w = img.shape[:2]
        corners = self.labels[i]["corners"] * np.asarray([w, h], np.float32)
        img, ratio, pad = A.letterbox_np(img, self.imgsz, scaleup=self.augment)
        corners = corners * ratio[0] + np.asarray(pad, np.float32)
        if self.augment:
            img = np.ascontiguousarray(img)
            A.augment_hsv(img, rng, self.hyp.get("hsv_h", 0.015), self.hyp.get("hsv_s", 0.7),
                          self.hyp.get("hsv_v", 0.4))
            if rng.random() < self.hyp.get("fliplr", 0.5):
                img = np.ascontiguousarray(np.fliplr(img))
                corners[..., 0] = img.shape[1] - corners[..., 0]
        return {"img": np.ascontiguousarray(img),
                "bboxes": xyxyxyxy2xywhr_np(corners).astype(np.float32),
                "cls": cls.astype(np.float32), "ori_shape": (h0, w0),
                "ratio_pad": ((ratio[0] * r1, ratio[1] * r1), pad),
                "im_file": self.im_files[i % len(self)]}

    def _get_pose_sample(self, i: int, rng: np.random.Generator) -> dict:
        """Pose sample (the JAX package's ``_get_pose_sample``): the
        letterbox (scaled up only when augmenting), keypoints moved with the
        boxes and the invisible ones zeroed; with ``augment`` HSV and, only
        with ``flip_idx``, a left-right flip that swaps the joints (a person
        mirrored without the swap is wrong GT), drawn from ``rng``."""
        img, boxes, cls, (h0, w0) = self.load_item(i, with_shape=True)
        r1 = img.shape[0] / h0
        h, w = img.shape[:2]
        kpts = self.labels[i]["keypoints"].copy()  # (n, K, 3) normalised
        if len(kpts):
            kpts[..., 0] *= w
            kpts[..., 1] *= h
        img, ratio, pad = A.letterbox_np(img, self.imgsz, scaleup=self.augment)
        boxes = boxes * ratio[0] + np.asarray([*pad, *pad], np.float32)
        if len(kpts):
            vis = kpts[..., 2:] > 0
            kpts[..., :2] = (kpts[..., :2] * ratio[0] + np.asarray(pad, np.float32)) * vis
        if self.augment:
            img = np.ascontiguousarray(img)
            A.augment_hsv(img, rng, self.hyp.get("hsv_h", 0.015), self.hyp.get("hsv_s", 0.7),
                          self.hyp.get("hsv_v", 0.4))
            if self.flip_idx is not None and rng.random() < self.hyp.get("fliplr", 0.5):
                img = np.ascontiguousarray(np.fliplr(img))
                if len(boxes):
                    boxes = np.stack([img.shape[1] - boxes[:, 2], boxes[:, 1],
                                      img.shape[1] - boxes[:, 0], boxes[:, 3]], -1)
                if len(kpts):
                    kpts = kpts[:, self.flip_idx]
                    vis = kpts[..., 2:] > 0
                    kpts[..., 0] = (img.shape[1] - kpts[..., 0]) * vis[..., 0]
        return {"img": np.ascontiguousarray(img), "bboxes": boxes.astype(np.float32),
                "cls": cls.astype(np.float32), "keypoints": kpts.astype(np.float32),
                "ori_shape": (h0, w0), "ratio_pad": ((ratio[0] * r1, ratio[1] * r1), pad),
                "im_file": self.im_files[i % len(self)]}

    def _load_segment_item(self, i: int):
        """(img resized, polygons in its pixels, cls), a mosaic tile."""
        img, _, cls = self.load_item(i)
        h, w = img.shape[:2]
        return img, [s * np.asarray([w, h], np.float32) for s in self.labels[i]["segments"]], cls

    def _get_segment_sample(self, i: int, rng: np.random.Generator) -> dict:
        """Segment sample (the JAX package's ``_get_segment_sample``). Train:
        with the mosaic drawn (again) from ``rng``, mosaic4 of polygons,
        CopyPaste, the warp (the reference's order), HSV and a flip; else
        the letterbox, with ``augment`` CopyPaste, HSV and a flip. The boxes
        are the final polygons' extents."""
        hyp = self.hyp
        flip = lambda im, segs: (np.ascontiguousarray(np.fliplr(im)),  # noqa: E731
                                 [np.stack([im.shape[1] - s[:, 0], s[:, 1]], -1) for s in segs])
        if self.augment and self.mosaic_enabled and rng.random() < hyp.get("mosaic", 1.0):
            items = [self._load_segment_item(j) for j in [i] + list(rng.integers(0, len(self), 3))]
            img, segments, cls = A.mosaic4_segments(items, self.imgsz, rng)
            img, segments, cls = A.copy_paste_flip(img, segments, cls, hyp.get("copy_paste", 0.0),
                                                   rng)
            img, segments, cls = A.random_perspective_segments(
                img, segments, cls, rng, degrees=hyp.get("degrees", 0.0),
                translate=hyp.get("translate", 0.1), scale=hyp.get("scale", 0.5),
                shear=hyp.get("shear", 0.0), perspective=hyp.get("perspective", 0.0),
                border=(-self.imgsz // 2, -self.imgsz // 2))
            img = np.ascontiguousarray(img)
            A.augment_hsv(img, rng, hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7),
                          hyp.get("hsv_v", 0.4))
            if rng.random() < hyp.get("fliplr", 0.5):
                img, segments = flip(img, segments)
            ori_shape, ratio_pad = (self.imgsz, self.imgsz), ((1.0, 1.0), (0.0, 0.0))
        else:
            img, _, cls, (h0, w0) = self.load_item(i, with_shape=True)
            r1 = img.shape[0] / h0
            h, w = img.shape[:2]
            segments = [s * np.asarray([w, h], np.float32) for s in self.labels[i]["segments"]]
            img, ratio, pad = A.letterbox_np(img, self.imgsz, scaleup=self.augment)
            segments = [s * ratio[0] + np.asarray(pad, np.float32) for s in segments]
            if self.augment:
                img, segments, cls = A.copy_paste_flip(np.ascontiguousarray(img), segments, cls,
                                                       hyp.get("copy_paste", 0.0), rng)
                A.augment_hsv(img, rng, hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7),
                              hyp.get("hsv_v", 0.4))
                if rng.random() < hyp.get("fliplr", 0.5):
                    img, segments = flip(img, segments)
            ori_shape, ratio_pad = (h0, w0), ((ratio[0] * r1, ratio[1] * r1), pad)
        return {"img": np.ascontiguousarray(img), "bboxes": A.polygon_boxes(segments),
                "cls": np.asarray(cls, np.float32), "segments": segments,
                "ori_shape": ori_shape, "ratio_pad": ratio_pad,
                "im_file": self.im_files[i % len(self)]}
