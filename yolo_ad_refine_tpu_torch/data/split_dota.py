"""DOTA image tiling for OBB training (reference data/split_dota.py).

Large aerial scenes are cut into overlapping crop windows; each window keeps
the oriented boxes whose polygon lies mostly inside it (intersection over
foreground >= iof_thr), with corner coordinates re-normalized to the window.

Mirrors: get_windows (split_dota.py:97), bbox_iof (:20), get_window_obj
(:141), crop_and_save (:155), split_trainval (:230), split_test (:260).
Host-side numpy/cv2 only.

Counterpart of ``yolo_ad_refine_tpu/data/split_dota.py``: the same host code.
"""

from __future__ import annotations

import itertools
from pathlib import Path

import numpy as np

from yolo_ad_refine_tpu_torch.utils import LOGGER


def bbox_iof(polygon1: np.ndarray, bbox2: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Intersection over foreground between (N, 8) polygons and (M, 4) xyxy
    windows, polygon area approximated by the shoelace formula
    (reference split_dota.py:20-61)."""
    polygon1 = polygon1.reshape(-1, 4, 2)
    lt = np.minimum(polygon1.min(1), 1e9)[:, None]  # (N, 1, 2)
    rb = np.maximum(polygon1.max(1), -1e9)[:, None]
    lt_w = np.maximum(lt, bbox2[None, :, :2])
    rb_w = np.minimum(rb, bbox2[None, :, 2:])
    wh = np.clip(rb_w - lt_w, 0, None)
    inter = wh[..., 0] * wh[..., 1]  # AABB-approx intersection (N, M)
    x, y = polygon1[..., 0], polygon1[..., 1]
    area1 = 0.5 * np.abs(
        (x * np.roll(y, -1, axis=1) - np.roll(x, -1, axis=1) * y).sum(1)
    )[:, None]
    return inter / (area1 + eps)


def get_windows(im_size: tuple, crop_sizes=(1024,), gaps=(200,),
                im_rate_thr: float = 0.6, eps: float = 0.01) -> np.ndarray:
    """Sliding-window layout over an (h, w) image; windows whose in-image area
    fraction < im_rate_thr are dropped unless none qualify
    (reference split_dota.py:97-139)."""
    h, w = im_size
    windows = []
    for crop_size, gap in zip(crop_sizes, gaps):
        if crop_size <= gap:
            raise ValueError(f"invalid crop_size gap pair [{crop_size} {gap}]")
        step = crop_size - gap

        xn = 1 if w <= crop_size else int(np.ceil((w - crop_size) / step + 1))
        xs = [step * i for i in range(xn)]
        if len(xs) > 1 and xs[-1] + crop_size > w:
            xs[-1] = w - crop_size
        yn = 1 if h <= crop_size else int(np.ceil((h - crop_size) / step + 1))
        ys = [step * i for i in range(yn)]
        if len(ys) > 1 and ys[-1] + crop_size > h:
            ys[-1] = h - crop_size

        start = np.array(list(itertools.product(xs, ys)), dtype=np.int64)
        stop = start + crop_size
        windows.append(np.concatenate([start, stop], axis=1))
    windows = np.concatenate(windows, axis=0)

    im_in_wins = windows.copy()
    im_in_wins[:, 0::2] = np.clip(im_in_wins[:, 0::2], 0, w)
    im_in_wins[:, 1::2] = np.clip(im_in_wins[:, 1::2], 0, h)
    im_areas = (im_in_wins[:, 2] - im_in_wins[:, 0]) * (im_in_wins[:, 3] - im_in_wins[:, 1])
    win_areas = (windows[:, 2] - windows[:, 0]) * (windows[:, 3] - windows[:, 1])
    im_rates = im_areas / win_areas
    if not (im_rates > im_rate_thr).any():
        im_rates[im_rates == im_rates.max()] = 1.0
    return windows[im_rates > im_rate_thr]


def load_yolo_dota(data_root: str | Path, split: str = "train") -> list[dict]:
    """Collect {im_file, label (cls + 8 normalized corners), ori_size} records
    (reference split_dota.py:64-95)."""
    import cv2

    data_root = Path(data_root)
    im_dir = data_root / "images" / split
    lb_dir = data_root / "labels" / split
    annos = []
    for im_file in sorted(im_dir.iterdir()):
        if im_file.suffix.lower() not in {".png", ".jpg", ".jpeg", ".bmp", ".tif"}:
            continue
        im = cv2.imread(str(im_file))
        if im is None:
            continue
        h, w = im.shape[:2]
        lb_file = lb_dir / f"{im_file.stem}.txt"
        if lb_file.exists():
            rows = [x.split() for x in lb_file.read_text().splitlines() if x.strip()]
            lb = np.array(rows, dtype=np.float32) if rows else np.zeros((0, 9), np.float32)
        else:
            lb = np.zeros((0, 9), np.float32)
        annos.append({"ori_size": (h, w), "label": lb, "filepath": str(im_file)})
    return annos


def crop_and_save(anno: dict, windows: np.ndarray, window_objs: list,
                  im_dir: Path, lb_dir: Path, allow_background_images: bool = True):
    """Write each window crop + its re-normalized label file
    (reference split_dota.py:155-198)."""
    import cv2

    im = cv2.imread(anno["filepath"])
    name = Path(anno["filepath"]).stem
    for i, window in enumerate(windows):
        x_start, y_start, x_stop, y_stop = window.tolist()
        new_name = f"{name}__{x_stop - x_start}__{x_start}___{y_start}"
        patch_im = im[y_start:y_stop, x_start:x_stop]
        ph, pw = patch_im.shape[:2]
        label = window_objs[i]
        if len(label) == 0 and not allow_background_images:
            continue
        cv2.imwrite(str(im_dir / f"{new_name}.jpg"), patch_im)
        if len(label):
            label = label.copy()
            label[:, 1::2] -= x_start
            label[:, 2::2] -= y_start
            label[:, 1::2] /= pw
            label[:, 2::2] /= ph
            lines = [
                f"{int(r[0])} " + " ".join(f"{c:.6g}" for c in r[1:]) for r in label
            ]
            (lb_dir / f"{new_name}.txt").write_text("\n".join(lines) + "\n")
        else:
            (lb_dir / f"{new_name}.txt").write_text("")


def split_images_and_labels(data_root, save_dir, split: str = "train",
                            crop_sizes=(1024,), gaps=(200,), iof_thr: float = 0.7):
    """Tile one split (reference split_dota.py:200-258 split_images_and_labels
    + get_window_obj)."""
    save_dir = Path(save_dir)
    im_dir = save_dir / "images" / split
    lb_dir = save_dir / "labels" / split
    im_dir.mkdir(parents=True, exist_ok=True)
    lb_dir.mkdir(parents=True, exist_ok=True)

    for anno in load_yolo_dota(data_root, split):
        h, w = anno["ori_size"]
        windows = get_windows((h, w), crop_sizes, gaps)
        label = anno["label"]
        if len(label):
            # denormalize corners to px for window matching
            label = label.copy()
            label[:, 1::2] *= w
            label[:, 2::2] *= h
            iof = bbox_iof(label[:, 1:], windows.astype(np.float64))
            window_objs = [label[iof[:, i] >= iof_thr] for i in range(len(windows))]
        else:
            window_objs = [np.zeros((0, 9), np.float32)] * len(windows)
        crop_and_save(anno, windows, window_objs, im_dir, lb_dir)
    LOGGER.info(f"split_dota: {split} -> {save_dir}")


def split_trainval(data_root, save_dir, crop_size: int = 1024, gap: int = 200,
                   rates=(1.0,)):
    """Tile train+val at one or more scales (reference split_dota.py:230-258)."""
    crop_sizes = [int(crop_size / r) for r in rates]
    gaps = [int(gap / r) for r in rates]
    for split in ("train", "val"):
        split_images_and_labels(data_root, save_dir, split, crop_sizes, gaps)
