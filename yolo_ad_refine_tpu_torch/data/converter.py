"""Dataset conversion tooling.

Parity surface: reference ultralytics/data/converter.py — convert_coco:221
(COCO json -> YOLO txt, bbox/segment/keypoint rows), coco91_to_coco80_class:19,
merge_multi_segment:530 (multi-part polygons joined through nearest points),
convert_dota_to_yolo_obb:419, yolo_bbox2segment:580 (SAM-based; here a
documented box->rectangle fallback since SAM weights are unavailable in the
zero-egress build environment).

All of it is host-side numpy/json file wrangling — no device code.

Counterpart of ``yolo_ad_refine_tpu/data/converter.py``: the same host code.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import numpy as np

from yolo_ad_refine_tpu_torch.utils import LOGGER


def coco91_to_coco80_class() -> list:
    """Map the 91 COCO-paper class ids to the 80 trained ids
    (reference converter.py:19-119)."""
    return [
        0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, None, 11, 12, None, 13, 14, 15, 16, 17, 18,
        19, 20, 21, 22, 23, None, 24, 25, None, None, 26, 27, 28, 29, 30, 31, 32, 33,
        34, 35, 36, 37, 38, 39, None, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
        52, 53, 54, 55, 56, 57, 58, 59, None, 60, None, None, 61, None, 62, 63, 64, 65,
        66, 67, 68, 69, 70, 71, 72, None, 73, 74, 75, 76, 77, 78, 79, None,
    ]


def min_index(arr1: np.ndarray, arr2: np.ndarray):
    """Index pair of the closest points between two (N, 2) arrays
    (reference converter.py:515-528)."""
    dis = ((arr1[:, None, :] - arr2[None, :, :]) ** 2).sum(-1)
    return np.unravel_index(np.argmin(dis, axis=None), dis.shape)


def merge_multi_segment(segments: list) -> list:
    """Join multi-part polygons through their mutually closest points so one
    connected polygon represents the instance (reference converter.py:530-578)."""
    s = []
    segments = [np.array(seg).reshape(-1, 2) for seg in segments]
    idx_list = [[] for _ in range(len(segments))]
    for i in range(1, len(segments)):
        idx1, idx2 = min_index(segments[i - 1], segments[i])
        idx_list[i - 1].append(idx1)
        idx_list[i].append(idx2)
    for k in range(2):
        if k == 0:
            for i, idx in enumerate(idx_list):
                if len(idx) == 2 and idx[0] > idx[1]:
                    idx = idx[::-1]
                    segments[i] = segments[i][::-1, :]
                segments[i] = np.roll(segments[i], -idx[0], axis=0)
                segments[i] = np.concatenate([segments[i], segments[i][:1]])
                if i in {0, len(idx_list) - 1}:
                    s.append(segments[i])
                else:
                    idx = [0, idx[1] - idx[0]]
                    s.append(segments[i][idx[0] : idx[1] + 1])
        else:
            for i in range(len(idx_list) - 1, -1, -1):
                if i not in {0, len(idx_list) - 1}:
                    idx = idx_list[i]
                    nidx = abs(idx[1] - idx[0])
                    s.append(segments[i][nidx:])
    return s


def convert_coco(labels_dir: str | Path, save_dir: str | Path,
                 use_segments: bool = False, use_keypoints: bool = False,
                 cls91to80: bool = True) -> Path:
    """COCO instances json(s) -> YOLO txt labels (reference converter.py:221-339).

    Reads every ``*.json`` under labels_dir; writes
    ``save_dir/labels/<json-stem>/<image>.txt`` with
    ``cls cx cy w h [poly... | kpts...]`` normalized rows.
    """
    save_dir = Path(save_dir)
    coco80 = coco91_to_coco80_class()
    for json_file in sorted(Path(labels_dir).resolve().glob("*.json")):
        lname = json_file.stem.replace("instances_", "")
        fn = save_dir / "labels" / lname
        fn.mkdir(parents=True, exist_ok=True)
        data = json.loads(json_file.read_text())

        images = {f"{x['id']:d}": x for x in data["images"]}
        ann_by_img = defaultdict(list)
        for ann in data["annotations"]:
            ann_by_img[ann["image_id"]].append(ann)

        for img_id, anns in ann_by_img.items():
            img = images[f"{img_id:d}"]
            h, w = img["height"], img["width"]
            f = img["file_name"].split("/")[-1]

            bboxes, segments, keypoints = [], [], []
            for ann in anns:
                if ann.get("iscrowd", False):
                    continue
                # COCO box is top-left xywh -> normalized center xywh
                box = np.array(ann["bbox"], dtype=np.float64)
                box[:2] += box[2:] / 2
                box[[0, 2]] /= w
                box[[1, 3]] /= h
                if box[2] <= 0 or box[3] <= 0:
                    continue
                cls = (coco80[ann["category_id"] - 1] if cls91to80
                       else ann["category_id"] - 1)
                if cls is None:
                    continue
                row = [cls] + box.tolist()
                if row in bboxes:
                    continue
                bboxes.append(row)
                if use_segments and ann.get("segmentation") is not None:
                    seg = ann["segmentation"]
                    if len(seg) == 0:
                        segments.append([])
                    elif isinstance(seg, dict):  # RLE unsupported without pycocotools
                        segments.append([])
                    elif len(seg) > 1:
                        merged = np.concatenate(merge_multi_segment(seg), axis=0)
                        segments.append(
                            [cls] + (merged / np.array([w, h])).reshape(-1).tolist()
                        )
                    else:
                        merged = np.array(seg[0]).reshape(-1, 2)
                        segments.append(
                            [cls] + (merged / np.array([w, h])).reshape(-1).tolist()
                        )
                if use_keypoints and ann.get("keypoints") is not None:
                    k = np.array(ann["keypoints"], dtype=np.float64).reshape(-1, 3)
                    k[:, 0] /= w
                    k[:, 1] /= h
                    keypoints.append(row + k.reshape(-1).tolist())

            with open(fn / Path(f).with_suffix(".txt").name, "w") as file:
                for i in range(len(bboxes)):
                    if use_keypoints:
                        line = keypoints[i]
                    elif use_segments and i < len(segments) and len(segments[i]) > 0:
                        line = segments[i]
                    else:
                        line = bboxes[i]
                    file.write(("%g " * len(line)).rstrip() % tuple(line) + "\n")
        LOGGER.info(f"convert_coco: {json_file.name} -> {fn}")
    return save_dir


def convert_dota_to_yolo_obb(dota_root: str | Path, class_names: list | None = None):
    """DOTA txt (x1 y1 ... x4 y4 name difficulty) -> YOLO OBB rows
    (cls + 8 normalized corner coords) (reference converter.py:419-513)."""
    import cv2

    dota_root = Path(dota_root)
    names = class_names or [
        "plane", "ship", "storage tank", "baseball diamond", "tennis court",
        "basketball court", "ground track field", "harbor", "bridge",
        "large vehicle", "small vehicle", "helicopter", "roundabout",
        "soccer ball field", "swimming pool",
    ]
    name_to_id = {n: i for i, n in enumerate(names)}
    for phase in ("train", "val"):
        img_dir = dota_root / "images" / phase
        orig_dir = dota_root / "labels" / f"{phase}_original"
        save_dir = dota_root / "labels" / phase
        if not orig_dir.exists():
            continue
        save_dir.mkdir(parents=True, exist_ok=True)
        for img_path in sorted(img_dir.iterdir()):
            if img_path.suffix.lower() not in {".png", ".jpg", ".jpeg", ".bmp", ".tif"}:
                continue
            im = cv2.imread(str(img_path))
            if im is None:
                continue
            h, w = im.shape[:2]
            src = orig_dir / f"{img_path.stem}.txt"
            out_lines = []
            if src.exists():
                for line in src.read_text().splitlines():
                    parts = line.split()
                    if len(parts) < 9:
                        continue
                    cls_name = " ".join(parts[8:-1]) if len(parts) > 9 else parts[8]
                    if cls_name not in name_to_id:
                        continue
                    coords = np.asarray(parts[:8], np.float64)
                    coords[0::2] /= w
                    coords[1::2] /= h
                    out_lines.append(
                        f"{name_to_id[cls_name]} " + " ".join(f"{c:.6g}" for c in coords)
                    )
            (save_dir / f"{img_path.stem}.txt").write_text("\n".join(out_lines) + "\n")
        LOGGER.info(f"convert_dota_to_yolo_obb: {phase} -> {save_dir}")
    return dota_root
