"""Auto-annotation: generate YOLO txt labels from a detection model.

Parity surface: reference data/annotator.py auto_annotate (det model -> SAM
polygon labels). SAM weights are unavailable in this zero-egress build, so
the segmentation stage degrades explicitly: with a segment-task model the
predicted mask contours become polygons; with a detect model the output is
box rows. The call signature mirrors the reference.

Counterpart of ``yolo_ad_refine_tpu/data/annotator.py``, through the port's
``YOLO`` facade (whose predict runs on the model's device: K1 and K4 on
the card).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from yolo_ad_refine_tpu_torch.utils import LOGGER


def auto_annotate(data: str | Path, det_model, output_dir: str | Path | None = None,
                  conf: float = 0.25, imgsz: int = 640) -> Path:
    """Annotate every image under ``data`` with ``det_model`` predictions.

    det_model: a YOLO facade instance (detect or segment task). Writes one
    ``<stem>.txt`` per image: segment-task models emit polygon rows
    (cls x1 y1 x2 y2 ...), detect models emit box rows (cls cx cy w h),
    both normalized — the reference's output format (annotator.py:44-54).
    """
    import cv2

    data = Path(data)
    output_dir = Path(output_dir) if output_dir else data.parent / f"{data.stem}_auto_annotate_labels"
    output_dir.mkdir(parents=True, exist_ok=True)

    images = sorted(
        p for p in (data.iterdir() if data.is_dir() else [data])
        if p.suffix[1:].lower() in {"jpg", "jpeg", "png", "bmp", "webp", "tiff"}
    )
    for im_path in images:
        im = cv2.imread(str(im_path))
        if im is None:
            continue
        h, w = im.shape[:2]
        results = det_model.predict(str(im_path), conf=conf, imgsz=imgsz,
                                    save=False, verbose=False)
        lines = []
        for r in results:
            boxes = getattr(r, "boxes", None)
            masks = getattr(r, "masks", None)
            if masks is not None and getattr(masks, "xy", None):
                for cls_i, poly in zip(boxes.cls, masks.xy):
                    poly = np.asarray(poly, np.float64)
                    if len(poly) < 3:
                        continue
                    norm = (poly / np.array([w, h])).reshape(-1)
                    lines.append(f"{int(cls_i)} " + " ".join(f"{c:.6g}" for c in norm))
            elif boxes is not None and len(boxes):
                xyxy = np.asarray(boxes.xyxy, np.float64)
                for cls_i, b in zip(np.asarray(boxes.cls), xyxy):
                    cx, cy = (b[0] + b[2]) / 2 / w, (b[1] + b[3]) / 2 / h
                    bw, bh = (b[2] - b[0]) / w, (b[3] - b[1]) / h
                    lines.append(f"{int(cls_i)} {cx:.6g} {cy:.6g} {bw:.6g} {bh:.6g}")
        (output_dir / f"{im_path.stem}.txt").write_text("\n".join(lines) + "\n")
    LOGGER.info(f"auto_annotate: {len(images)} images -> {output_dir}")
    return output_dir
