"""Sliced (SAHI-style) inference for small objects in large images, on the
card: the port's copy of ``examples/sahi_tiled_inference.py``.

Reference analogue: examples/YOLOv8-SAHI-Inference-Video (sahi package
slicing + per-slice predict + merged NMS). As in the JAX script the slice
grid is static (every tile the same size), all tiles go through one batched
forward, and the merge is the fixed-shape NMS over offset-shifted boxes:
here the port's ``DetectionModel`` in NCHW on the device, then
``ops/nms.py non_max_suppression`` (K4 on the card) once over the tiles and
once, class-aware, over their union.

Usage:
    python examples_torch/sahi_tiled_inference.py IMAGE [MODEL.yaml or checkpoint] \
        [--tile 640] [--overlap 0.2] [--conf 0.25] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def tile_grid(h: int, w: int, tile: int, overlap: float):
    """Static tile origins covering (h, w) with the given fractional overlap."""
    stride = max(1, int(tile * (1 - overlap)))
    ys = list(range(0, max(h - tile, 0) + 1, stride)) or [0]
    xs = list(range(0, max(w - tile, 0) + 1, stride)) or [0]
    if ys[-1] + tile < h:
        ys.append(h - tile)
    if xs[-1] + tile < w:
        xs.append(w - tile)
    return [(y, x) for y in ys for x in xs]


def sliced_predict(model, img: np.ndarray, tile: int = 640, overlap: float = 0.2,
                   conf: float = 0.25, iou: float = 0.5, max_det: int = 300):
    """Run the model over a static tile grid and merge with global NMS.

    ``model`` is a YOLO facade or a bare DetectionModel (on its device);
    ``img`` an (H, W, 3) BGR uint8 image, padded with 114 up to one tile.
    The tiles are fed RGB in [0, 1], scaled on the host as the JAX script
    scales them. Each tile keeps at most ``max_det`` rows; their union, in
    full-image pixels, is merged class-aware with ``nc`` = the largest
    class + 1. Past ``max_nms`` (2,048) rows in the union, both packages
    keep the top 2,048 by score, and rows tied at the cut may be kept in
    either order (ROADMAP hazard (d)): the merged rows then agree only
    where no such tie straddles it.

    Returns (boxes xyxy in full-image px, scores, classes) as numpy arrays.
    """
    import torch

    from yolo_ad_refine_tpu_torch.models.model import DetectionModel
    from yolo_ad_refine_tpu_torch.ops.nms import non_max_suppression

    m = model if isinstance(model, DetectionModel) else model.model  # bare, or a YOLO facade
    p = next(m.parameters())
    h, w = img.shape[:2]
    pad_h, pad_w = max(0, tile - h), max(0, tile - w)
    if pad_h or pad_w:
        img = np.pad(img, ((0, pad_h), (0, pad_w), (0, 0)), constant_values=114)
        h, w = img.shape[:2]
    grid = tile_grid(h, w, tile, overlap)
    batch = np.stack([img[y : y + tile, x : x + tile] for (y, x) in grid])
    x_in = torch.from_numpy(batch[..., ::-1].astype(np.float32) / 255.0).permute(0, 3, 1, 2)
    x_in = x_in.to(p.device, p.dtype).contiguous(memory_format=torch.channels_last)
    m.eval()
    with torch.inference_mode():
        y, _ = m(x_in)
        det, cnt, _ = non_max_suppression(y, conf_thres=conf, iou_thres=iou, max_det=max_det,
                                          nc=m.n_scores)
    det = det.float().cpu().numpy()
    cnt = cnt.cpu().numpy()
    rows = []
    for ti, (oy, ox) in enumerate(grid):
        d = det[ti, : int(cnt[ti])].copy()
        d[:, [0, 2]] += ox
        d[:, [1, 3]] += oy
        rows.append(d)
    allrows = np.concatenate(rows, 0) if rows else np.zeros((0, 6), np.float32)
    if not len(allrows):
        return allrows[:, :4], allrows[:, 4], allrows[:, 5]
    # merged class-aware NMS over the union; the entry takes (B, N, 4+nc)
    # xywh + class scores
    nc = int(allrows[:, 5].max()) + 1
    merged = np.zeros((1, len(allrows), 4 + nc), np.float32)
    merged[0, :, 0:2] = (allrows[:, :2] + allrows[:, 2:4]) / 2  # xy center
    merged[0, :, 2:4] = allrows[:, 2:4] - allrows[:, :2]        # wh
    merged[0, np.arange(len(allrows)), 4 + allrows[:, 5].astype(int)] = allrows[:, 4]
    with torch.inference_mode():
        det2, cnt2, _ = non_max_suppression(torch.from_numpy(merged).to(p.device),
                                            conf_thres=conf, iou_thres=iou, max_det=max_det,
                                            nc=nc)
    d = det2[0, : int(cnt2[0])].cpu().numpy()
    return d[:, :4], d[:, 4], d[:, 5]


def main(argv: list[str] | None = None) -> dict:
    """Tile, predict, merge and print; returns {"boxes", "scores",
    "classes", "tiles"}, what it printed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("image")
    ap.add_argument("model", nargs="?", default="yolo11n.yaml")
    ap.add_argument("--tile", type=int, default=640)
    ap.add_argument("--overlap", type=float, default=0.2)
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import cv2

    from yolo_ad_refine_tpu_torch import YOLO

    img = cv2.imread(args.image)
    if img is None:
        raise FileNotFoundError(f"cannot read an image at {args.image}")
    model = YOLO(args.model, imgsz=args.tile, device=args.device)
    boxes, scores, classes = sliced_predict(model, img, tile=args.tile,
                                            overlap=args.overlap, conf=args.conf)
    tiles = len(tile_grid(*img.shape[:2], args.tile, args.overlap))
    print(f"{len(boxes)} detections over {tiles} tiles")
    for b, s, c in zip(boxes, scores, classes):
        print(f"  cls={int(c)} conf={s:.3f} box={np.round(b, 1).tolist()}")
    return {"boxes": boxes, "scores": scores, "classes": classes, "tiles": tiles}


if __name__ == "__main__":
    main()
