"""Detection predictor: numpy sources -> letterbox -> forward -> NMS -> Results.

Counterpart of ``yolo_ad_refine_tpu/engine/predictor.py`` (reference
engine/predictor.py:63-403 and models/yolo/detect/predict.py:23). Images are
letterboxed on the model's device to one square size, and a partial last
batch is padded to the batch size, as in the JAX predictor. The task
follows the model's head: an OBB model goes through the rotated NMS (K5 on
the card) and its xywhr detections are rescaled into ``Results.obb``, with
their axis-aligned hulls in ``Results.boxes``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from yolo_ad_refine_tpu_torch.data.augment import letterbox
from yolo_ad_refine_tpu_torch.engine.results import OBBoxes, Results
from yolo_ad_refine_tpu_torch.ops.boxes import scale_boxes, scale_rboxes
from yolo_ad_refine_tpu_torch.ops.nms import non_max_suppression
from yolo_ad_refine_tpu_torch.utils import LOGGER


def load_sources(source) -> list[tuple[str, np.ndarray]]:
    """Resolve numpy BGR (H, W, 3) uint8 images, alone or in a list, to
    [(name, image)]. Files, directories, videos and streams come with the
    port's IO layer."""
    if isinstance(source, np.ndarray):
        return [("image0.jpg", source)]
    if isinstance(source, (list, tuple)) and all(isinstance(s, np.ndarray) for s in source):
        return [(f"image{i}.jpg", s) for i, s in enumerate(source)]
    raise NotImplementedError(
        "the PyTorch port predicts on numpy images so far; file, directory, video and stream "
        "sources wait for the IO layer (ROADMAP Queue 1 item 15)")


def preprocess(images, imgsz: int, batch_size: int, device, dtype):
    """Letterbox BGR uint8 images into one RGB (batch_size, 3, imgsz, imgsz)
    channels_last tensor scaled to [0, 1], zero-padded past the last image.
    Returns (x, [(ratio, pad), ...])."""
    ims, metas = [], []
    for im0 in images:
        im, ratio, pad = letterbox(torch.from_numpy(np.ascontiguousarray(im0)).to(device), imgsz)
        ims.append(im)
        metas.append((ratio, pad))
    batch = torch.stack(ims).flip(-1)  # BGR -> RGB, (n, H, W, 3)
    if len(ims) < batch_size:
        batch = torch.cat([batch, batch.new_zeros((batch_size - len(ims), *batch.shape[1:]))])
    return batch.permute(0, 3, 1, 2).to(dtype) / 255.0, metas


class DetectionPredictor:
    def __init__(self, overrides: dict | None = None):
        self.args = dict(overrides or {})

    def __call__(self, source=None, model=None, names: dict | None = None):
        args = self.args
        imgsz = int(args.get("imgsz", 640))
        conf = float(args.get("conf") or 0.25)
        iou = float(args.get("iou", 0.7))
        max_det = int(args.get("max_det", 300))
        agnostic = bool(args.get("agnostic_nms", False))
        batch_size = int(args.get("batch", 16))
        verbose = bool(args.get("verbose", False))
        names = names or getattr(model, "names", None) or {i: f"class{i}" for i in range(model.nc)}
        p = next(model.parameters())
        rotated = model.task == "obb"
        model.eval()

        items = load_sources(source)
        results: list[Results] = []
        for i in range(0, len(items), batch_size):
            chunk = items[i: i + batch_size]
            t0 = time.perf_counter()
            with torch.inference_mode():
                x, metas = preprocess([im for _, im in chunk], imgsz, batch_size, p.device, p.dtype)
                y, _ = model(x)
                det, cnt, extras = non_max_suppression(
                    y, conf_thres=conf, iou_thres=iou, max_det=max_det, agnostic=agnostic,
                    nc=model.nc, rotated=rotated)
                det, cnt, extras = det.cpu().numpy(), cnt.cpu().numpy(), extras.cpu().numpy()
            dt = (time.perf_counter() - t0) / len(chunk) * 1000
            for j, ((name, im0), (ratio, pad)) in enumerate(zip(chunk, metas)):
                n = int(cnt[j])
                d = det[j, :n].copy()
                kw = {}
                if rotated:  # rows are xywh: rescale them with the angle
                    rb = scale_rboxes(np.concatenate([d[:, :4], extras[j, :n, :1]], -1),
                                      (ratio, pad))
                    kw["obb"] = np.concatenate([rb, d[:, 4:6]], -1)
                    d = np.concatenate([OBBoxes(kw["obb"], im0.shape[:2]).xyxy, d[:, 4:6]], -1)
                elif n:
                    d[:, :4] = scale_boxes((imgsz, imgsz), torch.from_numpy(d[:, :4]),
                                           im0.shape[:2], ratio_pad=(ratio, pad)).numpy()
                r = Results(im0, name, names, d, speed={"inference": dt}, **kw)
                results.append(r)
                if verbose:
                    LOGGER.info(f"{name}: {r.verbose()} ({dt:.1f} ms/img)")
        return results
