"""Detection predictor: sources -> letterbox -> forward -> NMS -> Results.

Counterpart of ``yolo_ad_refine_tpu/engine/predictor.py`` (reference
engine/predictor.py:63-403 and models/yolo/detect/predict.py:23). Sources
are numpy BGR images, image and video files, directories, stream URLs and
lists of them (``data/loaders.py``); they are read batch by batch, so a
stream is served as it comes. Images are letterboxed on the model's device
to one square size, and a partial last batch is padded to the batch size,
as in the JAX predictor. The task follows the model's head: an OBB model
goes through the rotated NMS (K5 on the card) and its xywhr detections are
rescaled into ``Results.obb``, with their axis-aligned hulls in
``Results.boxes``. ``save``, ``save_txt`` (with ``save_conf``) and
``save_crop`` write the annotated images, the label files and the crops
into ``<project>/predict[n]``, as the JAX predictor does.
"""

from __future__ import annotations

import itertools
import time
from pathlib import Path

import numpy as np
import torch

from yolo_ad_refine_tpu_torch.data.augment import letterbox
from yolo_ad_refine_tpu_torch.data.loaders import load_inference_source
from yolo_ad_refine_tpu_torch.engine.results import OBBoxes, Results
from yolo_ad_refine_tpu_torch.ops.boxes import scale_boxes, scale_rboxes
from yolo_ad_refine_tpu_torch.ops.nms import non_max_suppression
from yolo_ad_refine_tpu_torch.utils import LOGGER, increment_path


def iter_sources(source, vid_stride: int = 1):
    """Yield (name, BGR frame, save name) for a numpy image, a path (image,
    video or directory), a stream or a list of them, lazily. A video frame
    is named ``<path>#<frame>`` as in the JAX package, and its outputs are
    saved as ``<stem>_<frame>``, one file a frame (the JAX predictor's
    ``Path(name)`` would give every frame of a video the same file)."""
    if isinstance(source, np.ndarray):
        yield "image0.jpg", source, "image0.jpg"
        return
    if isinstance(source, (list, tuple)):
        for i, s in enumerate(source):
            if isinstance(s, np.ndarray):
                yield f"image{i}.jpg", s, f"image{i}.jpg"
            else:
                yield from iter_sources(s, vid_stride)
        return
    for path, frame, meta in load_inference_source(source, vid_stride):
        if meta.get("video"):
            yield f"{path}#{meta['frame']}", frame, f"{Path(path).stem}_{meta['frame']}.jpg"
        else:
            yield path, frame, Path(path).name


def load_sources(source, vid_stride: int = 1) -> list[tuple[str, np.ndarray]]:
    """[(name, BGR frame)] of ``source`` (``iter_sources``), as the JAX
    ``load_sources``; for a finite source only."""
    return [(name, frame) for name, frame, _ in iter_sources(source, vid_stride)]


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
        save = bool(args.get("save", False))
        save_txt = bool(args.get("save_txt", False))
        save_conf = bool(args.get("save_conf", False))
        save_crop = bool(args.get("save_crop", False))
        names = names or getattr(model, "names", None) or {i: f"class{i}" for i in range(model.nc)}
        p = next(model.parameters())
        rotated = model.task == "obb"
        model.eval()

        # vid_stride reaches the loader here; the JAX predictor drops it (ROADMAP Queue 3)
        items = iter_sources(source, int(args.get("vid_stride", 1)))
        save_dir = None
        if save or save_txt or save_crop:
            save_dir = increment_path(Path(args.get("project") or "runs") / "predict", mkdir=True)
        results: list[Results] = []
        while chunk := list(itertools.islice(items, batch_size)):
            t0 = time.perf_counter()
            with torch.inference_mode():
                x, metas = preprocess([im for _, im, _ in chunk], imgsz, batch_size, p.device,
                                      p.dtype)
                y, _ = model(x)
                det, cnt, extras = non_max_suppression(
                    y, conf_thres=conf, iou_thres=iou, max_det=max_det, agnostic=agnostic,
                    nc=model.nc, rotated=rotated)
                det, cnt, extras = det.cpu().numpy(), cnt.cpu().numpy(), extras.cpu().numpy()
            dt = (time.perf_counter() - t0) / len(chunk) * 1000
            for j, ((name, im0, out_name), (ratio, pad)) in enumerate(zip(chunk, metas)):
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
                if save_dir is not None:
                    if save:
                        r.save(save_dir / out_name)
                    if save_txt:
                        r.save_txt(save_dir / "labels" / f"{Path(out_name).stem}.txt",
                                   save_conf=save_conf)
                    if save_crop:
                        r.save_crop(save_dir / "crops", out_name)
        return results
