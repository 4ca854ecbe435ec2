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
``Results.boxes``; a segment model's NMS (K4) carries the 32 mask
coefficients, whose masks (``segment_masks``) become ``Results.masks``; a
pose model's carries the decoded keypoints, rescaled into
``Results.keypoints``. A YOLO-World model serves its vocabulary: K4's
candidates take the text rows' class count (``DetectionModel.n_scores``).
A YOLOv10 model takes no NMS: its selected rows are cut at ``conf``
(``nms_free_rows``, the JAX validator's branch; the JAX predictor runs its
NMS on them and reads the class column as a score, ROADMAP Queue 3). An
RT-DETR model takes no NMS either: its queries' normalised xywh are scaled
by imgsz, each keeps its best class and those over ``conf`` are kept, in
score order (``rtdetr_rows``, the JAX validator's branch; the JAX predictor
runs its NMS on the normalised boxes, which come out in [0, 1], ROADMAP
Queue 3 hazard (h)). The
JAX package serves no classifier, and neither does the port. ``save``,
``save_txt`` (with ``save_conf``) and ``save_crop`` write the annotated
images, the label files and the crops into ``<project>/predict[n]``, as the
JAX predictor does.
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
from yolo_ad_refine_tpu_torch.ops.masks import process_mask, scale_masks
from yolo_ad_refine_tpu_torch.ops.nms import nms_free_rows, non_max_suppression, rtdetr_rows
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


def segment_masks(proto, coeffs, det, cnt, metas, shapes, imgsz: int) -> list[np.ndarray]:
    """The kept detections' masks of a batch on the model's device, each
    image's as (n, h0, w0) bool over its original image: proto (B, nm, mh,
    mw), coeffs (B, max_det, nm) and det (B, max_det, 6) xyxy input pixels
    from the NMS, cnt (B,) on the host, metas [(ratio, pad)] and shapes
    [(h0, w0)] for the batch's real images. The JAX predictor computes the
    same values for every one of the max_det rows of the whole batch
    (B x max_det x imgsz^2 floats); here only each image's n kept rows
    (``ops/masks.py process_mask``, then ``scale_masks``)."""
    out = []
    for j, ((ratio, pad), shape0) in enumerate(zip(metas, shapes)):
        n = int(cnt[j])
        if not n:
            out.append(np.zeros((0, *shape0), bool))
            continue
        m = process_mask(proto[j], coeffs[j, :n], det[j, :n, :4], (imgsz, imgsz))
        out.append(scale_masks(m, pad, ratio[0], shape0).cpu().numpy())
    return out


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
        task = model.task
        if task == "classify":
            raise ValueError(
                "predict on a Classify model: the JAX package serves no classifier (its "
                "predictor knows no Classify head and its Results have no probs); run the "
                "model's forward, whose eval output is the softmax, or .val(data=...)")
        rotated = task == "obb"
        kind = model.head_kind
        kpt_shape = getattr(model.model[model.head_idx], "kpt_shape", None)
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
                y, feats = model(x)
                if kind == "v10":
                    det, cnt, extras = nms_free_rows(y, conf)
                elif kind == "rtdetr":
                    det, cnt, extras = rtdetr_rows(y, conf, imgsz)
                else:
                    det, cnt, extras = non_max_suppression(
                        y, conf_thres=conf, iou_thres=iou, max_det=max_det, agnostic=agnostic,
                        nc=model.n_scores, rotated=rotated)
                cnt = cnt.cpu().numpy()
                masks = (segment_masks(feats[2], extras, det, cnt, metas,
                                       [im.shape[:2] for _, im, _ in chunk], imgsz)
                         if task == "segment" else None)
                det, extras = det.cpu().numpy(), extras.cpu().numpy()
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
                if task == "pose":  # keypoints un-letterboxed, not clipped (the JAX predictor's)
                    kp = extras[j, :n].reshape(n, *kpt_shape).copy()
                    kp[..., 0] = (kp[..., 0] - pad[0]) / ratio[0]
                    kp[..., 1] = (kp[..., 1] - pad[1]) / ratio[0]
                    kw["keypoints"] = kp
                elif task == "segment" and n:
                    kw["masks"] = masks[j]
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
