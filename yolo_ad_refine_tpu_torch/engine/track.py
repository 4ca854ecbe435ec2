"""Tracking: a source's frames -> forward + NMS -> BYTETracker / BOTSORT.

Counterpart of ``yolo_ad_refine_tpu/engine/track.py`` (reference
trackers/track.py and engine/model.py:556 Model.track). Each frame is
letterboxed with cv2 as the JAX tracker does (``letterbox_np``,
``scaleup=True``), run alone through the model on its device (batch 1: the
flagship's MLCA mixes the images of a batch, so batching frames would
change its detections), suppressed by the port's NMS (K4 on the card,
once a frame), rescaled to the frame and handed to the tracker, less the
rows clipped to zero height (``trackable_rows``). Each
frame's ``Results`` holds 7-column track rows [x1, y1, x2, y2, id, conf,
cls] and ``speed`` in ms: ``preprocess`` (letterbox and copy to the
device), ``inference`` (forward, NMS, the rows' copy back, which waits
for the device, and their rescale; ``frame_rows``) and ``track`` (the
tracker's update).

The tracker is built anew on every call and ``persist`` does nothing, as
in the JAX package (ROADMAP hazard (i)). Heads whose eval output the JAX
tracker's detect NMS misreads raise here, naming the hazard: YOLOv10's
selected rows (hazard (a)), RT-DETR's normalised boxes (hazard (h)) and
OBB's rotated boxes, whose angle the axis-aligned NMS drops (hazard (j));
a Classify model has no boxes. Segment and pose models are tracked by
their boxes, as in JAX; a YOLO-World model by its vocabulary's scores.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from yolo_ad_refine_tpu_torch.data.augment import letterbox_np
from yolo_ad_refine_tpu_torch.data.loaders import load_inference_source
from yolo_ad_refine_tpu_torch.engine.results import Results
from yolo_ad_refine_tpu_torch.ops.boxes import scale_boxes
from yolo_ad_refine_tpu_torch.ops.nms import non_max_suppression
from yolo_ad_refine_tpu_torch.trackers import TRACKER_MAP
from yolo_ad_refine_tpu_torch.utils import LOGGER

MISREAD = {  # head: why the JAX tracker's detect NMS misreads its eval output
    "v10": "YOLOv10's eval output is its selected rows (xywh, score, class), which the JAX "
           "tracker's NMS reads as class scores (ROADMAP hazard (a))",
    "rtdetr": "RT-DETR's eval boxes are normalised xywh, which the JAX tracker's NMS takes "
              "for pixels (ROADMAP hazard (h))",
    "obb": "an OBB model's boxes are rotated xywhr, whose angle the JAX tracker's axis-aligned "
           "NMS drops (ROADMAP hazard (j))",
    "classify": "a Classify model has no boxes to track",
}


def trackable_rows(d: np.ndarray) -> np.ndarray:
    """The rows of a frame's detections (n, 6) that have a height. A box
    that lies in the letterbox's pad is clipped to the frame's edge with
    height 0, and a track started from it has an infinite aspect w / h and
    a NaN state (ROADMAP hazard (k)): the JAX tracker, which keeps every
    row, returns it as a NaN row on the first frame, raises at the first
    association that meets it, and where none does, numbers the tracks
    after it one higher. The port drops such rows, and its tracks are the
    JAX tracker's less those."""
    return d[d[:, 3] > d[:, 1]]


def check_trackable(model) -> None:
    """Raise ValueError for a head the JAX tracker misreads (``MISREAD``)."""
    kind = model.task if model.task in ("obb", "classify") else model.head_kind
    if kind in MISREAD:
        raise ValueError(f"track: {MISREAD[kind]}; predict() serves this model")


def frame_rows(model, frame: np.ndarray, imgsz: int = 640, conf: float = 0.25,
               iou: float = 0.7, max_det: int = 300) -> tuple[np.ndarray, float, float]:
    """One BGR frame through the model alone (batch 1): the cv2 letterbox,
    the forward and the NMS, the kept rows rescaled to the frame. Returns
    (n, 6) rows [x1, y1, x2, y2, conf, cls] in frame pixels and the ms of
    the preprocess and of the forward, NMS and rescale (which wait for the
    device)."""
    p = next(model.parameters())
    t0 = time.perf_counter()
    im, ratio, pad = letterbox_np(frame, imgsz, scaleup=True)
    x = torch.from_numpy(np.ascontiguousarray(im[None, ..., ::-1])).to(p.device)
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last).to(p.dtype) / 255.0
    t1 = time.perf_counter()
    with torch.inference_mode():
        y, _ = model(x)
        det, cnt, _ = non_max_suppression(y, conf_thres=conf, iou_thres=iou, max_det=max_det,
                                          nc=model.n_scores)
        n = int(cnt[0])
        d = det[0, :n].float().cpu().numpy()
    if n:
        d[:, :4] = scale_boxes((imgsz, imgsz), torch.from_numpy(d[:, :4]), frame.shape[:2],
                               ratio_pad=(ratio, pad)).numpy()
    return d, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


def track(model, source, tracker: str = "bytetrack", imgsz: int = 640, conf: float = 0.25,
          iou: float = 0.7, max_det: int = 300, names: dict | None = None,
          persist: bool = False, vid_stride: int = 1,
          tracker_args: dict | None = None) -> list[Results]:
    """Track the objects of ``source`` (a video, an image, a directory, a
    stream or a camera index) frame by frame. Returns a list of Results
    with track rows."""
    if tracker not in TRACKER_MAP:
        raise ValueError(f"tracker must be one of {sorted(TRACKER_MAP)}, not {tracker!r}")
    check_trackable(model)
    trk = TRACKER_MAP[tracker](**(tracker_args or {}))
    names = names or getattr(model, "names", None) or {i: f"class{i}" for i in range(model.nc)}
    model.eval()
    results = []
    for path, frame, _ in load_inference_source(source, vid_stride):
        d, pre_ms, inf_ms = frame_rows(model, frame, imgsz, conf, iou, max_det)
        t0 = time.perf_counter()
        d = trackable_rows(d)
        tracks = trk.update(d[:, :4], d[:, 4], d[:, 5], img=frame)  # (m, 8)
        boxes = tracks[:, :7] if len(tracks) else np.zeros((0, 7), np.float32)
        results.append(Results(frame, path, names, boxes, speed={
            "preprocess": pre_ms, "inference": inf_ms,
            "track": (time.perf_counter() - t0) * 1e3}))
    LOGGER.info(f"tracked {len(results)} frames; {len(trk.tracked_stracks)} active tracks at end")
    return results
