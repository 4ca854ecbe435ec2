"""Track-and-classify action recognition over a video stream, on the card:
the port's copy of ``examples/action_recognition.py``.

Reference analogue: examples/YOLOv8-Action-Recognition/action_recognition.py
(detect+track people, buffer per-track crops, run a video classifier over
the crop window, annotate the label). The reference downloads pretrained
video classifiers; nothing is downloaded here, so the classifier is any
classification model of the port (a ``*-cls.yaml`` config with seeded
weights, or a checkpoint from ``yat-torch classify train``), applied per
crop with a majority vote over the sliding frame window, which is the same
temporal-aggregation contract. The detector tracks with ``YOLO.track``
(ByteTrack; K1 fwd three times and K4 once a frame on the card); the
classifier runs on the same device.

Usage:
    python examples_torch/action_recognition.py VIDEO \
        [--det-model yolo11n.yaml] [--cls-model yolo11n-cls.yaml] \
        [--window 8] [--crop-size 224] [--imgsz 320] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter, defaultdict, deque
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def letterbox_crop(img: np.ndarray, xyxy, size: int) -> np.ndarray:
    """Square-resize a box crop with gray padding (reference crops then
    lets the video model resize; one canonical crop keeps shapes static)."""
    import cv2

    x1, y1, x2, y2 = (int(max(0, v)) for v in xyxy)
    crop = img[y1:y2, x1:x2]
    if crop.size == 0:
        return np.full((size, size, 3), 114, np.uint8)
    h, w = crop.shape[:2]
    r = size / max(h, w)
    crop = cv2.resize(crop, (max(1, int(w * r)), max(1, int(h * r))))
    out = np.full((size, size, 3), 114, np.uint8)
    out[: crop.shape[0], : crop.shape[1]] = crop
    return out


class CropClassifier:
    """Batched classify-model forward over (N, S, S, 3) uint8 crops, in eval
    on the model's device. ``cfg`` is a ``*-cls`` yaml (seeded weights) or
    a checkpoint directory. The crops go in as the JAX script feeds them
    (channel order as given, / 255), and the probabilities are the softmax
    of the head's eval output, itself a softmax, as there: the top class is
    the head's, and its probability the JAX script's."""

    def __init__(self, cfg, names=None, crop_size: int = 224, device="cuda"):
        from yolo_ad_refine_tpu_torch.engine.checkpoint import load_checkpoint
        from yolo_ad_refine_tpu_torch.models.model import build_detection_model

        if isinstance(cfg, dict) or str(cfg).endswith((".yaml", ".yml")):
            self.model = build_detection_model(cfg, imgsz=crop_size, device=device)
        else:
            self.model = load_checkpoint(cfg, device)
        self.model.eval()
        self.names = names or {i: str(i) for i in range(self.model.nc)}
        self.crop_size = crop_size

    def __call__(self, crops: np.ndarray) -> list[tuple[str, float]]:
        import torch

        p = next(self.model.parameters())
        x = torch.from_numpy(np.asarray(crops, np.float32) / 255.0).permute(0, 3, 1, 2)
        with torch.inference_mode():
            x = x.to(p.device, p.dtype).contiguous(memory_format=torch.channels_last)
            probs = torch.softmax(self.model(x).float(), -1).cpu().numpy()
        top = probs.argmax(-1)
        return [(self.names.get(int(c), str(int(c))), float(probs[i, c]))
                for i, c in enumerate(top)]


def main(argv: list[str] | None = None) -> dict:
    """Track, classify each person crop, vote per track and print; returns
    {"labels": {track id: label}, "votes": {track id: frame votes},
    "frames": n}, what it printed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("video")
    ap.add_argument("--det-model", default="yolo11n.yaml")
    ap.add_argument("--cls-model", default="yolo11n-cls.yaml")
    ap.add_argument("--imgsz", type=int, default=320)
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--window", type=int, default=8,
                    help="frames per track aggregated into one vote")
    ap.add_argument("--crop-size", type=int, default=224)
    ap.add_argument("--person-class", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from yolo_ad_refine_tpu_torch import YOLO

    det = YOLO(args.det_model, imgsz=args.imgsz, device=args.device)
    cls = CropClassifier(args.cls_model, crop_size=args.crop_size, device=args.device)

    votes: dict[int, deque] = defaultdict(lambda: deque(maxlen=args.window))
    labels: dict[int, str] = {}

    n_frames = 0
    for res in det.track(args.video, conf=args.conf, imgsz=args.imgsz):
        n_frames += 1
        if res.boxes is None or len(res.boxes) == 0:
            continue
        ids = res.boxes.id
        if ids is None:
            continue
        keep = [i for i in range(len(res.boxes))
                if int(res.boxes.cls[i]) == args.person_class]
        if not keep:
            continue
        crops = np.stack([
            letterbox_crop(res.orig_img, res.boxes.xyxy[i], args.crop_size)
            for i in keep])
        for i, (name, conf) in zip(keep, cls(crops)):
            tid = int(ids[i])
            votes[tid].append(name)
            labels[tid] = Counter(votes[tid]).most_common(1)[0][0]

    for tid, label in sorted(labels.items()):
        print(f"track {tid}: {label} ({len(votes[tid])} frame votes)")
    print(f"{n_frames} frames processed, {len(labels)} tracks classified")
    return {"labels": dict(sorted(labels.items())),
            "votes": {tid: len(votes[tid]) for tid in sorted(labels)}, "frames": n_frames}


if __name__ == "__main__":
    main()
