"""Inference entry on the card: the port's copy of ``examples/detect.py``,
itself a mirror of the reference fork's root detect.py (its lines 10-24):
predict over a test directory and save annotated images.

Usage:
    python examples_torch/detect.py [--weights runs/yolo11-701-YOLO-AD-Refine/weights/best] \
        [--source apid.v2i.yolov8/test/images] [--imgsz 640] [--conf 0.25] [--device cuda]

``--weights`` is a checkpoint directory (the port's or the JAX package's)
or a model yaml (seeded weights). On the card each batch runs K1 fwd three
times (the AYHead's three levels) and K4 once. ``--device cpu`` runs on
the CPU; a CUDA device that is not there raises.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv: list[str] | None = None) -> list[tuple[str, str]]:
    """Predict and print each result's path and summary; returns the printed
    (path, summary) pairs."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default="runs/yolo11-701-YOLO-AD-Refine/weights/best")
    ap.add_argument("--source", default="apid.v2i.yolov8/test/images")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--project", default=None, help="where predict/ is saved (default runs)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from yolo_ad_refine_tpu_torch import YOLO

    model = YOLO(args.weights, device=args.device)
    results = model.predict(source=args.source, imgsz=args.imgsz, conf=args.conf, save=True,
                            project=args.project)
    printed = []
    for r in results:
        print(r.path, r.verbose())
        printed.append((r.path, r.verbose()))
    return printed


if __name__ == "__main__":
    main()
