"""Training entry on the card: the port's copy of ``examples/train11.py``,
itself a mirror of the reference fork's root train11.py (its lines 12-31):
the flagship config trained on the aphid dataset with SGD and
close_mosaic=0, the same call as there.

Usage:
    python examples_torch/train11.py [--model yolo11-701-YOLO-AD-Refine.yaml] \
        [--device cuda] [key=value ...]

The defaults are the "701" run's schedule (weights/*/args.yaml): 220
epochs at batch 16, 640 px, SGD, lr0 0.01, lrf 0.001, close_mosaic 0.
``key=value`` overrides any train argument, e.g. ``data=<a data yaml>
epochs=1 imgsz=64``. Each train step runs K1 fwd and bwd three times
each on the card; each validation K1 fwd and K4.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TRAIN_ARGS = dict(
    data="apid.v2i.yolov8/data.yaml",  # dataset yaml (path/train/val/names)
    epochs=220,
    batch=16,
    imgsz=640,
    optimizer="SGD",
    lr0=0.01,
    lrf=0.001,          # the "701" run's schedule (weights/*/args.yaml)
    close_mosaic=0,
    project="runs",
    name="yolo11-701-YOLO-AD-Refine",
)


def main(argv: list[str] | None = None) -> dict:
    """Train; returns the trainer's results (its ``save_dir`` among them)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="yolo11-701-YOLO-AD-Refine.yaml")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="key=value train arguments")
    args = ap.parse_args(argv)

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.cfg.cli import parse_kv

    model = YOLO(args.model, task="detect", device=args.device)
    return model.train(**{**TRAIN_ARGS, **parse_kv(args.overrides)})


if __name__ == "__main__":
    main()
