"""Validation and paper report on the card: the port's copy of
``examples/val.py``, itself a mirror of the reference fork's root val.py
(its lines 17-98), which validates best.pt and writes a table (params,
GFLOPs, per-image ms, FPS, the metrics) to paper_data.txt;
``utils/benchmarks.py paper_report`` writes that report.

Usage:
    python examples_torch/val.py [--weights runs/yolo11-701-YOLO-AD-Refine/weights/best] \
        [--device cuda] [key=value ...]

``key=value`` overrides data, imgsz, batch or save_path. On the card each
validation batch runs K1 fwd three times and K4 once.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

REPORT_ARGS = dict(
    data="apid.v2i.yolov8/data.yaml",
    imgsz=640,
    batch=16,
    save_path="paper_data.txt",
)


def main(argv: list[str] | None = None) -> dict:
    """Validate and write the report; returns the validation's results."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default="runs/yolo11-701-YOLO-AD-Refine/weights/best")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="key=value: data, imgsz, batch, save_path")
    args = ap.parse_args(argv)

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.cfg.cli import parse_kv
    from yolo_ad_refine_tpu_torch.utils.benchmarks import paper_report

    model = YOLO(args.weights, device=args.device)
    return paper_report(model, **{**REPORT_ARGS, **parse_kv(args.overrides)})


if __name__ == "__main__":
    main()
