"""Count objects inside multiple named regions of a video stream, on the
card: the port's copy of ``examples/region_counter.py``.

Reference analogue: examples/YOLOv8-Region-Counter (multi-region counting
with movable polygons). Built on the tracking facade (``YOLO.track``,
ByteTrack; K1 fwd three times and K4 once a frame on the card) and the
ObjectCounter solution: one counter per region over one shared track
stream.

Usage:
    python examples_torch/region_counter.py VIDEO [MODEL.yaml or checkpoint] \
        [--imgsz 320] [--conf 0.25] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv: list[str] | None = None) -> dict:
    """Track, count and print; returns {"regions": {name: (in, out)},
    "frames": n}, what it printed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("video")
    ap.add_argument("model", nargs="?", default="yolo11n.yaml")
    ap.add_argument("--imgsz", type=int, default=320)
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.solutions.object_counter import ObjectCounter

    model = YOLO(args.model, imgsz=args.imgsz, device=args.device)
    s = args.imgsz
    regions = {
        "left": [(0, 0), (s // 2, 0), (s // 2, s), (0, s)],
        "right": [(s // 2, 0), (s, 0), (s, s), (s // 2, s)],
    }
    counters = {name: ObjectCounter(region=pts) for name, pts in regions.items()}

    results = model.track(args.video, conf=args.conf, imgsz=args.imgsz)
    n_frames = 0
    for res in results:
        n_frames += 1
        for counter in counters.values():
            counter.update(res)
    for name, counter in counters.items():
        print(f"region '{name}': in={counter.in_count} out={counter.out_count}")
    print(f"{n_frames} frames processed")
    return {"regions": {name: (c.in_count, c.out_count) for name, c in counters.items()},
            "frames": n_frames}


if __name__ == "__main__":
    main()
