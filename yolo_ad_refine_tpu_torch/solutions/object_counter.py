"""Line/region object counting over tracked detections.

Parity surface: reference solutions/object_counter.py — directional
IN/OUT counting per track id (centroid-relative motion sign for polygons,
segment-crossing for lines, object_counter.py:28-64), per-class counts,
and the annotated-frame pipeline (region overlay, box labels, track
lines, analytics display, object_counter.py:93-131).

Counterpart of ``yolo_ad_refine_tpu/solutions/object_counter.py``: the same
host-side code over the port's ``Results``.
"""

from __future__ import annotations

import numpy as np

from yolo_ad_refine_tpu_torch.solutions.base import (
    BaseSolution,
    SolutionAnnotator,
    point_in_polygon,
    polygon_centroid,
    segments_intersect,
    track_color,
)


class ObjectCounter(BaseSolution):
    """Counts objects crossing a line or entering a polygon region.

    region: 2 points = counting line; >=3 points = polygon region.
    `update(results)` returns the summary dict; `count(im0, results)` also
    renders the reference's annotated frame in place and returns it.
    """

    def __init__(self, region: list[tuple], classes: list[int] | None = None,
                 names: dict | None = None, line_width: int = 2,
                 show_in: bool = True, show_out: bool = True):
        if len(region) < 2:
            raise ValueError(f"region needs >= 2 points, got {len(region)}")
        super().__init__(region=region, line_width=line_width,
                         classes=classes, names=names)
        self.show_in = show_in
        self.show_out = show_out
        self.in_count = 0
        self.out_count = 0
        self.counted_ids: set[int] = set()
        self.class_counts: dict[int, dict[str, int]] = {}

    # -- counting core ------------------------------------------------------

    def _count_track(self, track_id: int, box, cls: int):
        """Reference count_objects: needs a previous position; polygons
        count by centroid-relative motion sign, lines by segment crossing."""
        hist = self.track_history[track_id]
        prev = hist[-2] if len(hist) > 1 else None
        if prev is None or track_id in self.counted_ids:
            return
        cx, cy = polygon_centroid(self.region) if len(self.region) >= 3 \
            else ((self.region[0][0] + self.region[1][0]) / 2,
                  (self.region[0][1] + self.region[1][1]) / 2)
        dx = (box[0] - prev[0]) * (cx - prev[0])
        dy = (box[1] - prev[1]) * (cy - prev[1])
        if len(self.region) >= 3:
            if point_in_polygon(hist[-1], self.region):
                self.counted_ids.add(track_id)
                self._bump(cls, "in" if dx > 0 else "out")
        elif segments_intersect(prev, (box[0], box[1]),
                                self.region[0], self.region[1]):
            self.counted_ids.add(track_id)
            self._bump(cls, "in" if (dx > 0 and dy > 0) else "out")

    def _bump(self, cls: int, direction: str):
        if direction == "in":
            self.in_count += 1
        else:
            self.out_count += 1
        self.class_counts.setdefault(cls, {"in": 0, "out": 0})[direction] += 1

    # -- public API ---------------------------------------------------------

    def update(self, results) -> dict:
        """Feed one frame's Results (track rows required for id-based
        counting); no rendering."""
        self.extract_tracks(results)
        for box, tid, cls in zip(self.boxes, self.track_ids, self.clss):
            self.store_tracking_history(tid, box)
            self._count_track(tid, box, cls)
        return self.summary()

    def count(self, im0: np.ndarray, results) -> np.ndarray:
        """Annotated-frame pipeline (reference object_counter.py count):
        draws the region, per-box labels, track centroid lines and the
        classwise IN/OUT analytics block; updates counts."""
        annotator = SolutionAnnotator(im0, self.line_width)
        annotator.draw_region(self.region)
        self.extract_tracks(results)
        for box, tid, cls in zip(self.boxes, self.track_ids, self.clss):
            annotator.box_label(box, label=self.label_for(cls),
                                color=track_color(tid))
            self.store_tracking_history(tid, box)
            annotator.draw_centroid_and_tracks(self.track_line,
                                               color=track_color(tid))
            self._count_track(tid, box, cls)
        labels = {}
        for cls, v in self.class_counts.items():
            if v["in"] or v["out"]:
                parts = ([f"IN {v['in']}"] if self.show_in else []) + \
                        ([f"OUT {v['out']}"] if self.show_out else [])
                labels[self.label_for(cls).capitalize()] = " ".join(parts)
        if labels:
            annotator.display_analytics(labels)
        return im0

    def summary(self) -> dict:
        return {"in": self.in_count, "out": self.out_count,
                "classwise": self.class_counts}
