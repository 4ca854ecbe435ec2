"""Queue length monitoring in a region.

Parity surface: reference solutions/queue_management.py — per-frame count
reset, track-history-gated membership (a track only counts once it has a
previous position, queue_management.py:50-53), region overlay, per-track
box labels + centroid trails, and the queue-count display anchored to the
region.

Counterpart of ``yolo_ad_refine_tpu/solutions/queue_manager.py``: the same
host-side code over the port's ``Results``.
"""

from __future__ import annotations

import numpy as np

from yolo_ad_refine_tpu_torch.solutions.base import (
    BaseSolution,
    SolutionAnnotator,
    point_in_polygon,
    track_color,
)


class QueueManager(BaseSolution):
    def __init__(self, region: list[tuple], classes: list[int] | None = None,
                 names: dict | None = None, line_width: int = 2):
        if len(region) < 3:
            raise ValueError(f"queue region must be a polygon, got {len(region)} points")
        super().__init__(region=region, line_width=line_width,
                         classes=classes, names=names)
        self.count = 0
        self.history: list[int] = []
        self.rect_color = (255, 255, 255)

    def update(self, results) -> int:
        """Count tracks currently inside the region (no rendering). Rows
        without track ids still count — membership is positional."""
        n = 0
        for row in np.asarray(results.boxes.data, np.float64):
            cls = int(row[-1])
            if self.classes is not None and cls not in self.classes:
                continue
            cx, cy = float((row[0] + row[2]) / 2), float((row[1] + row[3]) / 2)
            if point_in_polygon((cx, cy), self.region):
                n += 1
        self.count = n
        self.history.append(n)
        return n

    def process_queue(self, im0: np.ndarray, results) -> np.ndarray:
        """Annotated pipeline (reference process_queue): per-frame reset,
        membership gated on track history, region + trails + count text."""
        self.count = 0
        annotator = SolutionAnnotator(im0, self.line_width)
        self.extract_tracks(results)
        annotator.draw_region(self.region, color=self.rect_color,
                              thickness=self.line_width * 2)
        for box, tid, cls in zip(self.boxes, self.track_ids, self.clss):
            annotator.box_label(box, label=self.label_for(cls),
                                color=track_color(tid))
            self.store_tracking_history(tid, box)
            annotator.draw_centroid_and_tracks(self.track_line,
                                               color=track_color(tid))
            hist = self.track_history[tid]
            prev = hist[-2] if len(hist) > 1 else None
            if prev is not None and point_in_polygon(hist[-1], self.region):
                self.count += 1
        self.history.append(self.count)
        annotator.queue_counts_display(f"Queue Counts : {self.count}",
                                       points=self.region,
                                       region_color=self.rect_color)
        return im0
