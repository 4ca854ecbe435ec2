"""Shared solution machinery: region geometry, track history, annotation.

Parity surface: reference solutions/solutions.py (BaseSolution: region
initialization, 30-point track history, track extraction) and the
Annotator calls the apps make (utils/plotting.py Annotator.draw_region /
box_label / draw_centroid_and_tracks / display_analytics /
queue_counts_display). The reference leans on shapely for the region
predicates; shapely isn't in this environment, so the small amount of
geometry the apps actually use (point-in-polygon, segment intersection,
polygon centroid) is implemented directly.

Unlike the reference (whose BaseSolution owns a YOLO model and calls
model.track internally), these apps consume per-frame Results objects —
the model/tracker loop stays with the caller, which keeps the apps
testable and device-free. ``extract_tracks`` adapts a Results into the
same boxes/track_ids/clss triple the reference loops over.

Counterpart of ``yolo_ad_refine_tpu/solutions/base.py``: the same
host-side code over the port's ``Results``.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


# -- geometry (replaces shapely Polygon/LineString/Point) -------------------

def point_in_polygon(p, poly) -> bool:
    x, y = p
    inside = False
    n = len(poly)
    for i in range(n):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % n]
        if (y1 > y) != (y2 > y) and x < (x2 - x1) * (y - y1) / (y2 - y1 + 1e-12) + x1:
            inside = not inside
    return inside


def segments_intersect(p1, p2, q1, q2) -> bool:
    def orient(a, b, c):
        v = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        return 0 if abs(v) < 1e-12 else (1 if v > 0 else -1)

    def on_seg(a, b, c):
        return (min(a[0], b[0]) <= c[0] <= max(a[0], b[0])
                and min(a[1], b[1]) <= c[1] <= max(a[1], b[1]))

    o1, o2 = orient(p1, p2, q1), orient(p1, p2, q2)
    o3, o4 = orient(q1, q2, p1), orient(q1, q2, p2)
    if o1 != o2 and o3 != o4:
        return True
    return any(o == 0 and on_seg(a, b, c) for o, a, b, c in
               [(o1, p1, p2, q1), (o2, p1, p2, q2),
                (o3, q1, q2, p1), (o4, q1, q2, p2)])


def polygon_centroid(poly):
    xs = [p[0] for p in poly]
    ys = [p[1] for p in poly]
    return sum(xs) / len(xs), sum(ys) / len(ys)


def track_color(i: int) -> tuple:
    """Deterministic per-track BGR color (reference plotting.colors)."""
    rng = np.random.default_rng(int(i) * 3 + 7)
    return tuple(int(v) for v in rng.integers(60, 255, 3))


# -- annotation (cv2-based Annotator-lite) ----------------------------------

class SolutionAnnotator:
    """The Annotator subset the solution apps use, drawing in place."""

    def __init__(self, im, line_width: int = 2):
        self.im = im
        self.lw = max(1, int(line_width))

    def draw_region(self, reg_pts, color=(104, 0, 123), thickness=None):
        import cv2

        pts = np.asarray(reg_pts, np.int32).reshape(-1, 1, 2)
        closed = len(reg_pts) >= 3
        cv2.polylines(self.im, [pts], closed, color, thickness or self.lw * 2)

    def box_label(self, box, label="", color=(128, 128, 128)):
        import cv2

        x1, y1, x2, y2 = (int(v) for v in box[:4])
        cv2.rectangle(self.im, (x1, y1), (x2, y2), color, self.lw)
        if label:
            cv2.putText(self.im, str(label), (x1, max(12, y1 - 4)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.45, color, 1)

    def draw_centroid_and_tracks(self, track_line, color=(255, 0, 255),
                                 track_thickness=None):
        import cv2

        if len(track_line) > 1:
            pts = np.asarray(track_line, np.int32).reshape(-1, 1, 2)
            cv2.polylines(self.im, [pts], False, color,
                          track_thickness or self.lw)
        cx, cy = (int(v) for v in track_line[-1])
        cv2.circle(self.im, (cx, cy), 3 * self.lw, color, -1)

    def text_block(self, lines, origin=(10, 24), txt_color=(104, 31, 17),
                   bg_color=(255, 255, 255)):
        import cv2

        x, y = origin
        for ln in lines:
            (tw, th), _ = cv2.getTextSize(ln, cv2.FONT_HERSHEY_SIMPLEX, 0.55, 1)
            cv2.rectangle(self.im, (x - 4, y - th - 4), (x + tw + 4, y + 4),
                          bg_color, -1)
            cv2.putText(self.im, ln, (x, y), cv2.FONT_HERSHEY_SIMPLEX, 0.55,
                        txt_color, 1)
            y += th + 12

    def display_analytics(self, labels_dict, txt_color=(104, 31, 17),
                          bg_color=(255, 255, 255)):
        self.text_block([f"{k}: {v}" for k, v in labels_dict.items()],
                        txt_color=txt_color, bg_color=bg_color)

    def queue_counts_display(self, text, points=None, region_color=(255, 255, 255),
                             txt_color=(104, 31, 17)):
        origin = (10, 24)
        if points:
            cx, cy = polygon_centroid(points)
            origin = (max(10, int(cx) - 40), max(24, int(cy)))
        self.text_block([text], origin=origin, txt_color=txt_color,
                        bg_color=region_color)


# -- base solution -----------------------------------------------------------

DEFAULT_REGION = [(20, 400), (1080, 404), (1080, 360), (20, 360)]


class BaseSolution:
    """Region + track-history bookkeeping shared by the apps
    (reference solutions.py:18-95)."""

    def __init__(self, region=None, line_width: int = 2,
                 classes: list[int] | None = None,
                 names: dict | None = None):
        self.region = ([tuple(map(float, p)) for p in region]
                       if region is not None else None)
        self.line_width = line_width
        self.classes = set(classes) if classes else None
        self.names = names or {}
        self.track_history: dict[int, list] = defaultdict(list)
        self.track_line: list = []

    def initialize_region(self):
        if self.region is None:
            self.region = [tuple(map(float, p)) for p in DEFAULT_REGION]

    def label_for(self, cls: int) -> str:
        return str(self.names.get(int(cls), int(cls)))

    def extract_tracks(self, results):
        """Results -> (boxes xyxy, track_ids, clss); class-filtered. Rows
        without track ids yield an empty triple like the reference's
        'no tracks found' branch."""
        boxes = results.boxes
        if boxes is None or boxes.id is None:
            self.boxes, self.track_ids, self.clss = [], [], []
            return
        out_b, out_i, out_c = [], [], []
        for row in np.asarray(boxes.data, np.float64):
            cls = int(row[-1])
            if self.classes is not None and cls not in self.classes:
                continue
            out_b.append(row[:4])
            out_i.append(int(row[4]))
            out_c.append(cls)
        self.boxes, self.track_ids, self.clss = out_b, out_i, out_c

    def store_tracking_history(self, track_id, box):
        """30-point centroid history (reference solutions.py:63-77)."""
        self.track_line = self.track_history[track_id]
        self.track_line.append(((box[0] + box[2]) / 2, (box[1] + box[3]) / 2))
        if len(self.track_line) > 30:
            self.track_line.pop(0)
