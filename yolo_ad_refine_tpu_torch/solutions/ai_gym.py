"""Workout repetition monitoring from pose keypoints.

Parity surface: reference solutions/ai_gym.py AIGym.monitor — per tracked
person, estimate the joint angle over three user-selected keypoints, drive
an up/down stage machine with configurable angle thresholds, and count a
repetition on each up->down transition.

Counterpart of ``yolo_ad_refine_tpu/solutions/ai_gym.py``: the same
host-side code over the port's ``Results``.
"""

from __future__ import annotations

import numpy as np


def estimate_pose_angle(a, b, c) -> float:
    """Angle at vertex b (degrees, 0-180) formed by points a-b-c (reference
    plotting.py Annotator.estimate_pose_angle)."""
    a, b, c = (np.asarray(p, np.float64)[:2] for p in (a, b, c))
    radians = np.arctan2(c[1] - b[1], c[0] - b[0]) - np.arctan2(a[1] - b[1], a[0] - b[0])
    angle = abs(radians * 180.0 / np.pi)
    return 360.0 - angle if angle > 180.0 else angle


class AIGym:
    """Counts exercise repetitions per tracked person.

    kpts: indices of the three keypoints forming the monitored joint
    (e.g. (5, 7, 9) = left shoulder-elbow-wrist for curls, the reference's
    cfg/solutions default). up_angle/down_angle: stage thresholds.
    """

    def __init__(self, kpts=(5, 7, 9), up_angle: float = 145.0,
                 down_angle: float = 90.0):
        self.kpts = tuple(int(k) for k in kpts)
        self.up_angle = float(up_angle)
        self.down_angle = float(down_angle)
        self.count: dict[int, int] = {}
        self.stage: dict[int, str] = {}
        self.angle: dict[int, float] = {}

    def update(self, results) -> dict:
        """Feed one frame's pose Results (track ids + keypoints required)."""
        boxes = results.boxes
        kps = getattr(results, "keypoints", None)
        if boxes is None or boxes.id is None or kps is None:
            return self.summary()
        ids = np.asarray(boxes.id).astype(int)
        data = np.asarray(kps.data)  # (n, K, 2|3)
        for tid, k in zip(ids, data):
            a, b, c = (k[i] for i in self.kpts)
            ang = estimate_pose_angle(a, b, c)
            self.angle[tid] = ang
            stage = self.stage.get(tid, "-")
            if ang < self.down_angle:
                if stage == "up":
                    self.count[tid] = self.count.get(tid, 0) + 1
                self.stage[tid] = "down"
            elif ang > self.up_angle:
                self.stage[tid] = "up"
        return self.summary()

    def summary(self) -> dict:
        return {"count": dict(self.count), "stage": dict(self.stage),
                "angle": {k: round(v, 2) for k, v in self.angle.items()}}
