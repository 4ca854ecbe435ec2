"""Global (camera) motion compensation for BOT-SORT.

Counterpart of ``yolo_ad_refine_tpu/trackers/gmc.py`` (reference
trackers/utils/gmc.py, its default sparseOptFlow method): corners
(goodFeaturesToTrack) followed by pyramidal Lucas-Kanade flow, and a
partial affine fitted by RANSAC, which draws from cv2's global random
generator (``cv2.setRNGSeed`` fixes it). Host cv2.
"""

from __future__ import annotations

import cv2
import numpy as np


class GMC:
    def __init__(self, method: str = "sparseOptFlow", downscale: int = 2):
        self.method = method
        self.downscale = max(1, int(downscale))
        self.prev_gray = None
        self.prev_pts = None

    def apply(self, raw_frame: np.ndarray) -> np.ndarray:
        """Returns 2x3 affine H mapping previous frame coords -> current."""
        if self.method in ("none", None):
            return np.eye(2, 3)
        h, w = raw_frame.shape[:2]
        gray = cv2.cvtColor(raw_frame, cv2.COLOR_BGR2GRAY) if raw_frame.ndim == 3 else raw_frame
        if self.downscale > 1:
            gray = cv2.resize(gray, (w // self.downscale, h // self.downscale))

        H = np.eye(2, 3)
        if self.prev_gray is None:
            self.prev_gray = gray
            self.prev_pts = cv2.goodFeaturesToTrack(
                gray, maxCorners=200, qualityLevel=0.01, minDistance=1, blockSize=3
            )
            return H

        if self.prev_pts is None or len(self.prev_pts) < 4:
            self.prev_pts = cv2.goodFeaturesToTrack(
                self.prev_gray, maxCorners=200, qualityLevel=0.01, minDistance=1, blockSize=3
            )
        if self.prev_pts is not None and len(self.prev_pts) >= 4:
            next_pts, status, _ = cv2.calcOpticalFlowPyrLK(self.prev_gray, gray,
                                                           self.prev_pts, None)
            if next_pts is not None:
                good_prev = self.prev_pts[status.flatten() == 1]
                good_next = next_pts[status.flatten() == 1]
                if len(good_prev) >= 4:
                    m, _ = cv2.estimateAffinePartial2D(good_prev, good_next, cv2.RANSAC)
                    if m is not None:
                        H = m
                        if self.downscale > 1:
                            H[0, 2] *= self.downscale
                            H[1, 2] *= self.downscale

        self.prev_gray = gray
        self.prev_pts = cv2.goodFeaturesToTrack(
            gray, maxCorners=200, qualityLevel=0.01, minDistance=1, blockSize=3
        )
        return H

    def reset(self):
        self.prev_gray = None
        self.prev_pts = None
