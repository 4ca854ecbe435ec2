"""BOT-SORT tracker: BYTE with camera-motion compensation (and ReID hooks).

Counterpart of ``yolo_ad_refine_tpu/trackers/bot_sort.py`` (reference
trackers/bot_sort.py BOTrack / BOTSORT): the tracks' Kalman states warped
by the GMC affine before the association, the IoU cost gated by
proximity_thresh, and, with ``with_reid`` and an ``encoder``, an
appearance cost (the reference's default config has with_reid=False).
"""

from __future__ import annotations

import numpy as np

from yolo_ad_refine_tpu_torch.trackers.byte_tracker import (
    BYTETracker,
    STrack,
    TrackState,
    fuse_score,
    iou_distance,
)
from yolo_ad_refine_tpu_torch.trackers.gmc import GMC
from yolo_ad_refine_tpu_torch.trackers.kalman import KalmanFilterXYAH


class BOTrack(STrack):
    shared_kalman = KalmanFilterXYAH()

    @staticmethod
    def multi_gmc(tracks: list, H: np.ndarray):
        """Warp track states by the camera-motion affine (reference bot_sort.py:multi_gmc)."""
        if not tracks:
            return
        R = H[:2, :2]
        R8 = np.kron(np.eye(4), R)
        t = H[:2, 2]
        for track in tracks:
            mean = R8 @ track.mean
            mean[:2] += t
            track.mean = mean
            track.covariance = R8 @ track.covariance @ R8.T


class BOTSORT(BYTETracker):
    def __init__(self, proximity_thresh=0.5, appearance_thresh=0.25, with_reid=False,
                 gmc_method="sparseOptFlow", encoder=None, **kwargs):
        super().__init__(**kwargs)
        self.proximity_thresh = proximity_thresh
        self.appearance_thresh = appearance_thresh
        self.with_reid = with_reid
        self.encoder = encoder
        self.gmc = GMC(method=gmc_method)

    def init_track(self, xywhs, scores, clses, img=None):
        return [BOTrack(xywh, s, c) for xywh, s, c in zip(xywhs, scores, clses)]

    def get_dists(self, tracks, detections):
        dists = iou_distance(tracks, detections)
        dists_mask = dists > (1 - self.proximity_thresh)
        dists = fuse_score(dists, detections)
        if self.with_reid and self.encoder is not None and tracks and detections:
            emb = np.stack([getattr(t, "feat", np.zeros(1)) for t in tracks])
            demb = np.stack([getattr(d, "feat", np.zeros(1)) for d in detections])
            sim = emb @ demb.T / (
                np.linalg.norm(emb, axis=1, keepdims=True)
                * np.linalg.norm(demb, axis=1, keepdims=True).T + 1e-9
            )
            emb_dists = (1.0 - sim) / 2.0
            emb_dists[emb_dists > self.appearance_thresh] = 1.0
            dists = np.minimum(dists, emb_dists)
        dists[dists_mask] = 1.0
        return dists

    def update(self, boxes_xyxy, scores, clses, img=None):
        if img is not None:
            H = self.gmc.apply(img)
            BOTrack.multi_gmc(self.tracked_stracks, H)
            BOTrack.multi_gmc(self.lost_stracks, H)
        return super().update(boxes_xyxy, scores, clses, img)

    def reset(self):
        super().reset()
        self.gmc.reset()
