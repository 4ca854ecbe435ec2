"""BYTETracker: two-stage IoU association over Kalman-predicted tracks.

Counterpart of ``yolo_ad_refine_tpu/trackers/byte_tracker.py`` (reference
trackers/byte_tracker.py:235, the STrack state machine, and
trackers/utils/matching.py iou_distance / linear_assignment). Per frame:

1. split the detections into a high (>= track_high_thresh) and a low
   confidence band (between track_low_thresh and it),
2. match the high band to the active and lost tracks by IoU (fused with
   the score),
3. match the tracks left to the low band (the "BYTE" step),
4. match the unconfirmed tracks, start new tracks at new_track_thresh,
5. drop tracks lost for longer than track_buffer frames.

Host numpy and scipy: the assignment is ``scipy.optimize.
linear_sum_assignment``, as in the JAX package, not the port's LAP kernel
(``ops/lap.py``), whose tie rule is the JAX device LAP's. Track ids come
from ``STrack``'s class counter, which a new tracker resets.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize

from yolo_ad_refine_tpu_torch.trackers.kalman import KalmanFilterXYAH
from yolo_ad_refine_tpu_torch.utils.metrics import box_iou_np


class TrackState:
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


def linear_assignment(cost: np.ndarray, thresh: float):
    """Hungarian assignment with cost gate (reference matching.py:linear_assignment)."""
    if cost.size == 0:
        return (np.empty((0, 2), int), tuple(range(cost.shape[0])), tuple(range(cost.shape[1])))
    rows, cols = scipy.optimize.linear_sum_assignment(cost)
    matches = [[r, c] for r, c in zip(rows, cols) if cost[r, c] <= thresh]
    matched_r = {m[0] for m in matches}
    matched_c = {m[1] for m in matches}
    unmatched_r = tuple(i for i in range(cost.shape[0]) if i not in matched_r)
    unmatched_c = tuple(i for i in range(cost.shape[1]) if i not in matched_c)
    return np.asarray(matches, int).reshape(-1, 2), unmatched_r, unmatched_c


def iou_distance(atracks: list, btracks: list) -> np.ndarray:
    if not atracks or not btracks:
        return np.zeros((len(atracks), len(btracks)), np.float32)
    a = np.stack([t.xyxy for t in atracks])
    b = np.stack([t.xyxy for t in btracks])
    return 1.0 - box_iou_np(a, b)


def fuse_score(cost: np.ndarray, detections: list) -> np.ndarray:
    """Fuse detection confidence into the IoU cost (reference matching.py:fuse_score)."""
    if cost.size == 0:
        return cost
    iou_sim = 1.0 - cost
    det_scores = np.array([d.score for d in detections])[None].repeat(cost.shape[0], 0)
    return 1.0 - iou_sim * det_scores


class STrack:
    """Single tracked object (reference byte_tracker.py:17-233)."""

    shared_kalman = KalmanFilterXYAH()
    _count = 0

    def __init__(self, xywh, score, cls):
        # xywh: center-based box
        self._tlwh = np.asarray(
            [xywh[0] - xywh[2] / 2, xywh[1] - xywh[3] / 2, xywh[2], xywh[3]], np.float32
        )
        self.kalman_filter = None
        self.mean, self.covariance = None, None
        self.is_activated = False
        self.score = float(score)
        self.cls = int(cls)
        self.idx = -1
        self.tracklet_len = 0
        self.state = TrackState.New
        self.track_id = 0
        self.frame_id = 0
        self.start_frame = 0

    @staticmethod
    def next_id():
        STrack._count += 1
        return STrack._count

    @staticmethod
    def reset_id():
        STrack._count = 0

    # -- geometry ------------------------------------------------------------
    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()  # x, y, a, h
        ret[2] *= ret[3]  # w = a*h
        ret[:2] -= ret[2:] / 2
        return ret

    @property
    def xyxy(self):
        t = self.tlwh
        return np.asarray([t[0], t[1], t[0] + t[2], t[1] + t[3]], np.float32)

    @property
    def xywh(self):
        t = self.tlwh
        return np.asarray([t[0] + t[2] / 2, t[1] + t[3] / 2, t[2], t[3]], np.float32)

    def _to_xyah(self, tlwh):
        ret = np.asarray(tlwh, np.float32).copy()
        ret[:2] += ret[2:] / 2
        ret[2] /= ret[3]
        return ret

    # -- state machine ---------------------------------------------------------
    def activate(self, kalman_filter, frame_id):
        self.kalman_filter = kalman_filter
        self.track_id = self.next_id()
        self.mean, self.covariance = kalman_filter.initiate(self._to_xyah(self._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = frame_id == 1
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(self, new_track, frame_id, new_id=False):
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self._to_xyah(new_track._tlwh)
        )
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        if new_id:
            self.track_id = self.next_id()
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def update(self, new_track, frame_id):
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self._to_xyah(new_track._tlwh)
        )
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def predict(self):
        mean = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean[7] = 0
        self.mean, self.covariance = self.kalman_filter.predict(mean, self.covariance)

    @staticmethod
    def multi_predict(tracks):
        if not tracks:
            return
        means = np.stack([t.mean.copy() for t in tracks])
        covs = np.stack([t.covariance for t in tracks])
        for i, t in enumerate(tracks):
            if t.state != TrackState.Tracked:
                means[i][7] = 0
        means, covs = STrack.shared_kalman.multi_predict(means, covs)
        for t, m, c in zip(tracks, means, covs):
            t.mean, t.covariance = m, c

    def mark_lost(self):
        self.state = TrackState.Lost

    def mark_removed(self):
        self.state = TrackState.Removed

    @property
    def end_frame(self):
        return self.frame_id

    @property
    def result(self):
        """[x1, y1, x2, y2, track_id, score, cls, det_idx] row."""
        return [*self.xyxy.tolist(), self.track_id, self.score, self.cls, self.idx]


class BYTETracker:
    """Frame-by-frame tracker over detection outputs."""

    def __init__(self, track_high_thresh=0.25, track_low_thresh=0.1, new_track_thresh=0.25,
                 track_buffer=30, match_thresh=0.8, fuse_score_flag=True, frame_rate=30):
        self.tracked_stracks: list[STrack] = []
        self.lost_stracks: list[STrack] = []
        self.removed_stracks: list[STrack] = []
        self.frame_id = 0
        self.track_high_thresh = track_high_thresh
        self.track_low_thresh = track_low_thresh
        self.new_track_thresh = new_track_thresh
        self.match_thresh = match_thresh
        self.fuse_score_flag = fuse_score_flag
        self.max_time_lost = int(frame_rate / 30.0 * track_buffer)
        self.kalman_filter = self.get_kalmanfilter()
        STrack.reset_id()

    def get_kalmanfilter(self):
        return KalmanFilterXYAH()

    def init_track(self, xywhs, scores, clses, img=None):
        return [STrack(xywh, s, c) for xywh, s, c in zip(xywhs, scores, clses)]

    def get_dists(self, tracks, detections):
        dists = iou_distance(tracks, detections)
        if self.fuse_score_flag:
            dists = fuse_score(dists, detections)
        return dists

    def multi_predict(self, tracks):
        STrack.multi_predict(tracks)

    def update(self, boxes_xyxy: np.ndarray, scores: np.ndarray, clses: np.ndarray,
               img=None) -> np.ndarray:
        """One frame. Returns (n, 8) [x1,y1,x2,y2,id,score,cls,det_idx]."""
        self.frame_id += 1
        xywhs = np.concatenate(
            [(boxes_xyxy[:, :2] + boxes_xyxy[:, 2:4]) / 2, boxes_xyxy[:, 2:4] - boxes_xyxy[:, :2]],
            axis=1,
        ) if len(boxes_xyxy) else np.zeros((0, 4), np.float32)

        remain = scores >= self.track_high_thresh
        low = (scores > self.track_low_thresh) & (scores < self.track_high_thresh)
        dets_high = self.init_track(xywhs[remain], scores[remain], clses[remain], img)
        for i, d in zip(np.nonzero(remain)[0], dets_high):
            d.idx = int(i)
        dets_low = self.init_track(xywhs[low], scores[low], clses[low], img)
        for i, d in zip(np.nonzero(low)[0], dets_low):
            d.idx = int(i)

        unconfirmed = [t for t in self.tracked_stracks if not t.is_activated]
        tracked = [t for t in self.tracked_stracks if t.is_activated]
        strack_pool = joint_stracks(tracked, self.lost_stracks)
        self.multi_predict(strack_pool)

        # stage 1: high-confidence association
        dists = self.get_dists(strack_pool, dets_high)
        matches, u_track, u_det = linear_assignment(dists, self.match_thresh)
        activated, refind, lost, removed = [], [], [], []
        for it, idet in matches:
            track, det = strack_pool[it], dets_high[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id, new_id=False)
                refind.append(track)

        # stage 2: low-confidence (BYTE)
        r_tracked = [strack_pool[i] for i in u_track if strack_pool[i].state == TrackState.Tracked]
        dists = iou_distance(r_tracked, dets_low)
        matches, u_track2, _ = linear_assignment(dists, 0.5)
        for it, idet in matches:
            track, det = r_tracked[it], dets_low[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id, new_id=False)
                refind.append(track)
        for i in u_track2:
            track = r_tracked[i]
            if track.state != TrackState.Lost:
                track.mark_lost()
                lost.append(track)

        # unconfirmed tracks
        dets_left = [dets_high[i] for i in u_det]
        dists = self.get_dists(unconfirmed, dets_left)
        matches, u_unconf, u_det2 = linear_assignment(dists, 0.7)
        for it, idet in matches:
            unconfirmed[it].update(dets_left[idet], self.frame_id)
            activated.append(unconfirmed[it])
        for i in u_unconf:
            unconfirmed[i].mark_removed()
            removed.append(unconfirmed[i])

        # new tracks
        for i in u_det2:
            det = dets_left[i]
            if det.score >= self.new_track_thresh:
                det.activate(self.kalman_filter, self.frame_id)
                activated.append(det)

        # prune
        for track in self.lost_stracks:
            if self.frame_id - track.end_frame > self.max_time_lost:
                track.mark_removed()
                removed.append(track)

        self.tracked_stracks = [t for t in self.tracked_stracks if t.state == TrackState.Tracked]
        self.tracked_stracks = joint_stracks(self.tracked_stracks, activated)
        self.tracked_stracks = joint_stracks(self.tracked_stracks, refind)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.tracked_stracks)
        self.lost_stracks.extend(lost)
        self.lost_stracks = sub_stracks(self.lost_stracks, removed)
        self.tracked_stracks, self.lost_stracks = remove_duplicate_stracks(
            self.tracked_stracks, self.lost_stracks
        )
        self.removed_stracks.extend(removed)
        self.removed_stracks = self.removed_stracks[-1000:]

        out = [t.result for t in self.tracked_stracks if t.is_activated]
        return np.asarray(out, np.float32).reshape(-1, 8)

    def reset(self):
        self.__init__(self.track_high_thresh, self.track_low_thresh, self.new_track_thresh,
                      self.max_time_lost, self.match_thresh, self.fuse_score_flag)


def joint_stracks(a: list, b: list) -> list:
    seen = {t.track_id for t in a}
    return a + [t for t in b if t.track_id not in seen]


def sub_stracks(a: list, b: list) -> list:
    ids = {t.track_id for t in b}
    return [t for t in a if t.track_id not in ids]


def remove_duplicate_stracks(a: list, b: list):
    dist = iou_distance(a, b)
    pairs = np.nonzero(dist < 0.15)
    dup_a, dup_b = set(), set()
    for p, q in zip(*pairs):
        if a[p].frame_id - a[p].start_frame > b[q].frame_id - b[q].start_frame:
            dup_b.add(q)
        else:
            dup_a.add(p)
    return ([t for i, t in enumerate(a) if i not in dup_a],
            [t for i, t in enumerate(b) if i not in dup_b])
