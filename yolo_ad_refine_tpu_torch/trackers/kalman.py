"""Kalman filter for box tracking.

Counterpart of ``yolo_ad_refine_tpu/trackers/kalman.py`` (reference
trackers/utils/kalman_filter.py): a constant-velocity model over the
measurement space (x, y, a, h), centre, aspect ratio and height, the
SORT / ByteTrack formulation. Host numpy.
"""

from __future__ import annotations

import numpy as np


class KalmanFilterXYAH:
    """8-dim state (x, y, a, h, vx, vy, va, vh), 4-dim measurement."""

    def __init__(self):
        ndim, dt = 4, 1.0
        self._motion_mat = np.eye(2 * ndim)
        for i in range(ndim):
            self._motion_mat[i, ndim + i] = dt
        self._update_mat = np.eye(ndim, 2 * ndim)
        # motion/observation uncertainty weights (reference values)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    def initiate(self, measurement: np.ndarray):
        mean_pos = measurement
        mean_vel = np.zeros_like(mean_pos)
        mean = np.r_[mean_pos, mean_vel]
        std = [
            2 * self._std_weight_position * measurement[3],
            2 * self._std_weight_position * measurement[3],
            1e-2,
            2 * self._std_weight_position * measurement[3],
            10 * self._std_weight_velocity * measurement[3],
            10 * self._std_weight_velocity * measurement[3],
            1e-5,
            10 * self._std_weight_velocity * measurement[3],
        ]
        covariance = np.diag(np.square(std))
        return mean, covariance

    def predict(self, mean: np.ndarray, covariance: np.ndarray):
        std_pos = [
            self._std_weight_position * mean[3],
            self._std_weight_position * mean[3],
            1e-2,
            self._std_weight_position * mean[3],
        ]
        std_vel = [
            self._std_weight_velocity * mean[3],
            self._std_weight_velocity * mean[3],
            1e-5,
            self._std_weight_velocity * mean[3],
        ]
        motion_cov = np.diag(np.square(np.r_[std_pos, std_vel]))
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def project(self, mean: np.ndarray, covariance: np.ndarray):
        std = [
            self._std_weight_position * mean[3],
            self._std_weight_position * mean[3],
            1e-1,
            self._std_weight_position * mean[3],
        ]
        innovation_cov = np.diag(np.square(std))
        mean = self._update_mat @ mean
        covariance = self._update_mat @ covariance @ self._update_mat.T
        return mean, covariance + innovation_cov

    def update(self, mean: np.ndarray, covariance: np.ndarray, measurement: np.ndarray):
        projected_mean, projected_cov = self.project(mean, covariance)
        chol = np.linalg.cholesky(projected_cov)
        kalman_gain = np.linalg.solve(
            chol.T, np.linalg.solve(chol, (covariance @ self._update_mat.T).T)
        ).T
        innovation = measurement - projected_mean
        new_mean = mean + kalman_gain @ innovation
        new_cov = covariance - kalman_gain @ projected_cov @ kalman_gain.T
        return new_mean, new_cov

    def multi_predict(self, means: np.ndarray, covariances: np.ndarray):
        """Vectorized predict over N tracks (reference kalman_filter.py multi_predict)."""
        if len(means) == 0:
            return means, covariances
        std_pos = np.stack([
            self._std_weight_position * means[:, 3],
            self._std_weight_position * means[:, 3],
            np.full(len(means), 1e-2),
            self._std_weight_position * means[:, 3],
        ], axis=1)
        std_vel = np.stack([
            self._std_weight_velocity * means[:, 3],
            self._std_weight_velocity * means[:, 3],
            np.full(len(means), 1e-5),
            self._std_weight_velocity * means[:, 3],
        ], axis=1)
        sqr = np.square(np.concatenate([std_pos, std_vel], axis=1))
        means = means @ self._motion_mat.T
        out_cov = []
        for i in range(len(means)):
            out_cov.append(
                self._motion_mat @ covariances[i] @ self._motion_mat.T + np.diag(sqr[i])
            )
        return means, np.asarray(out_cov)
