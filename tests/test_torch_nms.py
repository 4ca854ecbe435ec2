"""NMS of the PyTorch port against the JAX package, exactly.

The keep mask and the (max_det, 6) detections must be bit-equal to JAX's
``non_max_suppression(use_pallas=False)``, and the port's suppression must
equal the TPU kernel K4 (``suppress_pallas``) run in interpret mode. The
rotated branch's rows are held within 1e-5 (its probiou takes exp / log
from another library); its kernel-level checks are in test_torch_obb.py. Inputs
include tied scores (the common case with freshly initialised weights),
dense overlaps and candidate counts that are not multiples of 64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_ad_refine_tpu.ops.nms import non_max_suppression as jax_nms
from yolo_ad_refine_tpu.ops.nms_pallas import suppress_pallas
from yolo_ad_refine_tpu_torch.ops.nms import non_max_suppression, suppress, suppress_plain

NC = 6


def _prediction(seed, n, b=2, ties=False, dense=False):
    r = np.random.default_rng(seed)
    if dense:  # many boxes around a few centers
        centers = r.uniform(60, 260, (5, 2))
        xy = centers[r.integers(0, 5, (b, n))] + r.normal(0, 4, (b, n, 2))
        wh = r.uniform(20, 40, (b, n, 2))
    else:
        xy = r.uniform(0, 320, (b, n, 2))
        wh = r.uniform(4, 80, (b, n, 2))
    scores = r.random((b, n, NC))
    if ties:
        scores = np.round(scores * 8) / 8  # a handful of distinct values
    return np.concatenate([xy, wh, scores], -1).astype(np.float32)


CASES = [  # (seed, anchors N, max_nms, ties, dense, conf, iou)
    (0, 300, 2048, False, False, 0.25, 0.45),
    (1, 300, 2048, True, True, 0.25, 0.45),
    (2, 1000, 2048, True, False, 0.001, 0.7),   # K = 1000, not a multiple of 64
    (3, 2600, 2048, False, True, 0.001, 0.7),   # K = 2048
    (4, 2600, 2048, True, True, 0.1, 0.5),
]


@pytest.mark.parametrize("seed,n,max_nms,ties,dense,conf,iou", CASES)
def test_nms_matches_jax_exactly(seed, n, max_nms, ties, dense, conf, iou):
    pred = _prediction(seed, n, ties=ties, dense=dense)
    jdet, jcnt, _ = jax_nms(jnp.asarray(pred), conf_thres=conf, iou_thres=iou, max_nms=max_nms,
                            nc=NC, use_pallas=False)
    det, cnt, _ = non_max_suppression(torch.from_numpy(pred), conf_thres=conf, iou_thres=iou,
                                      max_nms=max_nms, nc=NC)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(det.numpy(), np.asarray(jdet))
    assert cnt.min() > 0


def _candidates(seed, k, ties):
    r = np.random.default_rng(seed)
    cxy = r.uniform(0, 200, (2, k, 2))
    wh = r.uniform(4, 60, (2, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    s = r.random((2, k))
    if ties:
        s = np.round(s * 4) / 4
    return boxes, np.sort(s, axis=1)[:, ::-1].astype(np.float32).copy()


@pytest.mark.parametrize("k,ties", [(300, False), (300, True), (2048, True)])
def test_suppress_matches_tpu_kernel_interpret(k, ties):
    boxes, scores = _candidates(k, k, ties)
    got = suppress_plain(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, 0.25).numpy()
    for i in range(2):
        want = np.asarray(suppress_pallas(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.45,
                                          0.25, interpret=True))
        np.testing.assert_array_equal(got[i], want)
        assert 0 < want.sum() < k


def test_suppress_on_cpu_launches_nothing():
    boxes, scores = _candidates(9, 200, False)
    launches = suppress.launches
    keep = suppress(torch.from_numpy(boxes), torch.from_numpy(scores), 0.45, 0.25)
    assert keep.dtype == torch.bool and keep.shape == (2, 200)
    assert suppress.launches == launches


@pytest.mark.parametrize("seed,n,conf,iou", [(5, 300, 0.25, 0.45), (6, 1000, 0.001, 0.7)])
def test_rotated_nms_matches_jax(seed, n, conf, iou):
    """The rotated branch (probiou suppression, K5 on the card): the same
    counts, rows and carried angles as JAX's, candidates from the
    axis-aligned cases above with an angle column."""
    pred = _prediction(seed, n, dense=seed % 2 == 0)
    ang = np.random.default_rng(seed).uniform(-np.pi / 4, 3 * np.pi / 4, (*pred.shape[:2], 1))
    pred = np.concatenate([pred, ang.astype(np.float32)], -1)
    jdet, jcnt, jext = jax_nms(jnp.asarray(pred), conf_thres=conf, iou_thres=iou, nc=NC,
                               rotated=True, use_pallas=False)
    det, cnt, ext = non_max_suppression(torch.from_numpy(pred), conf_thres=conf, iou_thres=iou,
                                        nc=NC, rotated=True)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(det.numpy(), np.asarray(jdet), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ext.numpy(), np.asarray(jext))
    assert cnt.min() > 0
