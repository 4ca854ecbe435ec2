"""The oriented-box (OBB) modules of the PyTorch port against the JAX package.

Tolerances: probiou and the OBB head within 1e-6 abs (the same fp32 ops;
only exp / log / cos / sin come from other libraries, last-ulp apart);
keep masks of the rotated suppression exactly equal to JAX's
``_suppress_rotated`` and to the TPU kernel K5 (``suppress_rotated_pallas``)
run in interpret mode; NMS rows within 1e-5 (the detection rows are the
same gathered floats, the test allows for a library's last ulp). Each
suppression case asserts first that no live pair's probiou lies within
1e-5 of ``iou_thres``: there, exp / log rounding could decide a pair
differently, and such a tie would not be a fault of either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import randomize, transfer
from yolo_ad_refine_tpu.data.dataset import xyxyxyxy2xywhr_np as jax_xyxyxyxy2xywhr
from yolo_ad_refine_tpu.engine.results import OBBoxes as JaxOBBoxes
from yolo_ad_refine_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_ad_refine_tpu.nn.head import OBB as JaxOBB
from yolo_ad_refine_tpu.nn.head import dist2rbox as jax_dist2rbox
from yolo_ad_refine_tpu.ops.iou import batch_probiou as jax_batch_probiou
from yolo_ad_refine_tpu.ops.iou import probiou as jax_probiou
from yolo_ad_refine_tpu.ops.nms import _suppress_rotated
from yolo_ad_refine_tpu.ops.nms import non_max_suppression as jax_nms
from yolo_ad_refine_tpu.ops.nms_pallas import suppress_rotated_pallas
from yolo_ad_refine_tpu.utils.metrics import ConfusionMatrix as JaxConfusion
from yolo_ad_refine_tpu.utils.metrics import DetMetrics as JaxDetMetrics
from yolo_ad_refine_tpu.utils.metrics_np import probiou_np as jax_probiou_np
from yolo_ad_refine_tpu_torch.data.dataset import xyxyxyxy2xywhr_np
from yolo_ad_refine_tpu_torch.engine.results import OBBoxes, Results
from yolo_ad_refine_tpu_torch.engine.validator import DetectionValidator
from yolo_ad_refine_tpu_torch.nn.head import OBB, dist2rbox
from yolo_ad_refine_tpu_torch.ops.iou import batch_probiou, probiou
from yolo_ad_refine_tpu_torch.ops.nms import (
    non_max_suppression, rotated_rounding_ties, suppress_rotated, suppress_rotated_plain)
from yolo_ad_refine_tpu_torch.utils.metrics import ConfusionMatrix, DetMetrics, probiou_np

NC = 5
MAX_WH = 7680.0


def _xywhr(r, shape, lo=4.0, hi=80.0, span=300.0):
    xy = r.uniform(0, span, (*shape, 2))
    wh = r.uniform(lo, hi, (*shape, 2))
    ang = r.uniform(-np.pi / 4, 3 * np.pi / 4, (*shape, 1))
    return np.concatenate([xy, wh, ang], -1).astype(np.float32)


def test_probiou_matches_jax():
    r = np.random.default_rng(0)
    a, b = _xywhr(r, (64,)), _xywhr(r, (64,))
    b[:16] = a[:16] + r.normal(0, 2, (16, 5)).astype(np.float32)  # overlapping pairs
    for ciou in (False, True):
        want = np.asarray(jax_probiou(jnp.asarray(a), jnp.asarray(b), CIoU=ciou))
        got = probiou(torch.from_numpy(a), torch.from_numpy(b), CIoU=ciou).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    want = np.asarray(jax_batch_probiou(jnp.asarray(a), jnp.asarray(b)))
    got = batch_probiou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (64, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert want.max() > 0.5  # the overlapping pairs are there


def _candidates(seed, k, dense=False, ties=False, low=False):
    """(2, K, 5) score-sorted xywhr with class-offset centres, scores (2, K)."""
    r = np.random.default_rng(seed)
    if dense:  # many rotated boxes around a few centres, similar sizes
        centres = r.uniform(60, 260, (6, 2))
        rb = _xywhr(r, (2, k), 30.0, 50.0)
        rb[..., :2] = centres[r.integers(0, 6, (2, k))] + r.normal(0, 5, (2, k, 2))
    else:
        rb = _xywhr(r, (2, k))
    rb[..., :2] += (r.integers(0, 3, (2, k, 1)) * MAX_WH).astype(np.float32)
    s = r.random((2, k))
    if ties:
        s = np.round(s * 8) / 8
    if low:  # a third of the candidates under conf
        s = s * 0.4
    return rb.astype(np.float32), np.sort(s, axis=1)[:, ::-1].astype(np.float32).copy()


def _assert_no_tie(rb, scores, iou_thres, conf_thres):
    t = torch.from_numpy(rb)
    iou = probiou(t[:, :, None], t[:, None, :]).numpy()
    k = rb.shape[1]
    live = (scores > conf_thres)[:, :, None] & np.triu(np.ones((k, k), bool), 1)
    assert np.abs(iou - iou_thres)[live].min() > 1e-5


SUPPRESS_CASES = [  # (seed, K, dense, ties, low, iou, conf)
    (0, 256, False, False, False, 0.45, 0.25),
    (1, 200, False, True, False, 0.45, 0.25),   # ragged: K not a multiple of 64 or 128
    (2, 256, True, False, False, 0.7, 0.001),   # dense overlaps
    (3, 200, True, True, True, 0.5, 0.25),      # dense, ties, a third under conf
]


@pytest.mark.parametrize("seed,k,dense,ties,low,iou,conf", SUPPRESS_CASES)
def test_suppress_rotated_matches_jax_and_tpu_kernel(seed, k, dense, ties, low, iou, conf):
    rb, scores = _candidates(seed, k, dense, ties, low)
    _assert_no_tie(rb, scores, iou, conf)
    got = suppress_rotated_plain(torch.from_numpy(rb), torch.from_numpy(scores), iou, conf).numpy()
    for i in range(2):
        want = np.asarray(_suppress_rotated(jnp.asarray(rb[i]), jnp.asarray(scores[i]), iou, conf))
        np.testing.assert_array_equal(got[i], want)
        pallas = np.asarray(suppress_rotated_pallas(jnp.asarray(rb[i]), jnp.asarray(scores[i]),
                                                    iou, conf, interpret=True))
        np.testing.assert_array_equal(got[i], pallas)
        assert 0 < want.sum() < (scores[i] > conf).sum()  # suppression happened


def _tie_case():
    """Three boxes: 1 overlaps 0 at exactly iou_thres (a tie), 2 overlaps 1
    above it and 0 far below it. The plain walk keeps 0 and 1 and drops 2."""
    rb = torch.tensor([[[100.0, 100.0, 40.0, 20.0, 0.3], [108.0, 102.0, 40.0, 20.0, 0.35],
                        [111.0, 103.0, 40.0, 20.0, 0.35]]])
    scores = torch.tensor([[0.9, 0.8, 0.7]])
    iou = probiou(rb[:, :, None], rb[:, None, :])[0]
    thres = float(iou[0, 1])
    assert iou[1, 2] > thres + 1e-4 and iou[0, 2] < thres - 1e-4
    want = suppress_rotated_plain(rb, scores, thres, 0.1)
    assert want.tolist() == [[True, True, False]]
    return rb, scores, thres, want


@pytest.mark.parametrize("got,ties", [
    ([True, True, False], 0),   # equal masks
    ([True, False, True], 1),   # the tie flips 1, so 2 survives: follows from the tie
    ([True, False, False], None),  # 2 dropped after the flip: no tie explains it
    ([True, True, True], None),    # 2 kept against a probiou far above iou_thres
])
def test_rotated_rounding_ties_replays_the_walk(got, ties):
    """Every difference is held against a replay of the plain walk with the
    earlier ties forced, so a later fault in an image with a tie is caught."""
    rb, scores, thres, want = _tie_case()
    got = torch.tensor([got])
    if ties is None:
        with pytest.raises(AssertionError, match="candidate 2"):
            rotated_rounding_ties(got, want, rb, scores, thres, 0.1)
    else:
        assert rotated_rounding_ties(got, want, rb, scores, thres, 0.1) == ties


def test_suppress_rotated_on_cpu_launches_nothing():
    rb, scores = _candidates(9, 100)
    launches = suppress_rotated.launches
    keep = suppress_rotated(torch.from_numpy(rb), torch.from_numpy(scores), 0.45, 0.25)
    assert keep.dtype == torch.bool and keep.shape == (2, 100)
    assert suppress_rotated.launches == launches


def _obb_prediction(seed, n, b=2):
    r = np.random.default_rng(seed)
    rb = _xywhr(r, (b, n), 10.0, 60.0, 250.0)
    scores = r.random((b, n, NC)).astype(np.float32)
    return np.concatenate([rb[..., :4], scores, rb[..., 4:]], -1)


@pytest.mark.parametrize("seed,n,multi_label,conf,iou", [
    (0, 300, False, 0.25, 0.45), (1, 600, True, 0.25, 0.7), (2, 500, True, 0.6, 0.5)])
def test_rotated_nms_matches_jax(seed, n, multi_label, conf, iou):
    pred = _obb_prediction(seed, n)
    jdet, jcnt, jext = jax_nms(jnp.asarray(pred), conf_thres=conf, iou_thres=iou, nc=NC,
                               multi_label=multi_label, rotated=True, use_pallas=False)
    det, cnt, ext = non_max_suppression(torch.from_numpy(pred), conf_thres=conf, iou_thres=iou,
                                        nc=NC, multi_label=multi_label, rotated=True)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(det.numpy(), np.asarray(jdet), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ext.numpy(), np.asarray(jext))
    assert cnt.min() > 0 and ext.shape[-1] == 1
    # rows stay xywh: the width of the first detection is a candidate's width
    assert np.isin(det[0, 0, 2].item(), pred[0, :, 2])


@pytest.fixture(scope="module")
def obb_head():
    """JAX OBB head and its port with the same randomised weights."""
    ch, hw = (16, 32, 64), ((16, 16), (8, 8), (4, 4))
    r = np.random.default_rng(4)
    xs = [r.normal(0, 1, (2, h, w, c)).astype(np.float32) for (h, w), c in zip(hw, ch)]
    jm = JaxOBB(nc=NC, ne=1, ch=ch)
    v = randomize(jm.init(jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs]), seed=5)
    port = transfer(OBB(nc=NC, ne=1, ch=ch), v)
    return jm, v, port, xs


def test_obb_head_eval_matches_jax(obb_head):
    jm, v, port, xs = obb_head
    jy, (jfeats, jangle) = jm.apply(v, [jnp.asarray(x) for x in xs], input_h=128)
    with torch.no_grad():
        y, (feats, angle) = port([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs], input_h=128)
    assert y.shape == jy.shape == (2, 336, 4 + NC + 1)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(angle.numpy(), np.asarray(jangle), rtol=0, atol=1e-6)
    for f, jf in zip(feats, jfeats):
        np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(), np.asarray(jf), rtol=1e-5,
                                   atol=1e-5)
    a = angle.numpy()
    assert (a >= -np.pi / 4).all() and (a < 3 * np.pi / 4).all()


def test_obb_head_train_returns_feats_and_angle(obb_head):
    _, _, port, xs = obb_head
    port.train()
    try:
        feats, angle = port([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])
    finally:
        port.eval()
    assert [f.shape[1] for f in feats] == [64 + NC] * 3 and angle.shape == (2, 336, 1)


def test_dist2rbox_matches_jax():
    r = np.random.default_rng(6)
    dist = r.uniform(0, 8, (2, 40, 4)).astype(np.float32)
    ang = r.uniform(-np.pi / 4, 3 * np.pi / 4, (2, 40)).astype(np.float32)
    anchors = r.uniform(0, 16, (40, 2)).astype(np.float32)
    want = np.asarray(jax_dist2rbox(jnp.asarray(dist), jnp.asarray(ang),
                                    jnp.asarray(anchors)[None]))
    got = dist2rbox(torch.from_numpy(dist), torch.from_numpy(ang), torch.from_numpy(anchors)[None])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _quads(seed, n):
    r = np.random.default_rng(seed)
    rb = _xywhr(r, (n,), 8.0, 60.0)
    return OBBoxes(np.concatenate([rb, np.zeros((n, 2), np.float32)], -1), (320, 320)).xyxyxyxy


def test_obboxes_and_results_match_jax():
    r = np.random.default_rng(7)
    data = np.concatenate([_xywhr(r, (12,)), r.random((12, 1)), r.integers(0, NC, (12, 1))],
                          -1).astype(np.float32)
    got, want = OBBoxes(data, (320, 400)), JaxOBBoxes(data, (320, 400))
    for attr in ("xywhr", "conf", "cls", "xyxyxyxy", "xyxy"):
        np.testing.assert_allclose(getattr(got, attr), getattr(want, attr), rtol=0, atol=1e-4,
                                   err_msg=attr)
    res = Results(np.zeros((320, 400, 3), np.uint8), "a.jpg", {i: f"c{i}" for i in range(NC)},
                  np.concatenate([got.xyxy, data[:, 5:7]], -1), obb=data)
    assert len(res) == 12 and '"rbox"' in res.tojson()


def test_xyxyxyxy2xywhr_matches_jax():
    quads = _quads(8, 20)
    got, want = xyxyxyxy2xywhr_np(quads), jax_xyxyxyxy2xywhr(quads)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (20, 5) and ((got[:, 4] >= 0) & (got[:, 4] < np.pi / 2)).all()
    assert xyxyxyxy2xywhr_np(np.zeros((0, 4, 2), np.float32)).shape == (0, 5)


def test_probiou_np_matches_jax():
    r = np.random.default_rng(9)
    a, b = _xywhr(r, (30,)).astype(np.float64), _xywhr(r, (20,)).astype(np.float64)
    np.testing.assert_array_equal(probiou_np(a, b), jax_probiou_np(a, b))


@pytest.mark.parametrize("case", ["exact", "perturbed", "no_detections"])
def test_validator_obb_update_matches_jax(case):
    """The validator's OBB metric update on the same numpy detections and
    GT: rescale with the letterbox's gain and pad, probiou matching, AP."""
    r = np.random.default_rng(10)
    b, max_det, nb = 3, 20, 8
    det = np.zeros((b, max_det, 6), np.float32)
    angles = np.zeros((b, max_det), np.float32)
    cnt = np.array([12, 0, 7], np.int32) * (case != "no_detections")
    bboxes = np.zeros((b, nb, 5), np.float32)
    cls = np.zeros((b, nb, 1), np.float32)
    mask = np.zeros((b, nb, 1), np.float32)
    for i in range(b):
        rb = _xywhr(r, (max_det,), 10.0, 50.0, 120.0)
        rb[:, :2] += 4.0
        det[i, :, :4], angles[i] = rb[:, :4], rb[:, 4]
        det[i, :, 4] = np.sort(r.random(max_det))[::-1]
        det[i, :, 5] = r.integers(0, 3, max_det)
        ng = 5 + i
        gt = rb[:ng].copy()
        if case == "perturbed":
            gt[:, :4] += r.normal(0, 3, (ng, 4)).astype(np.float32)
            gt[:, 4] += r.normal(0, 0.1, ng).astype(np.float32)
        bboxes[i, :ng], cls[i, :ng, 0], mask[i, :ng] = gt, det[i, :ng, 5], 1.0
    batch = {"bboxes": bboxes, "cls": cls, "mask": mask,
             "ori_shape": [(200, 260), (128, 128), (90, 128)],
             "ratio_pad": [((0.49, 0.49), (0.3, 15.0)), ((1.0, 1.0), (0.0, 0.0)),
                           ((1.0, 1.0), (0.0, 19.0))]}
    names = {i: f"c{i}" for i in range(3)}
    got_m, want_m = DetMetrics(names), JaxDetMetrics(names)
    DetectionValidator._update_metrics(det, cnt, batch, got_m, ConfusionMatrix(3), (128, 128),
                                       angles)
    JaxValidator({})._update_metrics(det, cnt, batch, want_m, JaxConfusion(3), (128, 128),
                                     angles=angles)
    for k in ("tp", "conf", "pred_cls", "target_cls"):
        for g, w in zip(got_m.stats[k], want_m.stats[k]):
            np.testing.assert_array_equal(g, w, err_msg=k)
    got, want = got_m.process(), want_m.process()
    for k, w in want.items():
        assert got[k] == pytest.approx(w, abs=1e-9), k
    if case == "exact":
        assert got["metrics/mAP50(B)"] > 0.5  # image 1 has GT and no detections
    if case == "no_detections":
        assert got["metrics/recall(B)"] == 0.0
