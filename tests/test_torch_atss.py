"""ATSS (adaptive training sample selection) in the PyTorch port against the
JAX package, fp32 on the CPU: the cell anchors bit-equal, the assignment
equal on JAX tests/test_atss.py's cases and on a random batch with padded
GT rows, and ``DetectionLoss(assigner="atss")``'s total and components 1e-5
relative and its gradient 1e-4 relative norm on tests/test_atss.py's loss
problem.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_ad_refine_tpu.train.atss import ATSSAssigner as JaxATSS
from yolo_ad_refine_tpu.train.atss import generate_cell_anchors as jax_anchors
from yolo_ad_refine_tpu.train.loss import DetectionLoss as JaxDetectionLoss
from yolo_ad_refine_tpu_torch.train.atss import ATSSAssigner, generate_cell_anchors
from yolo_ad_refine_tpu_torch.train.loss import DetectionLoss

STRIDES, IMGSZ = (8, 16, 32), 64
SHAPES = [(IMGSZ // s, IMGSZ // s) for s in STRIDES]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_cell_anchors_equal_jax():
    got, counts = generate_cell_anchors(SHAPES, STRIDES)
    want, want_counts = jax_anchors(SHAPES, STRIDES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert counts == want_counts == [64, 16, 4]


def _assign_both(labels, gt, mask, pd, nc=3):
    anchors, counts = generate_cell_anchors(SHAPES, STRIDES)
    got = ATSSAssigner(topk=9, num_classes=nc)(anchors, counts, *(torch.from_numpy(a) for a in (
        labels, gt, mask, pd)))
    ja, jc = jax_anchors(SHAPES, STRIDES)
    want = JaxATSS(topk=9, num_classes=nc)(ja, jc, *(jnp.asarray(a) for a in (labels, gt, mask,
                                                                              pd)))
    return got, want


def _equal(got, want):
    for name, g, w in zip(got._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_obvious_assignment_equals_jax():
    """JAX tests/test_atss.py: one GT, perfect predictions: positives only
    inside the box, all class 1, soft scores 1."""
    anchors, _ = generate_cell_anchors(SHAPES, STRIDES)
    gt = np.asarray([[[8.0, 8.0, 40.0, 40.0]]], np.float32)
    pd = np.tile(gt, (1, anchors.shape[0], 1))
    got, want = _assign_both(np.ones((1, 1, 1), np.float32), gt, np.ones((1, 1, 1), np.float32),
                             pd)
    _equal(got, want)
    fg = got.fg_mask[0].numpy()
    centers = ((anchors[:, :2] + anchors[:, 2:]) / 2).numpy()
    assert fg.sum() > 0 and not fg[~((centers > 8) & (centers < 40)).all(-1)].any()
    assert (got.target_labels[0].numpy()[fg] == 1).all()
    assert got.target_scores[0].numpy()[fg].max() == pytest.approx(1.0, abs=1e-3)


def test_empty_gt_assigns_nothing():
    a = generate_cell_anchors(SHAPES, STRIDES)[0].shape[0]
    z = np.zeros
    got, want = _assign_both(z((1, 2, 1), np.float32), z((1, 2, 4), np.float32),
                             z((1, 2, 1), np.float32), z((1, a, 4), np.float32))
    _equal(got, want)
    assert not got.fg_mask.any()


def test_random_batch_with_padded_rows_equals_jax():
    """Overlapping GTs (the max-IoU rule decides shared anchors), padded
    rows, and noisy predictions for the soft scores."""
    r = np.random.default_rng(0)
    xy = r.uniform(2, 36, (3, 6, 2))
    gt = np.concatenate([xy, xy + r.uniform(8, 26, (3, 6, 2))], -1).astype(np.float32)
    mask = (np.arange(6)[None, :, None] < np.array([6, 3, 1])[:, None, None]).astype(np.float32)
    labels = r.integers(0, 3, (3, 6, 1)).astype(np.float32)
    a = generate_cell_anchors(SHAPES, STRIDES)[0].shape[0]
    pxy = r.uniform(0, 50, (3, a, 2))
    pd = np.concatenate([pxy, pxy + r.uniform(4, 30, (3, a, 2))], -1).astype(np.float32)
    got, want = _assign_both(labels, gt * mask, mask, pd)
    _equal(got, want)
    assert got.fg_mask.sum() > 10


def _loss_problem():
    """JAX tests/test_atss.py test_loss_with_atss_assigner's problem."""
    r = np.random.default_rng(0)
    feats = [r.normal(0, 0.5, (2, IMGSZ // s, IMGSZ // s, 64 + 3)).astype(np.float32)
             for s in STRIDES]
    labels = r.integers(0, 3, (2, 4, 1)).astype(np.float32)
    xy = r.uniform(4, 30, (2, 4, 2))
    boxes = np.concatenate([xy, xy + r.uniform(8, 20, (2, 4, 2))], -1).astype(np.float32)
    return feats, labels, boxes, np.ones((2, 4, 1), np.float32)


def test_detection_loss_with_atss_matches_jax():
    feats, labels, boxes, mask = _loss_problem()
    jloss = JaxDetectionLoss(nc=3, strides=STRIDES, assigner="atss")

    def total(f):
        out = jloss(f, jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(mask))
        return out.total, out.components

    (want, comps), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        [jnp.asarray(f) for f in feats])
    maps = [torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_() for f in feats]
    out = DetectionLoss(nc=3, strides=STRIDES, assigner="atss")(
        maps, *(torch.from_numpy(a) for a in (labels, boxes, mask)))
    out.total.backward()
    assert np.isfinite(out.total.item())
    assert abs(out.total.item() - float(want)) <= 1e-5 * abs(float(want))
    np.testing.assert_allclose(out.components.numpy(), np.asarray(comps), rtol=1e-5)
    for m, g in zip(maps, grads):
        g = np.asarray(g)
        got = m.grad.permute(0, 2, 3, 1).numpy()
        assert np.linalg.norm(got - g) <= 1e-4 * np.linalg.norm(g)
    tal = DetectionLoss(nc=3, strides=STRIDES)(
        [m.detach() for m in maps], *(torch.from_numpy(a) for a in (labels, boxes, mask)))
    assert tal.total.item() != out.total.item()  # the assigner really changed


def test_unknown_assigner_raises_as_in_jax():
    with pytest.raises(ValueError, match="assigner must be 'tal' or 'atss'"):
        JaxDetectionLoss(nc=3, strides=STRIDES, assigner="simota")
    with pytest.raises(ValueError, match="assigner must be 'tal' or 'atss'"):
        DetectionLoss(nc=3, strides=STRIDES, assigner="simota")
