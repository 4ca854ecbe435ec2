"""Geometry ops and the letterbox of the PyTorch port against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_ad_refine_tpu.data.augment import letterbox as jax_letterbox
from yolo_ad_refine_tpu.ops import anchors as JA
from yolo_ad_refine_tpu.ops import boxes as JBX
from yolo_ad_refine_tpu_torch.data.augment import letterbox
from yolo_ad_refine_tpu_torch.nn.tssa import pad_reflect_end
from yolo_ad_refine_tpu_torch.ops import anchors as PA
from yolo_ad_refine_tpu_torch.ops import boxes as PBX


def _boxes(seed=0, n=64):
    r = np.random.default_rng(seed)
    xy = r.uniform(-20, 660, (2, n, 2))
    wh = r.uniform(1, 200, (2, n, 2))
    return np.concatenate([xy, wh], -1).astype(np.float32)


def test_box_conversions():
    b = _boxes()
    np.testing.assert_allclose(PBX.xywh2xyxy(torch.from_numpy(b)).numpy(),
                               np.asarray(JBX.xywh2xyxy(jnp.asarray(b))), atol=1e-6)
    np.testing.assert_allclose(PBX.xyxy2xywh(torch.from_numpy(b)).numpy(),
                               np.asarray(JBX.xyxy2xywh(jnp.asarray(b))), atol=1e-6)
    np.testing.assert_allclose(PBX.clip_boxes(torch.from_numpy(b), (480, 640)).numpy(),
                               np.asarray(JBX.clip_boxes(jnp.asarray(b), (480, 640))), atol=1e-6)


@pytest.mark.parametrize("ratio_pad", [None, ((0.5, 0.5), (0.0, 80.0))])
def test_scale_boxes(ratio_pad):
    b = np.abs(_boxes(1))
    want = JBX.scale_boxes((640, 640), jnp.asarray(b), (480, 1280), ratio_pad=ratio_pad)
    got = PBX.scale_boxes((640, 640), torch.from_numpy(b), (480, 1280), ratio_pad=ratio_pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_anchors_and_dist2bbox():
    shapes, strides = [(8, 10), (4, 5), (2, 3)], (8, 16, 32)
    pa, ps = PA.make_anchors(shapes, strides, 0.5)
    ja, js = JA.make_anchors(shapes, strides, 0.5)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), atol=1e-6)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-6)
    d = np.random.default_rng(2).uniform(0, 16, (2, pa.shape[0], 4)).astype(np.float32)
    for xywh in (True, False):
        got = PA.dist2bbox(torch.from_numpy(d), pa[None], xywh=xywh)
        want = JA.dist2bbox(jnp.asarray(d), ja[None], xywh=xywh)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("hw", [(480, 640), (100, 140), (150, 90), (640, 640), (37, 1001)])
def test_letterbox_matches_cv2(hw):
    """Down- and up-scaling: pixels within one grey level of cv2's 11-bit
    fixed-point INTER_LINEAR, ratio and pad exactly equal."""
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    want, wr, wp = jax_letterbox(img, 320)
    got, gr, gp = letterbox(img, 320)
    assert gr == wr and gp == wp
    assert got.shape == want.shape
    diff = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1


@pytest.mark.parametrize("n", [0, 7])
def test_results_match_jax(n):
    from yolo_ad_refine_tpu.engine.results import Results as JaxResults
    from yolo_ad_refine_tpu_torch.engine.results import Results

    r = np.random.default_rng(n)
    xy, wh = r.uniform(0, 100, (n, 2)), r.uniform(1, 90, (n, 2))
    d = np.concatenate([xy, xy + wh, r.random((n, 1)), r.integers(0, 3, (n, 1))], 1)
    d = d.astype(np.float32)
    img, names = np.zeros((120, 200, 3), np.uint8), {0: "aphid", 1: "mite", 2: "thrips"}
    got, want = Results(img, "a.jpg", names, d), JaxResults(img, "a.jpg", names, d)
    assert len(got) == len(want) == n
    for attr in ("xyxy", "xywh", "xyxyn", "xywhn", "conf", "cls"):
        np.testing.assert_array_equal(getattr(got.boxes, attr), getattr(want.boxes, attr))
    assert got.tojson() == want.tojson()
    assert got.verbose() == want.verbose()


@pytest.mark.parametrize("n,pad", [(4, 4), (5, 3), (1, 7), (12, 4), (3, 9)])
def test_pad_reflect_end_is_numpy_reflect(n, pad):
    x = torch.arange(2 * 3 * n * n, dtype=torch.float32).reshape(2, 3, n, n)
    want = np.pad(x.numpy(), ((0, 0), (0, 0), (0, pad), (0, pad)), mode="reflect")
    np.testing.assert_array_equal(pad_reflect_end(x, pad, pad).numpy(), want)
