"""FastSAM and the YOLO-NAS postprocess in the PyTorch port against the JAX
package, on the CPU: every case of tests/test_fastsam_nas.py on the port's
Results, the prompt selection against the JAX facade's on the same
instances, FastSAM's everything mode on yolov8-seg.yaml (nc 1) at 128 px
against the JAX ``FastSAM`` on the same numpy-randomised weights (rows
paired within 1e-3 px and 1e-4 in score, masks flipped on at most 2e-3 of
the pixels, as the segment predictor's test holds them), then bbox and
point prompts on those results, and ``nas_postprocess`` against JAX's
(counts equal, rows within 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_segment import pair_rows
from test_torch_weights import randomize
from yolo_ad_refine_tpu.engine.results import Results as JaxResults
from yolo_ad_refine_tpu.models import fastsam as JF
from yolo_ad_refine_tpu.models import nas as JN
from yolo_ad_refine_tpu_torch import NAS, FastSAM
from yolo_ad_refine_tpu_torch.engine.results import Results
from yolo_ad_refine_tpu_torch.models import fastsam as PF
from yolo_ad_refine_tpu_torch.models.nas import nas_postprocess
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

IMGSZ = 128


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def seg_results(boxes, masks, shape=(100, 100), cls=Results):
    img = np.zeros((*shape, 3), np.uint8)
    return cls(img, "f.jpg", {0: "object"}, np.asarray(boxes, np.float32),
               masks=np.asarray(masks, np.float32))


def _stub(cls=PF.FastSAM):
    """A FastSAM with the prompt machinery and no model: prompt() and _take
    are host-side logic."""
    return cls.__new__(cls)


def _three_instances(cls=Results):
    masks = np.zeros((3, 100, 100), np.float32)
    masks[0, 10:30, 10:30] = 1    # top-left blob
    masks[1, 60:90, 60:90] = 1    # bottom-right blob
    masks[2, 10:30, 60:90] = 1    # top-right blob
    boxes = [[10, 10, 30, 30, 0.9, 0], [60, 60, 90, 90, 0.8, 0], [60, 10, 90, 30, 0.7, 0]]
    return seg_results(boxes, masks, cls=cls)


# -- the JAX package's cases on the port ---------------------------------------------------------


def test_border_snap():
    b = np.asarray([[5.0, 30, 60, 70], [30, 30, 95, 85]], np.float32)
    out = PF.adjust_bboxes_to_image_border(b, (100, 100), threshold=20)
    assert out[0, 0] == 0 and out[1, 2] == 100 and out[0, 1] == 30
    np.testing.assert_array_equal(out, JF.adjust_bboxes_to_image_border(b, (100, 100), 20))


def test_box_iou_matches_jax():
    r = np.random.default_rng(0)
    a = np.sort(r.uniform(0, 100, (5, 2, 2)), 1).reshape(5, 4).astype(np.float32)
    b = np.sort(r.uniform(0, 100, (7, 2, 2)), 1).reshape(7, 4).astype(np.float32)
    np.testing.assert_array_equal(PF._box_iou(a, b), JF._box_iou(a, b))


def test_bbox_prompt_selects_best_iou():
    out = _stub().prompt([_three_instances()], bboxes=[[8, 8, 32, 32]])
    assert len(out[0]) == 1 and isinstance(out[0], Results)
    assert np.allclose(out[0].boxes.xyxy[0], [10, 10, 30, 30])


def test_point_prompt_foreground():
    out = _stub().prompt([_three_instances()], points=[[75, 75]])
    assert len(out[0]) == 1
    assert np.allclose(out[0].boxes.xyxy[0], [60, 60, 90, 90])


def test_point_prompt_background_drops():
    out = _stub().prompt([_three_instances()], points=[[20, 20], [75, 75]], labels=[1, 0])
    assert len(out[0]) == 1
    assert np.allclose(out[0].boxes.xyxy[0], [10, 10, 30, 30])


def test_no_prompt_passthrough():
    r = _three_instances()
    assert _stub().prompt([r])[0] is r


def test_text_prompt_gated():
    with pytest.raises((ImportError, NotImplementedError)):
        _stub().prompt([_three_instances()], texts="a red square")


@pytest.mark.parametrize("kw", [
    dict(bboxes=[[8, 8, 32, 32], [55, 5, 95, 35]]), dict(points=[[75, 75], [20, 70]]),
    dict(points=[[20, 20], [75, 75]], labels=[0, 0]), dict(bboxes=[[8, 8, 32, 32]],
                                                           points=[[75, 75]], labels=[1])])
def test_prompt_selection_matches_jax(kw):
    got = _stub().prompt([_three_instances()], **kw)[0]
    want = _stub(JF.FastSAM).prompt([_three_instances(JaxResults)], **kw)[0]
    np.testing.assert_array_equal(got.boxes.data, want.boxes.data)
    np.testing.assert_array_equal(got.masks.data, want.masks.data)


def test_nas_postprocess_raw_layout():
    boxes = np.zeros((1, 4, 4), np.float32)
    boxes[0, 0] = [10, 10, 50, 50]
    boxes[0, 1] = [12, 12, 52, 52]   # overlaps 0 -> suppressed
    boxes[0, 2] = [70, 70, 90, 90]
    boxes[0, 3] = [0, 0, 5, 5]       # below conf
    scores = np.zeros((1, 4, 3), np.float32)
    scores[0, 0, 1], scores[0, 1, 1], scores[0, 2, 2], scores[0, 3, 0] = 0.9, 0.6, 0.8, 0.1
    det, cnt = nas_postprocess(boxes, scores, conf_thres=0.25, iou_thres=0.45, device="cpu")
    assert int(cnt[0]) == 2
    kept = det[0, : int(cnt[0])]
    np.testing.assert_allclose(kept[0, :4], [10, 10, 50, 50], atol=0.1)
    assert kept[0, 5] == 1 and kept[1, 5] == 2


def test_nas_postprocess_matches_jax():
    r = np.random.default_rng(3)
    xy = r.uniform(0, 600, (2, 500, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + r.uniform(5, 80, (2, 500, 2)).astype(np.float32)], -1)
    scores = r.uniform(0, 0.6, (2, 500, 7)).astype(np.float32)
    got_det, got_cnt = nas_postprocess(boxes, scores, device="cpu")
    want_det, want_cnt = JN.nas_postprocess(boxes, scores)
    np.testing.assert_array_equal(got_cnt, want_cnt)
    assert got_cnt.min() > 10
    np.testing.assert_allclose(got_det, want_det, atol=1e-5, rtol=0)


def test_nas_postprocess_keeps_tensors_on_their_device():
    boxes = torch.tensor([[[10.0, 10, 50, 50]]])
    det, cnt = nas_postprocess(boxes, torch.tensor([[[0.9]]]))  # CPU tensors: no device asked
    assert int(cnt[0]) == 1 and det.shape == (1, 300, 6)


def test_nas_facade_gated_without_super_gradients():
    with pytest.raises(ImportError, match="super_gradients"):
        NAS("yolo_nas_s")
    with pytest.raises(AssertionError, match="pre-trained"):
        NAS("yolo_nas_s.yaml")


def test_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FastSAM("yolov8-seg.yaml")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nas_postprocess(np.zeros((1, 4, 4), np.float32), np.zeros((1, 4, 2), np.float32))


# -- everything mode against the JAX FastSAM ----------------------------------------------------


LEVELS = ((0, 256), (256, 320), (320, 336))  # the anchors of P3 / P4 / P5 at 128


def _head(variables):
    return variables["params"][max(variables["params"], key=lambda k: int(k.split("_")[1]))]


def localise(variables):
    """Seeded weights put every box over the whole image, where the snap
    makes them all one frame box: scale the box branch's last kernel by 0.1
    with biases that favour short bins (local boxes, as the segment tests'
    ``localise``), and lift the mask coefficients (non-empty masks)."""
    head = _head(variables)
    for i in range(3):
        box = head["detect"][f"cv2_{i}_2"]
        box["kernel"] = box["kernel"] * 0.1
        box["bias"] = np.tile(-0.5 * np.arange(16, dtype=np.float32), 4)
        head[f"cv4_{i}_2"]["bias"] = head[f"cv4_{i}_2"]["bias"] + 2.0
    return variables


def spread_scores(variables, scores, gain=50.0, top=0.1):
    """Seeded weights give class 0 a score flat to 1e-2 over each level,
    where the rows' order is float noise. Scale its last kernel by ``gain``
    and set each level's bias so that its ``top`` share of anchors passes
    conf 0.4 (``scores`` (B, anchors): the model's on the test images)."""
    head = _head(variables)
    for i, (a, b) in enumerate(LEVELS):
        cls = head["detect"][f"cv3_{i}_2"]
        pre = np.log(scores[:, a:b] / (1 - scores[:, a:b])) - cls["bias"][0]
        cls["kernel"] = cls["kernel"] * gain
        cls["bias"] = np.full_like(cls["bias"], np.log(0.4 / 0.6) - gain * np.quantile(
            pre.astype(np.float64), 1 - top))
    return variables


@pytest.fixture(scope="module")
def fastsams():
    import cv2

    from yolo_ad_refine_tpu_torch.engine.predictor import preprocess

    r = np.random.default_rng(6)
    imgs = [cv2.GaussianBlur(r.integers(0, 256, s, dtype=np.uint8), (0, 0), 2)
            for s in ((96, 128, 3), (120, 90, 3))]
    jfs = JF.FastSAM("yolov8-seg.yaml", imgsz=IMGSZ)
    pfs = FastSAM("yolov8-seg.yaml", device="cpu", imgsz=IMGSZ)
    variables = localise(randomize(jfs.model.variables, seed=31))
    load_jax_variables(pfs.model, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    x, _ = preprocess(imgs, IMGSZ, 2, torch.device("cpu"), torch.float32)
    with torch.no_grad():
        scores = pfs.model(x)[0][..., 4].double().numpy()
    variables = spread_scores(variables, scores)
    load_jax_variables(pfs.model, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    jfs.model.variables = jax.tree.map(jnp.asarray, variables)
    return jfs, pfs, imgs


def _hold(got, want):
    """Rows paired as the segment predictor's test pairs them, masks flipped
    on at most 2e-3 of the pixels. (The JAX facade's predict reads imgsz
    from its call, its overrides hold none: both sides are given it.)"""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        if not len(w):
            continue
        order = pair_rows(g.boxes.data, w.boxes.data)
        assert g.masks.data.shape == w.masks.data.shape
        flipped = ((g.masks.data > 0.5) != (w.masks.data[order] > 0.5)).mean()
        assert flipped <= 2e-3, flipped


def test_everything_mode_matches_jax(fastsams):
    jfs, pfs, imgs = fastsams
    assert pfs.model.num_params() == sum(int(np.prod(v.shape))
                                         for v in jax.tree.leaves(jfs.model.variables["params"]))
    assert pfs.model.names == {0: "object"}
    got = pfs.predict(imgs, imgsz=IMGSZ, batch=2)
    want = jfs.predict(imgs, imgsz=IMGSZ, batch=2)
    assert sum(len(g) for g in got) >= 2
    _hold(got, want)
    for g in got:  # the snap: every box inside its image, near-border edges on the border
        h, w = g.orig_shape
        d = g.boxes.xyxy
        assert ((d[:, [0, 1]] == 0) | (d[:, [0, 1]] >= 20)).all()
        assert ((d[:, 2] == w) | (d[:, 2] <= w - 20)).all()


@pytest.mark.parametrize("prompt", ["bboxes", "points"])
def test_prompted_predict_matches_jax(fastsams, prompt):
    jfs, pfs, imgs = fastsams
    kw = {"bboxes": dict(bboxes=[[20, 20, 70, 60]]),
          "points": dict(points=[[40, 40], [80, 30]], labels=[1, 0])}[prompt]
    got = pfs.predict(imgs, imgsz=IMGSZ, batch=2, **kw)
    want = jfs.predict(imgs, imgsz=IMGSZ, batch=2, **kw)
    assert sum(len(g) for g in got) >= 1
    _hold(got, want)
