"""The predict slice as a whole: the flagship YOLO-AD-Refine at imgsz 128,
batch 2, fp32 on the CPU, JAX package against the PyTorch port with the
same (numpy-randomised) weights.

Decoded predictions are held at rtol/atol 1e-4: the two frameworks sum
convolutions, GroupNorm / BatchNorm statistics, the rFFT and attention in
different orders, and ~30 such layers compound their fp32 rounding; boxes
are in pixels (up to 128). Off the TPU the JAX package runs its 'exact' DCN,
the unbounded sampling the port's DyDCNv2 uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import FLAGSHIP, jax_shapes, randomize
from yolo_ad_refine_tpu.ops.nms import non_max_suppression as jax_nms
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

IMGSZ = 128


@pytest.fixture(scope="module")
def pair():
    """(JAX model, randomised variables, port model, input NHWC, JAX y)."""
    jm, shapes = jax_shapes(FLAGSHIP, IMGSZ)
    variables = randomize(shapes, seed=3)
    port = DetectionModel(FLAGSHIP)
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    port.eval()
    x = np.random.default_rng(0).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    y, _ = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    return jm, variables, port, x, np.array(y)


def test_decoded_predictions_match_jax(pair):
    _, _, port, x, jy = pair
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y, feats = port(xt)
    assert y.shape == jy.shape == (2, 16 * 16 + 8 * 8 + 4 * 4, 84)
    assert [f.shape[2] for f in feats] == [16, 8, 4]
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-4, atol=1e-4)


def test_nms_on_jax_predictions_is_equal(pair):
    from yolo_ad_refine_tpu_torch.ops.nms import non_max_suppression

    jy = pair[4]
    for conf in (0.001, 0.25):
        jdet, jcnt, _ = jax_nms(jnp.asarray(jy), conf_thres=conf, iou_thres=0.7, use_pallas=False)
        det, cnt, _ = non_max_suppression(torch.from_numpy(jy), conf_thres=conf, iou_thres=0.7)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
        np.testing.assert_array_equal(det.numpy(), np.asarray(jdet))


def test_param_count_equals_jax(pair):
    jm, variables, port, _, _ = pair
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert port.num_params() == n_jax == 4_098_177


def test_yolo_predict_end_to_end_cpu():
    r = np.random.default_rng(1)
    imgs = [r.integers(0, 256, (100, 140, 3), dtype=np.uint8),
            r.integers(0, 256, (150, 90, 3), dtype=np.uint8),
            r.integers(0, 256, (128, 128, 3), dtype=np.uint8)]
    model = YOLO(FLAGSHIP, device="cpu", imgsz=IMGSZ, seed=0)
    assert model.model.strides == (8, 16, 32)
    results = model.predict(imgs, imgsz=IMGSZ, conf=0.001, batch=2)
    assert len(results) == 3
    for im, res in zip(imgs, results):
        assert res.orig_shape == im.shape[:2]
        d = res.boxes.data
        assert 0 < len(d) <= 300 and np.isfinite(d).all()
        assert (d[:, [0, 2]] >= 0).all() and (d[:, [0, 2]] <= im.shape[1]).all()
        assert (d[:, [1, 3]] >= 0).all() and (d[:, [1, 3]] <= im.shape[0]).all()
        assert (np.diff(d[:, 4]) <= 0).all()  # score-sorted
