"""The OBB slice as a whole: yolo11n-obb (nc 15) at imgsz 128 on the CPU,
the JAX facade against the PyTorch port with the same numpy-randomised
weights, carried over by the strict loader.

Decoded predictions are held at 1e-4 (as the flagship's in
``test_torch_slice.py``: ~100 fp32 layers sum in other orders); predict's
detections and val's metrics within 1e-3. The images are square tiles at
the model's size (DOTA tiles), so both letterboxes are the identity and
both sides see the same pixels.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import randomize
from yolo_ad_refine_tpu import YOLO as JaxYOLO
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.data.synthetic import make_dota_dataset
from yolo_ad_refine_tpu_torch.engine.results import OBBoxes
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

CFG, IMGSZ = "yolo11n-obb.yaml", 128


@pytest.fixture(scope="module")
def pair():
    """(JAX facade, port facade), the same randomised weights in both."""
    jy = JaxYOLO(CFG, task="obb", imgsz=IMGSZ)
    variables = randomize(jy.model.variables, seed=31)
    jy.model.variables = jax.tree.map(jnp.asarray, variables)
    port = YOLO(CFG, task="obb", device="cpu", imgsz=IMGSZ)
    load_jax_variables(port.model, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    return jy, port


def test_decoded_predictions_match_jax(pair):
    jy, port = pair
    x = np.random.default_rng(0).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    want, _ = jax.jit(lambda v, a: jy.model.apply(v, a, train=False))(jy.model.variables,
                                                                        jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y, (feats, angle) = port.model.eval()(xt)
    assert y.shape == want.shape == (2, 336, 4 + 15 + 1)
    assert [f.shape[2] for f in feats] == [16, 8, 4] and angle.shape == (2, 336, 1)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_param_count_equals_jax(pair):
    jy, port = pair
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jy.model.variables["params"]))
    assert port.model.num_params() == n_jax == 2_664_416
    assert port.task == "obb" and port.model.strides == (8, 16, 32)


def _tiles(n, seed):
    r = np.random.default_rng(seed)
    return [cv2.GaussianBlur(r.integers(0, 256, (IMGSZ, IMGSZ, 3), dtype=np.uint8), (0, 0), 2)
            for _ in range(n)]


def test_predict_matches_jax(pair):
    jy, port = pair
    imgs = _tiles(2, 1)
    want = jy.predict(imgs, imgsz=IMGSZ, batch=2)
    got = port.predict(imgs, imgsz=IMGSZ, batch=2)
    assert sum(len(r) for r in got) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w) == len(g.obb)
        np.testing.assert_allclose(g.obb.data, w.obb.data, rtol=0, atol=1e-3)
        np.testing.assert_allclose(g.boxes.data, w.boxes.data, rtol=0, atol=1e-3)
        r = g.obb.xywhr[:, 4]
        assert np.isfinite(g.obb.data).all()
        assert (r >= -np.pi / 4).all() and (r < 3 * np.pi / 4).all()


@pytest.fixture(scope="module")
def val_results(pair, tmp_path_factory):
    """Both validators on a seeded DOTA-format set labelled with the port's
    3 best rotated detections per tile (random labels would give mAP 0 on
    both sides and prove nothing)."""
    jy, port = pair
    root = tmp_path_factory.mktemp("obbval") / "dota"
    data = make_dota_dataset(root, n_val=4, imgsz=IMGSZ, seed=2)
    files = sorted((root / "val" / "images").glob("*.png"))
    results = port.predict([cv2.imread(str(f)) for f in files], imgsz=IMGSZ, conf=0.01, batch=4)
    for f, r in zip(files, results):
        quads = OBBoxes(r.obb.data[:3], r.orig_shape).xyxyxyxy / IMGSZ
        lines = [f"{int(c)} " + " ".join(f"{v:.6f}" for v in q.reshape(-1))
                 for q, c in zip(quads, r.obb.cls[:3])]
        (root / "val" / "labels" / f"{f.stem}.txt").write_text("\n".join(lines) + "\n")
    args = {"data": data, "imgsz": IMGSZ, "batch": 2, "conf": 0.001, "iou": 0.7, "max_det": 300}
    return port.val(**args), jy.val(**args)


def test_val_metrics_match_jax(val_results):
    got, want = val_results
    assert want["metrics/mAP50(B)"] > 0.3  # the labels are findable: the check is not vacuous
    for k in ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
              "metrics/mAP50-95(B)", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


def test_detect_task_on_an_obb_model_raises():
    with pytest.raises(ValueError, match="task"):
        YOLO(CFG, task="detect", device="cpu", imgsz=IMGSZ)
