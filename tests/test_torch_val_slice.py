"""Validation of the flagship, the PyTorch port against the JAX package:
the same randomised weights on 8 synthetic val images at imgsz 128, each
side's whole pipeline (letterbox, eval forward, NMS, rescale, matching, AP).

Labels are the port's own top detections (random labels would give mAP 0
on both sides and prove nothing), so mAP is high and every convention in
the pipeline moves it. mAP50 and mAP50-95 are held within 1e-3, the
tolerance of tests/test_fullval_parity.py.
"""

import cv2
import jax
import jax.numpy as jnp
import pytest

from test_torch_weights import FLAGSHIP, jax_shapes, randomize
from yolo_ad_refine_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_ad_refine_tpu.models.model import DetectionModel as JaxDetectionModel
from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
from yolo_ad_refine_tpu_torch.engine.predictor import DetectionPredictor
from yolo_ad_refine_tpu_torch.engine.validator import DetectionValidator
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

IMGSZ, NC = 128, 3


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = dict(JaxDetectionModel(FLAGSHIP).yaml, nc=NC)
    jm, shapes = jax_shapes(cfg, IMGSZ)
    variables = randomize(shapes, seed=21)
    jm.variables = jax.tree.map(jnp.asarray, variables)
    jm.strides = (8, 16, 32)
    port = DetectionModel(FLAGSHIP, nc=NC)
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    port.eval()

    root = tmp_path_factory.mktemp("val") / "ds"
    data = make_shapes_dataset(root, n_train=1, n_val=8, imgsz=IMGSZ, seed=4,
                               aspect_range=(0.7, 1.4))
    # label each val image with the port's 3 best detections
    files = sorted((root / "val" / "images").glob("*.jpg"))
    imgs = [cv2.imread(str(f)) for f in files]
    results = DetectionPredictor({"imgsz": IMGSZ, "conf": 0.0, "batch": 4})(imgs, model=port)
    for f, im, r in zip(files, imgs, results):
        h, w = im.shape[:2]
        lines = []
        for x1, y1, x2, y2, _, c in r.boxes.data[:3]:
            lines.append(f"{int(c)} {(x1 + x2) / 2 / w:.6f} {(y1 + y2) / 2 / h:.6f} "
                         f"{(x2 - x1) / w:.6f} {(y2 - y1) / h:.6f}")
        (root / "val" / "labels" / f"{f.stem}.txt").write_text("\n".join(lines) + "\n")
    args = {"imgsz": IMGSZ, "batch": 4, "conf": 0.001, "iou": 0.7, "max_det": 300,
            "max_boxes": 16, "data": data}
    want = JaxValidator(args=dict(args))(model=jm)
    got = DetectionValidator(args=dict(args))(model=port)
    return got, want


def test_map_matches_jax_validator(setup):
    got, want = setup
    assert want["metrics/mAP50(B)"] > 0.3  # the labels are findable: the check is not vacuous
    for k in ("metrics/mAP50(B)", "metrics/mAP50-95(B)"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


def test_precision_recall_and_fitness_match(setup):
    got, want = setup
    for k in ("metrics/precision(B)", "metrics/recall(B)", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    assert got["fitness"] == pytest.approx(0.9 * got["metrics/mAP50(B)"]
                                           + 0.1 * got["metrics/mAP50-95(B)"])
