"""One epoch of the PyTorch port's DetectionTrainer against the JAX
package's, both from the same randomised flagship weights, on a tiny
synthetic set at imgsz 128 (batch 2, the default ``auto`` optimizer, mosaic
on; ``val=False``, so the last epoch still validates the EMA but the final
re-validation of ``best`` is skipped on both sides to keep the file short):
the train losses in results.csv within 1e-4 relative, the same 16 columns,
``last`` and ``best`` written, and ``YOLO(best)`` reloads and predicts."""

import csv
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_weights import FLAGSHIP, jax_shapes, randomize
from yolo_ad_refine_tpu.models.model import DetectionModel as JaxDetectionModel
from yolo_ad_refine_tpu.train.trainer import DetectionTrainer as JaxTrainer
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.train.trainer import CSV_KEYS, DetectionTrainer
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

IMGSZ, NC = 128, 3


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    data = make_shapes_dataset(tmp / "ds", n_train=4, n_val=2, imgsz=IMGSZ, seed=6)
    cfg = dict(JaxDetectionModel(FLAGSHIP).yaml, nc=NC)
    jm, shapes = jax_shapes(cfg, IMGSZ)
    variables = randomize(shapes, seed=31)
    jm.variables = jax.tree.map(jnp.asarray, variables)
    jm.strides = (8, 16, 32)
    port = DetectionModel(FLAGSHIP, nc=NC)
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    port.probe_strides(IMGSZ)
    args = {"data": data, "epochs": 1, "batch": 2, "imgsz": IMGSZ, "plots": False,
            "max_boxes": 16, "workers": 2, "val": False}
    want = JaxTrainer({**args, "project": str(tmp / "jax")}, model=jm).train()
    got = DetectionTrainer({**args, "project": str(tmp / "port")}, model=port).train()
    return got, want


def test_train_losses_and_columns_match(runs):
    got, want = runs
    rows, ref = _rows(f"{got['save_dir']}/results.csv"), _rows(f"{want['save_dir']}/results.csv")
    assert list(rows[0]) == list(ref[0]) == list(CSV_KEYS) and len(CSV_KEYS) == 16
    assert len(rows) == len(ref) == 1
    for k in ("train/box_loss", "train/cls_loss", "train/dfl_loss"):
        a, b = float(rows[0][k]), float(ref[0][k])
        assert abs(a - b) <= 1e-4 * abs(b), (k, a, b)
    for k in ("lr/pg0", "lr/pg1", "lr/pg2"):
        assert float(rows[0][k]) == pytest.approx(float(ref[0][k]), rel=1e-5)


def test_checkpoints_written_and_best_reloads(runs):
    got, _ = runs
    wdir = f"{got['save_dir']}/weights"
    for name in ("last", "best"):
        for f in ("weights.pt", "meta.yaml"):
            assert (Path(wdir) / name / f).exists(), (name, f)
    model = YOLO(f"{wdir}/best", device="cpu")
    assert model.model.nc == NC and model.model.strides == (8, 16, 32)
    img = np.random.default_rng(0).integers(0, 256, (100, 140, 3), dtype=np.uint8)
    res = model.predict([img], imgsz=IMGSZ, conf=0.001)
    assert len(res) == 1 and np.isfinite(res[0].boxes.data).all()
