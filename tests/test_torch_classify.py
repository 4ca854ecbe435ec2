"""Classification in the PyTorch port against the JAX package, fp32 on the
CPU, with numpy-randomised weights carried over by the strict loader.

Tolerances: the Classify head's eval softmax and train logits 1e-5
absolute, yolo11n-cls's and yolov8n-cls's 1e-4 (yolo11n-cls's C2PSA holds
attention); the dataset's batches bit-equal (the same cv2 and numpy calls
from the same generators); one ClassificationTrainer epoch from the JAX
trainer's own initial weights: every EMA leaf 1e-4 relative norm (the
norm floored at 1e-3: some running means sit at rounding noise, ~1e-9),
top1 / top5 equal; validate's top1 / top5 equal to the JAX one's, over full
batches only (hazard (e)). The JAX facade cannot train or validate a
classifier, nor predict with one: the port's hand-off and its error are
held against that.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import jax_shapes, randomize, transfer
from yolo_ad_refine_tpu import YOLO as JaxYOLO
from yolo_ad_refine_tpu.models.model import DetectionModel as JaxDetectionModel
from yolo_ad_refine_tpu.nn import head as JH
from yolo_ad_refine_tpu.train.classify import ClassificationDataset as JaxDataset
from yolo_ad_refine_tpu.train.classify import ClassificationTrainer as JaxTrainer
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.cfg.cli import entrypoint
from yolo_ad_refine_tpu_torch.data.synthetic import make_classify_dataset
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.nn import head as PH
from yolo_ad_refine_tpu_torch.train.classify import (
    ClassificationDataset, ClassificationTrainer, validate)
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

IMGSZ, NC = 32, 4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _port(cfg, variables, nc=NC):
    m = DetectionModel(cfg, nc=nc)
    load_jax_variables(m, flatten_tree(variables["params"]), flatten_tree(variables["batch_stats"]))
    return m.eval()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    # 16 a class: two train batches of 32 (one optimizer step at accumulate 2)
    return make_classify_dataset(tmp_path_factory.mktemp("cls") / "ds", n_train=16, n_val=5,
                                 imgsz=40, seed=3)


def test_classify_head_matches_jax():
    x = np.random.default_rng(0).normal(0, 1, (3, 4, 4, 24)).astype(np.float32)
    jmod = JH.Classify(nc=NC)
    variables = randomize(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed=2)
    port = transfer(PH.Classify(24, NC), variables)
    want = jmod.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(_nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)  # eval: the softmax
    want_t, _ = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                           rngs={"dropout": jax.random.PRNGKey(0)})
    port.train()
    np.testing.assert_allclose(port(_nchw(x)).detach().numpy(), np.asarray(want_t), atol=1e-5)


@pytest.mark.parametrize("cfg,n_params", [("yolo11n-cls.yaml", 1_536_228),
                                          ("yolov8n-cls.yaml", 1_443_412)])
def test_cls_model_loads_strictly_and_matches_jax(cfg, n_params):
    jm, shapes = jax_shapes(dict(JaxDetectionModel(cfg).yaml, nc=NC, scale="n"), IMGSZ)
    variables = randomize(shapes, seed=4)
    port = _port(dict(jm.yaml), variables)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert port.num_params() == n_jax == n_params
    assert port.task == "classify" and port.strides is None
    x = np.random.default_rng(1).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    want = jm.graph.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(_nchw(x))
    assert got.shape == (2, NC)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_dataset_batches_bit_equal(data):
    for split, augment in (("train", True), ("val", False)):
        ours = ClassificationDataset(data / split, IMGSZ, augment=augment)
        ref = JaxDataset(data / split, IMGSZ, augment=augment)
        assert ours.names == ref.names and ours.samples == ref.samples
        for (a, la), (b, lb) in zip(ours.batches(8, shuffle=augment, seed=1),
                                    ref.batches(8, shuffle=augment, seed=1), strict=True):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(la, lb)


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-3)


def test_trainer_epoch_matches_jax(data, tmp_path):
    """One epoch of each trainer from the JAX trainer's own initial
    weights (its DetectionModel.init at PRNGKey(seed)): every EMA leaf, and
    top1 / top5 of the final EMA."""
    args = {"model": "yolo11n-cls.yaml", "data": str(data), "epochs": 1, "batch": 32,
            "imgsz": IMGSZ, "seed": 0, "plots": False}
    jt = JaxTrainer({**args, "project": str(tmp_path / "jax")})
    want = jt.train()
    init = JaxDetectionModel("yolo11n-cls.yaml", nc=NC)
    init.init(jax.random.PRNGKey(0), imgsz=IMGSZ)
    port = _port("yolo11n-cls.yaml", jax.tree.map(np.asarray, init.variables))
    start = {k: v.clone() for k, v in port.state_dict().items()}
    pt = ClassificationTrainer({**args, "project": str(tmp_path / "port"), "device": "cpu"},
                               model=port)
    got = pt.train()
    assert got["top1"] == want["top1"]
    ema = {k: v.numpy() for k, v in pt.model.state_dict().items()}
    ref = _port("yolo11n-cls.yaml", jax.tree.map(np.asarray, jt.model.variables))
    moved = 0
    for k, v in ref.state_dict().items():
        if v.dtype.is_floating_point:
            assert _rel_norm(ema[k], v.numpy()) <= 1e-4, k
            moved += not np.array_equal(ema[k], start[k].numpy())
    assert moved > 100  # the EMA moved: the check is not vacuous
    val = ClassificationDataset(data / "val", IMGSZ)
    assert validate(pt.model, val, 4) == JaxTrainer.validate(
        jt.model, jt.model.variables, JaxDataset(data / "val", IMGSZ), 4)
    best = Path(got["save_dir"]) / "weights" / "best"
    assert YOLO(str(best), device="cpu").task == "classify"


def test_validate_drops_the_partial_batch(data):
    """Hazard (e): 20 val images at batch 8 count 16, on both sides."""
    jm, shapes = jax_shapes(dict(JaxDetectionModel("yolov8n-cls.yaml").yaml, nc=NC, scale="n"),
                            IMGSZ)
    variables = randomize(shapes, seed=6)
    port = _port(dict(jm.yaml), variables)
    ds = ClassificationDataset(data / "val", IMGSZ)
    assert len(ds) == 20
    got = validate(port, ds, 8)
    want = JaxTrainer.validate(jm, jax.tree.map(jnp.asarray, variables),
                               JaxDataset(data / "val", IMGSZ), 8)
    assert got == want
    assert all(round(v * 16) == v * 16 for v in got.values())  # counts over 16 images


def test_facade_hands_off_and_jax_facade_cannot(data, tmp_path):
    """The JAX facade's train and val read the class folders as a detection
    data yaml and fail, and its predict has no classify path; the port's
    facade and CLI hand a Classify model to ClassificationTrainer /
    validate, and predict says that nothing serves a classifier."""
    jm, shapes = jax_shapes(dict(JaxDetectionModel("yolo11n-cls.yaml").yaml, nc=NC, scale="n"),
                            IMGSZ)
    jm.variables = jax.tree.map(jnp.asarray, randomize(shapes, seed=8))
    jax_model = JaxYOLO.__new__(JaxYOLO)  # the facade over these weights, without its init
    jax_model.model, jax_model.overrides = jm, {"model": "yolo11n-cls.yaml", "task": "detect"}
    with pytest.raises(IsADirectoryError):
        jax_model.train(data=str(data), epochs=1, batch=8, imgsz=IMGSZ,
                        project=str(tmp_path / "jax"))
    with pytest.raises(IsADirectoryError):
        jax_model.val(data=str(data), batch=8, imgsz=IMGSZ)
    img = np.zeros((IMGSZ, IMGSZ, 3), np.uint8)
    with pytest.raises(ValueError):
        jax_model.predict([img], imgsz=IMGSZ)
    m = YOLO("yolo11n-cls.yaml", device="cpu", imgsz=IMGSZ, nc=NC)
    r = m.train(data=str(data), epochs=1, batch=16, imgsz=IMGSZ, project=str(tmp_path / "p"))
    assert 0.0 <= r["top1"] <= 1.0 and Path(r["save_dir"], "weights", "best").is_dir()
    v = m.val(data=str(data), batch=8, imgsz=IMGSZ)
    assert set(v) == {"top1", "top5"} and v["top5"] == 1.0  # 4 classes: top5 holds them all
    with pytest.raises(ValueError, match="serves no classifier"):
        m.predict([img])
    assert entrypoint(["classify", "val", f"model={r['save_dir']}/weights/best",
                       f"data={data}", f"imgsz={IMGSZ}", "batch=8", "device=cpu"]) == 0


@pytest.mark.parametrize("fmt", ["torchscript", "torch_export", "checkpoint"])
def test_export_of_a_classifier_raises(fmt, tmp_path):
    """ROADMAP Queue 3 item 2: the exported callable returns the first
    output, which for a Classify head is the first image's probabilities;
    the JAX package exports and serves no classifier, so the port's
    Exporter raises on one, with the reason."""
    m = YOLO("yolo11n-cls.yaml", device="cpu", imgsz=IMGSZ, nc=NC)
    with pytest.raises(ValueError, match="serves and exports no classifier"):
        m.export(format=fmt, imgsz=IMGSZ, batch=2, half=False, path=str(tmp_path / "cls"))
    assert not list(tmp_path.iterdir())
