"""The PyTorch port's plots (``utils/plotting.py``) against the JAX
package's: the same inputs drawn by both and the files compared.

- ``plot_images`` (cv2): the JPEGs decode to equal pixels.
- ``plot_results`` (one results.csv; the port reads it with ``csv`` where
  the JAX package uses pandas), ``plot_pr_curve``,
  ``plot_confusion_matrix`` and ``plot_labels`` (matplotlib, Agg): the
  images have the JAX figures' pixel size, and at most 0.5 % of their
  pixels differ, by at most 1 grey level on average over the image.
- With matplotlib hidden, each matplotlib plot logs its ``TryExcept``
  warning and returns None, on both sides.
- A small CPU run of each trainer with the default ``plots`` writes the
  same files, the JAX package's integration outputs (metrics.jsonl, event
  files; catalogue item 13) aside.
"""

import logging
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from yolo_ad_refine_tpu.utils import LOGGER as JAX_LOGGER
from yolo_ad_refine_tpu.utils import plotting as jplot
from yolo_ad_refine_tpu_torch.utils import LOGGER, TryExcept
from yolo_ad_refine_tpu_torch.utils import plotting as pplot

PIXEL_SHARE, MEAN_DIFF = 0.005, 1.0  # differing pixels, mean |difference| in grey levels


def assert_images_match(got_path, want_path, exact: bool = False):
    got, want = cv2.imread(str(got_path)), cv2.imread(str(want_path))
    assert got is not None and want is not None
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (diff.max(-1) > 0).mean() <= PIXEL_SHARE, (diff.max(-1) > 0).mean()
    assert diff.mean() <= MEAN_DIFF


def _batch(b: int, hw: int = 64, n: int = 5, seed: int = 0):
    r = np.random.default_rng(seed)
    xy = r.uniform(0, hw * 0.6, (b, n, 2))
    boxes = np.concatenate([xy, xy + r.uniform(4, hw * 0.4, (b, n, 2))], -1).astype(np.float32)
    mask = (r.random((b, n, 1)) < 0.7).astype(np.float32)
    cls = r.integers(0, 20, (b, n, 1)).astype(np.float32)
    return r.integers(0, 256, (b, hw, hw, 3), dtype=np.uint8), boxes, cls, mask


@pytest.mark.parametrize("b,names", [(1, None), (4, {0: "disc", 1: "box"}), (20, None)])
def test_plot_images_equal_to_jax(b, names, tmp_path):
    img, boxes, cls, mask = _batch(b, seed=b)
    got = pplot.plot_images(img, boxes, cls, mask, names, tmp_path / "port.jpg")
    want = jplot.plot_images(img, boxes, cls, mask, names, tmp_path / "jax.jpg")
    assert got.exists() and want.exists()
    assert_images_match(got, want, exact=True)


def test_plot_results_matches_jax(tmp_path):
    from yolo_ad_refine_tpu_torch.train.trainer import CSV_KEYS

    r = np.random.default_rng(1)
    lines = [",".join(CSV_KEYS)]
    for e in range(4):
        lines.append(",".join([str(e), f"{10.0 * (e + 1):.6g}"]
                              + [f"{v:.6g}" for v in r.uniform(0, 3, len(CSV_KEYS) - 2)]))
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "results.csv").write_text("\n".join(lines) + "\n")
    got = pplot.plot_results(tmp_path / "port" / "results.csv")
    want = jplot.plot_results(tmp_path / "jax" / "results.csv")
    assert got.name == want.name == "results.png"
    assert_images_match(got, want)
    cols = pplot.read_results_csv(tmp_path / "port" / "results.csv")
    assert list(cols) == list(CSV_KEYS) and cols["epoch"].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("nc", [3, 25])
def test_pr_curve_and_confusion_matrix_match_jax(nc, tmp_path):
    r = np.random.default_rng(nc)
    px = np.linspace(0, 1, 1000)
    py = np.sort(r.random((nc, 1000)), axis=1)[:, ::-1]
    ap = r.random((nc, 10))
    names = {i: f"c{i}" for i in range(nc)}
    matrix = r.integers(0, 9, (nc + 1, nc + 1)).astype(float)
    for mod, d in ((pplot, "port"), (jplot, "jax")):
        mod.plot_pr_curve(px, py, ap, tmp_path / f"{d}_pr.png", names)
        mod.plot_confusion_matrix(matrix, names, tmp_path / f"{d}_cm.png")
    assert_images_match(tmp_path / "port_pr.png", tmp_path / "jax_pr.png")
    assert_images_match(tmp_path / "port_cm.png", tmp_path / "jax_cm.png")


def test_plot_labels_matches_jax(tmp_path):
    _, boxes, cls, mask = _batch(6, hw=320, n=12, seed=5)
    valid = mask[..., 0] > 0
    for mod, d in ((pplot, "port"), (jplot, "jax")):
        (tmp_path / d).mkdir()
        mod.plot_labels(boxes[valid], cls[valid][:, 0], {}, tmp_path / d)
    assert_images_match(tmp_path / "port" / "labels.jpg", tmp_path / "jax" / "labels.jpg")


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.mark.parametrize("plot", ["plot_results", "plot_pr_curve", "plot_confusion_matrix",
                                  "plot_labels"])
def test_missing_matplotlib_warns_and_does_not_raise(plot, tmp_path, monkeypatch):
    (tmp_path / "results.csv").write_text("epoch,time,a\n0,1,2\n")
    call = {"plot_results": (tmp_path / "results.csv",),
            "plot_pr_curve": (np.linspace(0, 1, 5), np.ones((1, 5)), np.ones((1, 10)),
                              tmp_path / "pr.png"),
            "plot_confusion_matrix": (np.eye(2), {0: "a"}, tmp_path / "cm.png"),
            "plot_labels": (np.zeros((1, 4)), np.zeros(1), {}, tmp_path)}[plot]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    for mod, logger in ((pplot, LOGGER), (jplot, JAX_LOGGER)):
        records = _Records()
        logger.addHandler(records)
        try:
            assert getattr(mod, plot)(*call) is None
        finally:
            logger.removeHandler(records)
        assert any(m.startswith(f"{plot} failed") and "matplotlib" in m
                   for m in records.messages), records.messages
    assert not list(tmp_path.glob("*.png"))


def test_try_except_logs_and_returns_none():
    records = _Records()
    LOGGER.addHandler(records)
    try:
        @TryExcept("boom failed")
        def boom():
            raise ValueError("bad value")

        assert boom() is None and boom.__name__ == "boom"
        with TryExcept():
            raise KeyError("k")
    finally:
        LOGGER.removeHandler(records)
    assert records.messages == ["boom failed: bad value", "'k'"]


TINY = {"nc": 3,
        "backbone": [[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                     [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                     [-1, 1, "Conv", [32, 3, 2]]],
        "head": [[[2, 3, 4], 1, "Detect", ["nc"]]]}


def test_default_plots_write_the_jax_trainers_files(tmp_path):
    from yolo_ad_refine_tpu.train.trainer import DetectionTrainer as JaxTrainer
    from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
    from yolo_ad_refine_tpu_torch.train.trainer import DetectionTrainer

    data = make_shapes_dataset(tmp_path / "ds", n_train=6, n_val=4, imgsz=64, seed=2)
    args = {"model": TINY, "data": data, "epochs": 1, "batch": 2, "imgsz": 64, "max_boxes": 8,
            "workers": 2, "val": False}  # the last epoch still validates (and plots) the EMA
    want = JaxTrainer({**args, "project": str(tmp_path / "jax")}).train()
    got = DetectionTrainer({**args, "project": str(tmp_path / "port"), "device": "cpu"}).train()
    integrations = {"metrics.jsonl"}

    def files(save_dir):
        return {p.relative_to(save_dir).as_posix() for p in Path(save_dir).rglob("*")
                if p.is_file() and p.parent.name not in ("last", "best")  # checkpoint formats
                and p.name not in integrations and not p.name.startswith("events.")}

    expected = {"train_batch0.jpg", "train_batch1.jpg", "train_batch2.jpg", "results.png",
                "confusion_matrix.png", "results.csv", "args.yaml"}
    assert expected <= files(want["save_dir"])
    assert files(got["save_dir"]) == files(want["save_dir"])
    for name in ("train_batch0.jpg", "train_batch1.jpg", "train_batch2.jpg"):
        assert_images_match(f"{got['save_dir']}/{name}", f"{want['save_dir']}/{name}", exact=True)
