"""Plots of a training run: batch mosaics, training curves, PR curves, the
confusion matrix and label statistics.

Counterpart of ``yolo_ad_refine_tpu/utils/plotting.py`` (reference
ultralytics/utils/plotting.py plot_results, plot_images, plot_labels and
the metrics.py plot hooks), host-side and drawing the same figures: the
mosaics with cv2, the rest with matplotlib on its Agg backend. Each plot
runs under ``TryExcept``, so a missing matplotlib (or any other failure)
logs a warning and the run goes on. ``plot_results`` reads ``results.csv``
with the ``csv`` module where the JAX package uses pandas.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from yolo_ad_refine_tpu_torch.utils import TryExcept

_COLORS = np.array([
    [4, 42, 255], [11, 219, 235], [243, 243, 243], [0, 223, 183], [17, 31, 104],
    [255, 111, 221], [255, 68, 79], [204, 237, 0], [0, 243, 68], [189, 127, 255],
    [101, 255, 0], [68, 243, 0], [255, 255, 0], [0, 204, 255], [255, 0, 111],
], dtype=np.uint8)


def color(i: int) -> tuple:
    c = _COLORS[i % len(_COLORS)]
    return int(c[0]), int(c[1]), int(c[2])


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def read_results_csv(csv_file: str | Path) -> dict[str, np.ndarray]:
    """results.csv as {column: float64 values}, in the header's order."""
    with open(csv_file, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [r for r in rows[1:] if r]
    return {k.strip(): np.asarray([float(r[j]) for r in body], np.float64)
            for j, k in enumerate(header)}


@TryExcept("plot_results failed")
def plot_results(csv_file: str | Path, save_path: str | Path | None = None):
    """Every results.csv column but epoch and time against the epoch, four
    plots a row, saved as results.png beside the csv."""
    plt = _pyplot()
    csv_file = Path(csv_file)
    cols = read_results_csv(csv_file)
    names = [c for c in cols if c not in ("epoch", "time")]
    n, ncols = len(names), 4
    nrows = -(-n // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 3 * nrows), squeeze=False)
    for i, c in enumerate(names):
        ax = axes[i // ncols][i % ncols]
        ax.plot(cols["epoch"], cols[c], marker=".", linewidth=1, markersize=4)
        ax.set_title(c, fontsize=9)
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.tight_layout()
    out = Path(save_path or csv_file.with_name("results.png"))
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


@TryExcept("plot_images failed")
def plot_images(images: np.ndarray, bboxes, cls, mask=None, names: dict | None = None,
                fname: str | Path = "batch.jpg", max_images: int = 16):
    """Mosaic of a batch with its boxes drawn. images (B, H, W, 3) uint8 RGB
    (the collate's order), bboxes (B, N, 4) xyxy px, cls (B, N, 1), mask
    (B, N, 1); written with cv2, so the canvas is flipped to BGR."""
    import cv2

    b = min(len(images), max_images)
    h, w = images.shape[1:3]
    ncols = int(np.ceil(np.sqrt(b)))
    nrows = -(-b // ncols)
    canvas = np.full((nrows * h, ncols * w, 3), 255, np.uint8)
    for i in range(b):
        r, c = divmod(i, ncols)
        im = images[i].copy()
        valid = (mask[i, :, 0] > 0) if mask is not None else np.ones(len(bboxes[i]), bool)
        for box, k in zip(bboxes[i][valid], cls[i][valid].reshape(-1)):
            p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
            cv2.rectangle(im, p1, p2, color(int(k)), 1)
            label = str((names or {}).get(int(k), int(k)))
            cv2.putText(im, label, (p1[0], max(p1[1] - 2, 8)), 0, 0.3, color(int(k)), 1)
        canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    Path(fname).parent.mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(fname), canvas[..., ::-1])
    return Path(fname)


@TryExcept("plot_pr_curve failed")
def plot_pr_curve(px, py, ap, save_path="PR_curve.png", names: dict | None = None):
    """Each class's precision over the recall grid, and their mean."""
    plt = _pyplot()
    fig, ax = plt.subplots(1, 1, figsize=(9, 6))
    py = np.asarray(py)
    for i, y in enumerate(py):
        label = f"{(names or {}).get(i, i)} {ap[i, 0]:.3f}" if len(py) <= 20 else None
        ax.plot(px, y, linewidth=1, label=label)
    ax.plot(px, py.mean(0), linewidth=3, color="blue",
            label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(fontsize=8)
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return Path(save_path)


@TryExcept("plot_confusion_matrix failed")
def plot_confusion_matrix(matrix: np.ndarray, names: dict, save_path="confusion_matrix.png",
                          normalize: bool = True):
    """The (nc + 1)² matrix, background last, columns normalised by default."""
    plt = _pyplot()
    m = matrix.astype(float)
    if normalize:
        m = m / (m.sum(0, keepdims=True) + 1e-9)
    nc = matrix.shape[0] - 1
    labels = [str(names.get(i, i)) for i in range(nc)] + ["background"]
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.imshow(m, cmap="Blues")
    ax.set_xticks(range(len(labels)))
    ax.set_yticks(range(len(labels)))
    ax.set_xticklabels(labels, rotation=90, fontsize=7)
    ax.set_yticklabels(labels, fontsize=7)
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return Path(save_path)


@TryExcept("plot_labels failed")
def plot_labels(boxes: np.ndarray, cls: np.ndarray, names: dict, save_dir: str | Path = "."):
    """Class histogram, box centres and box sizes, saved as labels.jpg."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    axes[0].hist(cls, bins=max(int(cls.max()) + 1 if len(cls) else 1, 1))
    axes[0].set_title("classes")
    if len(boxes):
        wh = boxes[:, 2:4] - boxes[:, :2]
        axes[1].scatter(boxes[:, 0] + wh[:, 0] / 2, boxes[:, 1] + wh[:, 1] / 2, s=2, alpha=0.4)
        axes[1].set_title("centers")
        axes[2].scatter(wh[:, 0], wh[:, 1], s=2, alpha=0.4)
        axes[2].set_title("width/height")
    out = Path(save_dir) / "labels.jpg"
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out
