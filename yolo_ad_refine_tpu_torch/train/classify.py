"""Classification: the class-folder dataset, its trainer and its validation.

Counterpart of ``yolo_ad_refine_tpu/train/classify.py`` (reference
models/yolo/classify/): a folder per class under ``<root>/train`` and
``<root>/val``, each image resized to imgsz x imgsz with cv2's INTER_LINEAR
and, in training, flipped left-right with probability 0.5 from a generator
seeded by the epoch; batches drop the final partial one, in training and in
validation alike, so top1 / top5 count full batches only. Training is
cross-entropy on the detection trainer's optimizer (``train/optim.py``,
"auto" by default) with the EMA advanced on every batch, as the JAX step
does; each epoch validates the EMA, and the run ends by writing the EMA as
``weights/best`` through ``engine/checkpoint.py``.

The JAX facade's ``train`` builds a detection trainer, which cannot read
class folders, so there only ``ClassificationTrainer`` itself trains a
classifier; the port's ``YOLO(<cls yaml>).train`` / ``.val`` and
``yat-torch classify train|val`` hand a Classify model to
``ClassificationTrainer`` / ``validate``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from yolo_ad_refine_tpu_torch.cfg.config import get_cfg
from yolo_ad_refine_tpu_torch.data.dataset import IMG_FORMATS
from yolo_ad_refine_tpu_torch.engine.checkpoint import save_checkpoint
from yolo_ad_refine_tpu_torch.models.model import DetectionModel, build_detection_model
from yolo_ad_refine_tpu_torch.train.optim import ModelEMA, build_optimizer
from yolo_ad_refine_tpu_torch.train.step import images_to_tensor
from yolo_ad_refine_tpu_torch.utils import LOGGER, increment_path, select_device
from yolo_ad_refine_tpu_torch.utils.callbacks import Callbacks


class ClassificationDataset:
    """Folder-per-class images under ``root``; classes sorted by name."""

    def __init__(self, root: str | Path, imgsz: int = 224, augment: bool = False):
        self.root = Path(root)
        self.imgsz = imgsz
        self.augment = augment
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        if not classes:
            raise FileNotFoundError(f"no class folders under {root}")
        self.names = dict(enumerate(classes))
        self.samples = [(str(f), ci) for ci, cname in enumerate(classes)
                        for f in sorted((self.root / cname).rglob("*"))
                        if f.suffix[1:].lower() in IMG_FORMATS]

    def __len__(self):
        return len(self.samples)

    def get(self, i: int, rng: np.random.Generator | None = None):
        """(RGB uint8 (imgsz, imgsz, 3), label) of sample ``i``."""
        import cv2

        path, label = self.samples[i]
        img = cv2.resize(cv2.imread(path), (self.imgsz, self.imgsz),
                         interpolation=cv2.INTER_LINEAR)
        if self.augment and rng is not None and rng.random() < 0.5:
            img = np.ascontiguousarray(np.fliplr(img))
        return img[..., ::-1], label

    def batches(self, batch_size: int, shuffle: bool, seed: int = 0):
        """(images (B, imgsz, imgsz, 3) uint8, labels (B,) int32) of the full
        batches, shuffled by ``seed`` when asked; the flips draw from a
        second generator of the same seed."""
        idx = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        rng = np.random.default_rng(seed)
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            imgs, labels = zip(*(self.get(int(j), rng) for j in idx[i: i + batch_size]))
            yield np.ascontiguousarray(np.stack(imgs)), np.asarray(labels, np.int32)


@torch.no_grad()
def validate(model: DetectionModel, dataset: ClassificationDataset, batch: int) -> dict:
    """top1 / top5 of ``model`` (eval mode: softmax) over the full batches
    of ``dataset``, ranked by numpy's argsort as in the JAX validation."""
    dev = next(model.parameters()).device
    training = model.training
    model.eval()
    correct1 = correct5 = total = 0
    for imgs, labels in dataset.batches(batch, shuffle=False):
        probs = model(images_to_tensor(imgs, dev).to(next(model.parameters()).dtype))
        top5 = np.argsort(-probs.float().cpu().numpy(), axis=-1)[:, :5]
        correct1 += int((top5[:, 0] == labels).sum())
        correct5 += int((top5 == labels[:, None]).any(-1).sum())
        total += len(labels)
    model.train(training)
    total = max(total, 1)
    return {"top1": correct1 / total, "top5": correct5 / total}


class ClassificationTrainer:
    """Cross-entropy training of a Classify-headed model on
    ``overrides["data"]``, a directory with ``train`` (and ``val``; without
    it the train split validates) class folders. ``model``, where given and
    of the dataset's class count, is trained in place of a fresh one built
    from ``overrides["model"]`` with ``seed``; it fixes the device, else
    ``overrides["device"]`` does (the card by default). ``callbacks`` run
    at ``on_train_batch_start`` / ``on_train_batch_end`` with the trainer
    as their argument, as the detection trainer's do."""

    def __init__(self, overrides: dict | None = None, model: DetectionModel | None = None,
                 callbacks: Callbacks | None = None):
        self.args = get_cfg(overrides or {})
        self.args.setdefault("imgsz", 224)
        self.model = model
        self.device = (next(model.parameters()).device if model is not None
                       else select_device(self.args.get("device") or "cuda"))
        self.callbacks = callbacks or Callbacks()

    def train(self) -> dict:
        args = self.args
        imgsz = int(args.get("imgsz") or 224)
        batch = int(args["batch"])
        epochs = int(args["epochs"])
        root = Path(args["data"])
        train_ds = ClassificationDataset(root / "train", imgsz, augment=True)
        val_ds = ClassificationDataset(root / "val" if (root / "val").exists() else root / "train",
                                       imgsz)
        nc = len(train_ds.names)
        model = self.model
        if model is None or model.nc != nc:
            cfg = model.yaml if model is not None else args["model"]
            model = build_detection_model(cfg, nc=nc, device=self.device,
                                          seed=int(args.get("seed", 0)), imgsz=imgsz)
        if model.task != "classify":
            raise ValueError(f"ClassificationTrainer trains a Classify model, not a {model.task!r} "
                             "one")
        model = model.float()
        model.names = train_ds.names
        nb = max(len(train_ds) // batch, 1)
        optimizer, _, _ = build_optimizer(
            model.named_parameters(), optimizer=args.get("optimizer", "auto"),
            lr0=float(args["lr0"]), lrf=float(args["lrf"]), momentum=float(args["momentum"]),
            weight_decay=float(args["weight_decay"]), epochs=epochs, nb=nb, batch=batch,
            warmup_epochs=float(args.get("warmup_epochs", 3.0)), nc=nc)
        ema = ModelEMA(model)
        save_dir = increment_path(Path(args.get("project") or "runs") / (args.get("name") or "cls"),
                                  mkdir=True)
        best_top1 = 0.0
        for epoch in range(epochs):
            losses = []
            model.train()
            for imgs, labels in train_ds.batches(batch, shuffle=True, seed=epoch):
                self.callbacks.run("on_train_batch_start", self)
                logits = model(images_to_tensor(imgs, self.device))
                loss = F.cross_entropy(logits, torch.from_numpy(labels).long().to(self.device))
                loss.backward()
                optimizer.step()
                ema.update(model)  # every batch, as the JAX step advances its EMA
                losses.append(loss.detach())
                self.callbacks.run("on_train_batch_end", self)
            metrics = validate(ema.ema, val_ds, batch)
            best_top1 = max(best_top1, metrics["top1"])
            mean_loss = float(torch.stack(losses).mean()) if losses else float("nan")
            LOGGER.info(f"epoch {epoch + 1}/{epochs} loss {mean_loss:.3f} "
                        f"top1 {metrics['top1']:.3f} top5 {metrics['top5']:.3f}")
        self.model = ema.ema
        self.model.names = train_ds.names
        save_checkpoint(save_dir / "weights" / "best", model=self.model, names=train_ds.names)
        return {"top1": best_top1, "save_dir": str(save_dir)}
