"""Detection trainer on one device.

Counterpart of the detect path of ``yolo_ad_refine_tpu/train/trainer.py``
(reference engine/trainer.py:58-813 BaseTrainer, models/yolo/detect/
train.py:19-143): default.yaml merged with the overrides, the augmented
train loader, a train step per batch (bf16 autocast on the card when
``amp``, fp32 on the CPU), EMA validation every epoch and always at the
last, ``results.csv`` with the JAX package's 16 columns, ``last`` and
``best`` checkpoints (best by the fork's fitness 0.9 mAP50 + 0.1 mAP50-95),
early stopping, close_mosaic, resume (from the port's ``last`` or the JAX
package's), and a final validation of ``best``. The options of a user's
yaml run as in the JAX package: ``plots`` (the first three batches of
epoch 0 as ``train_batch{0,1,2}.jpg``, ``results.png``, and the
validator's confusion matrix and PR curve), ``multi_scale`` (each batch
resized on the host to one of the stride-64 sizes from 0.5 to 1.5 imgsz,
drawn from ``seed + epoch``), ``cache`` (ram / disk) and ``batch=-1``
(autobatch from the card's memory, ``utils/autobatch.py``).
"""

from __future__ import annotations

import copy
import time
from pathlib import Path

import numpy as np
import torch

from yolo_ad_refine_tpu_torch.cfg.config import get_cfg
from yolo_ad_refine_tpu_torch.data.build import DataLoader
from yolo_ad_refine_tpu_torch.data.dataset import YOLODataset, check_det_dataset
from yolo_ad_refine_tpu_torch.engine.checkpoint import (
    load_checkpoint, load_train_state, save_checkpoint)
from yolo_ad_refine_tpu_torch.engine.validator import DetectionValidator
from yolo_ad_refine_tpu_torch.models.model import DetectionModel, build_detection_model
from yolo_ad_refine_tpu_torch.train.loss import DetectionLoss
from yolo_ad_refine_tpu_torch.train.optim import ModelEMA, build_optimizer
from yolo_ad_refine_tpu_torch.train.step import TrainStep
from yolo_ad_refine_tpu_torch.utils import (
    LOGGER, colorstr, increment_path, not_ported, select_device, yaml_save)
from yolo_ad_refine_tpu_torch.utils.callbacks import Callbacks
from yolo_ad_refine_tpu_torch.utils.plotting import plot_images, plot_results

CSV_KEYS = ("epoch", "time", "train/box_loss", "train/cls_loss", "train/dfl_loss",
            "metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
            "metrics/mAP50-95(B)", "val/box_loss", "val/cls_loss", "val/dfl_loss",
            "lr/pg0", "lr/pg1", "lr/pg2", "train/dcn_offset_max")

# options the port does not run yet, with the ROADMAP item that brings them
NOT_PORTED = {"fsdp": "ROADMAP Queue 1 item 10, DDP/FSDP"}


def multi_scale_batch(batch: dict, imgsz: int, rng: np.random.Generator) -> dict:
    """The JAX package's multi_scale (its train/trainer.py multi_scale_batch,
    reference detect/train.py:60-75) for detect batches: one size drawn
    from the multiples of 64 in [0.5, 1.5] imgsz, every image resized to it
    on the host with cv2's INTER_LINEAR and the boxes' first four columns
    scaled; a batch already at the drawn size passes unchanged."""
    import cv2

    lo, hi = (int(imgsz * 0.5) // 64) * 64, (int(imgsz * 1.5) // 64) * 64
    sizes = list(range(max(lo, 64), hi + 1, 64))
    sz = int(sizes[rng.integers(0, len(sizes))])
    if sz == batch["img"].shape[1]:
        return batch
    out = dict(batch)
    out["img"] = np.stack([cv2.resize(im, (sz, sz), interpolation=cv2.INTER_LINEAR)
                           for im in batch["img"]])
    out["bboxes"] = batch["bboxes"].copy()
    out["bboxes"][..., :4] *= sz / batch["img"].shape[1]  # column 4 (an OBB angle) keeps
    return out


def synthetic_batch(b: int, imgsz: int, max_boxes: int, nc: int, seed: int = 0) -> dict:
    """A seeded host batch in the collate's layout, 8 boxes an image (at
    most max_boxes), for measuring a train step without a dataset."""
    r = np.random.default_rng(seed)
    n = min(8, max_boxes)
    xy = r.uniform(0, imgsz * 0.7, (b, n, 2))
    boxes = np.zeros((b, max_boxes, 4), np.float32)
    boxes[:, :n] = np.concatenate([xy, xy + r.uniform(8, imgsz * 0.3, (b, n, 2))], -1)
    cls = np.zeros((b, max_boxes, 1), np.float32)
    cls[:, :n] = r.integers(0, nc, (b, n, 1))
    mask = np.zeros((b, max_boxes, 1), np.float32)
    mask[:, :n] = 1.0
    return {"img": r.integers(0, 256, (b, imgsz, imgsz, 3), dtype=np.uint8), "cls": cls,
            "bboxes": boxes, "mask": mask}


class EarlyStopping:
    """Stop when fitness stalls for ``patience`` epochs (reference
    torch_utils.py:716-758)."""

    def __init__(self, patience: int = 100):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_epoch, self.best_fitness = epoch, fitness
        stop = (epoch - self.best_epoch) >= self.patience
        if stop:
            LOGGER.info(f"EarlyStopping: no improvement in last {self.patience} epochs.")
        return stop


class DetectionTrainer:
    """End-to-end detection training. ``model`` (a port DetectionModel)
    fixes the device and the starting weights; without it the model is
    built from ``overrides['model']`` on ``overrides['device']`` (the card
    by default). ``callbacks`` run at the hooks of utils/callbacks.py with
    the trainer as their argument."""

    def __init__(self, overrides: dict | None = None, model: DetectionModel | None = None,
                 callbacks: Callbacks | None = None):
        self.args = get_cfg(overrides)
        for key, item in NOT_PORTED.items():
            if self.args.get(key):
                not_ported(f"{key}=True in training", item)
        if self.args.get("task", "detect") != "detect":
            not_ported(f"training task {self.args['task']!r}",
                        "ROADMAP Queue 1 item 12, the other tasks")
        self.model = model
        self.device = (next(model.parameters()).device if model is not None
                       else select_device(self.args.get("device") or "cuda"))
        if int(self.args["batch"]) == -1 and self.device.type != "cuda":
            raise RuntimeError("batch=-1 (autobatch) measures the card's memory and runs on "
                               f"CUDA only; on {self.device.type} pass a batch size")
        self.epochs = int(self.args["epochs"])
        self.batch_size = int(self.args["batch"])
        self.imgsz = int(self.args["imgsz"])
        self.save_dir = increment_path(Path(self.args.get("project") or "runs") /
                                       (self.args.get("name") or "train"),
                                       exist_ok=bool(self.args.get("exist_ok")), mkdir=True)
        self.wdir = self.save_dir / "weights"
        self.wdir.mkdir(parents=True, exist_ok=True)
        self.csv = self.save_dir / "results.csv"
        self.best_fitness = 0.0
        self.start_epoch = 0
        self.dcn_offset_max = 0.0
        self.dcn_offset_max_run = 0.0
        self.callbacks = callbacks or Callbacks()
        self.current_epoch = 0
        self.last_epoch_scalars: dict = {}
        self.autobatch: dict | None = None  # the batch=-1 measurement, when it ran

    # -- setup ------------------------------------------------------------
    def _setup(self):
        args = self.args
        data = check_det_dataset(args["data"])
        self.data = data
        hyp = {k: args[k] for k in ("hsv_h", "hsv_s", "hsv_v", "degrees", "translate", "scale",
                                    "shear", "perspective", "flipud", "fliplr", "mosaic",
                                    "mixup", "copy_paste")}
        max_boxes = int(args.get("max_boxes", 128))
        if self.model is None or self.model.nc != data["nc"]:
            cfg = self.model.yaml if self.model is not None else args["model"]
            self.model = build_detection_model(cfg, nc=data["nc"], device=self.device,
                                               seed=int(args.get("seed", 0)), imgsz=self.imgsz)
        self.model.float()
        self.amp_dtype = None
        if args.get("amp", True) and self.device.type == "cuda":
            from yolo_ad_refine_tpu_torch.utils.checks import check_amp

            self.amp_dtype = torch.bfloat16 if check_amp(self.model) else None
        self.loss_fn = DetectionLoss(nc=data["nc"], strides=self.model.strides,
                                     box_gain=float(args["box"]), cls_gain=float(args["cls"]),
                                     dfl_gain=float(args["dfl"]))
        if self.batch_size == -1:
            self.autobatch = self._autobatch()
            self.batch_size = self.args["batch"] = self.autobatch["batch"]

        train_ds = YOLODataset(data["train"], imgsz=self.imgsz, augment=True, hyp=hyp,
                               nc=data["nc"], max_boxes=max_boxes,
                               fraction=float(args.get("fraction", 1.0)),
                               cache_images=args.get("cache", False))
        self.train_loader = DataLoader(train_ds, batch_size=self.batch_size, shuffle=True,
                                       seed=int(args.get("seed", 0)), drop_last=True,
                                       workers=args.get("workers"))
        self.nb = max(len(self.train_loader), 1)
        self.optimizer, self.accumulate, self.lr_fns = build_optimizer(
            self.model.named_parameters(), optimizer=args.get("optimizer", "auto"),
            lr0=float(args["lr0"]), lrf=float(args["lrf"]), momentum=float(args["momentum"]),
            weight_decay=float(args["weight_decay"]), epochs=self.epochs, nb=self.nb,
            batch=self.batch_size, nbs=int(args.get("nbs", 64)),
            warmup_epochs=float(args.get("warmup_epochs", 3.0)),
            warmup_momentum=float(args.get("warmup_momentum", 0.8)),
            warmup_bias_lr=float(args.get("warmup_bias_lr", 0.1)),
            cos_lr=bool(args.get("cos_lr", False)), nc=data["nc"])
        self.ema = ModelEMA(self.model)

        resume = args.get("resume")
        if resume:  # the port's last (train.pt) or the JAX package's (train.msgpack)
            ckpt = Path(str(resume)) if Path(str(resume)).exists() else self.wdir / "last"
            if not any((ckpt / f).exists() for f in ("train.pt", "train.msgpack")):
                raise FileNotFoundError(f"resume checkpoint not found at {ckpt}")
            self.start_epoch, self.best_fitness, self.dcn_offset_max_run = load_train_state(
                ckpt, self.model, self.ema, self.optimizer)
            LOGGER.info(f"resuming from {ckpt} at epoch {self.start_epoch} "
                        f"(best fitness {self.best_fitness:.4f})")
        self.train_step = TrainStep(self.model, self.loss_fn, self.optimizer, self.ema,
                                    self.amp_dtype)

        self.validator = DetectionValidator(args={
            **{k: args[k] for k in ("imgsz", "iou", "max_det", "max_boxes")},
            "batch": self.batch_size, "conf": 0.001, "split": args.get("split", "val"),
            "amp": self.amp_dtype is not None, "plots": bool(args.get("plots", True)),
            "save_dir": str(self.save_dir)})
        val_path = data.get(args.get("split", "val")) or data["train"]
        val_ds = YOLODataset(val_path, imgsz=self.imgsz, augment=False, nc=data["nc"],
                             max_boxes=max_boxes)
        self.val_loader = DataLoader(val_ds, batch_size=self.batch_size, shuffle=False)
        self.validator.names = data["names"]
        self.stopper = EarlyStopping(int(args.get("patience", 100)))
        yaml_save(self.save_dir / "args.yaml", self.args)

    def probe_step(self, b: int) -> None:
        """One real train step of this model at batch ``b`` on seeded data
        (forward, loss, backward, SGD step, EMA), on a copy of the model, so
        the run's weights do not move: what autobatch measures."""
        nc, max_boxes = self.model.nc, int(self.args.get("max_boxes", 128))
        model = copy.deepcopy(self.model).train()
        opt, _, _ = build_optimizer(model.named_parameters(), optimizer="SGD", epochs=1, nb=1,
                                    batch=b, nbs=b, warmup_epochs=0.0, nc=nc)
        TrainStep(model, self.loss_fn, opt, ModelEMA(model), self.amp_dtype)(
            synthetic_batch(b, self.imgsz, max_boxes, nc))

    def _autobatch(self) -> dict:
        """batch=-1: the largest power-of-two batch whose train step fits
        ``autobatch_fraction`` (0.60) of the card (utils/autobatch.py)."""
        from yolo_ad_refine_tpu_torch.utils.autobatch import autobatch

        return autobatch(self.probe_step, self.device,
                         fraction=float(self.args.get("autobatch_fraction") or 0.60))

    # -- loop ----------------------------------------------------------------
    def train(self) -> dict:
        self._setup()
        args = self.args
        LOGGER.info(f"{colorstr('trainer:')} {len(self.train_loader.dataset)} train imgs, "
                    f"{len(self.val_loader.dataset)} val imgs, {self.epochs} epochs, "
                    f"batch {self.batch_size} on {self.device}"
                    f"{' (bf16 autocast)' if self.amp_dtype is not None else ''}")
        close_mosaic = int(args.get("close_mosaic", 10))
        t_start = time.time()
        final_epoch = self.epochs - 1
        self.callbacks.run("on_train_start", self)
        results: dict = {}
        for epoch in range(self.start_epoch, self.epochs):
            self.current_epoch = epoch
            self.callbacks.run("on_train_epoch_start", self)
            if close_mosaic and epoch == self.epochs - close_mosaic:
                LOGGER.info("Closing dataloader mosaic")
                self.train_loader.close_mosaic()
            self.train_loader.set_epoch(epoch)
            epoch_metrics = []  # device scalars, fetched once per epoch
            ms_rng = np.random.default_rng(int(args.get("seed", 0)) + epoch)
            for nbatch, batch in enumerate(self.train_loader):
                if epoch == 0 and nbatch < 3 and args.get("plots", True):  # host arrays: no sync
                    plot_images(batch["img"], batch["bboxes"], batch["cls"], batch["mask"],
                                self.data["names"], self.save_dir / f"train_batch{nbatch}.jpg")
                if args.get("multi_scale"):
                    batch = multi_scale_batch(batch, self.imgsz, ms_rng)
                self.batch = batch  # the step's host batch, for the callbacks
                self.callbacks.run("on_train_batch_start", self)
                m = self.train_step(batch)
                epoch_metrics.append(torch.stack([m["box_loss"], m["cls_loss"], m["dfl_loss"],
                                                  m["dcn_offset_max"].float()]))
                self.callbacks.run("on_train_batch_end", self)
            fetched = torch.stack(epoch_metrics).cpu().numpy().astype(np.float64)
            mloss = fetched[:, :3].mean(axis=0)
            self.dcn_offset_max = float(fetched[:, 3].max())
            self.dcn_offset_max_run = max(self.dcn_offset_max, self.dcn_offset_max_run)
            self._check_dcn_offsets()

            results, fitness = {}, 0.0
            if args.get("val", True) or epoch == final_epoch:
                results = self.validator(model=self.ema.ema, dataloader=self.val_loader,
                                         loss_fn=self.loss_fn)
                fitness = results.get("fitness", 0.0)
            if fitness >= self.best_fitness:
                self.best_fitness = fitness
            self._log_epoch(epoch, mloss, results, time.time() - t_start)
            self.last_epoch_scalars = {
                "train/box_loss": float(mloss[0]), "train/cls_loss": float(mloss[1]),
                "train/dfl_loss": float(mloss[2]),
                **{k: float(v) for k, v in results.items() if isinstance(v, (int, float))}}
            self.callbacks.run("on_fit_epoch_end", self)
            self._save_ckpts(epoch, fitness)
            self.callbacks.run("on_model_save", self)
            if self.stopper(epoch, fitness):
                break

        self.model.names = self.data["names"]
        if args.get("plots", True):
            plot_results(self.csv)
        best = self.wdir / "best"
        if args.get("val", True) and (best / "weights.pt").exists():
            LOGGER.info(f"Validating {best}...")
            results = self.validator(model=load_checkpoint(best, self.device),
                                     dataloader=self.val_loader)
        self.callbacks.run("on_train_end", self)
        LOGGER.info(f"training complete in {(time.time() - t_start) / 3600:.3f} h; "
                    f"best fitness {self.best_fitness:.4f}")
        return {"best_fitness": self.best_fitness, "save_dir": str(self.save_dir), **results}

    def _check_dcn_offsets(self):
        """The DCN offset-bound guard (JAX train/trainer.py:392-398): the
        bounded kernels clip |offset| at the head's ``dcn_radius``, so warn
        when the epoch's max |offset| passes 0.9 of it."""
        head = self.model.model[self.model.head_idx]
        dcn_radius = float(getattr(head, "dcn_radius", 3.0))
        if self.dcn_offset_max > 0.9 * dcn_radius:
            LOGGER.warning(
                f"max |DCN offset| = {self.dcn_offset_max:.2f} is near/over the "
                f"Pallas kernel bound (radius {dcn_radius:g}); sampling is "
                f"clipped beyond it — consider raising DyDCNv2.radius")

    # -- logging / checkpoints ----------------------------------------------
    def _log_epoch(self, epoch: int, mloss, results: dict, elapsed: float):
        step = self.optimizer.batches
        lrs = [float(self.lr_fns[k](step)) for k in ("pg0", "pg1", "pg2")]
        vals = [epoch, elapsed, *[float(x) for x in mloss],
                *[results.get(k, 0.0) for k in CSV_KEYS[5:12]], *lrs, self.dcn_offset_max]
        header = not self.csv.exists()
        with open(self.csv, "a") as f:
            if header:
                f.write(",".join(CSV_KEYS) + "\n")
            f.write(",".join(f"{v:.6g}" if isinstance(v, float) else str(v) for v in vals) + "\n")
        LOGGER.info(f"epoch {epoch + 1}/{self.epochs} box {mloss[0]:.3f} cls {mloss[1]:.3f} "
                    f"dfl {mloss[2]:.3f} mAP50 {results.get('metrics/mAP50(B)', 0.0):.4f} "
                    f"fitness {results.get('fitness', 0.0):.4f}")

    def _save_ckpts(self, epoch: int, fitness: float):
        if not self.args.get("save", True):
            return
        common = dict(model=self.model, ema=self.ema, epoch=epoch, best_fitness=self.best_fitness,
                      train_args=self.args, names=self.data["names"],
                      dcn_offset_max=self.dcn_offset_max_run)
        save_checkpoint(self.wdir / "last", optimizer=self.optimizer, **common)
        if fitness >= self.best_fitness:
            save_checkpoint(self.wdir / "best", **common)
