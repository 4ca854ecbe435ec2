"""YOLO user facade of the PyTorch port (reference engine/model.py Model).

``YOLO(model_yaml_or_checkpoint_dir, task=...)`` builds a model with seeded
weights or loads a checkpoint directory, one the port's trainer wrote or one
the JAX package wrote (``weights.msgpack``); ``.predict(images)``,
``.train(data=...)`` and ``.val(data=...)`` run on the card by default
(``device="cuda"``) and raise where CUDA is absent; the CPU runs only when
the caller passes ``device="cpu"``. ``task`` ("detect" or "obb", as the JAX
facade's) defaults to the one the model's head implies, as the reference
guesses it from the model; OBB predicts and validates, and its training
raises until it is ported.
"""

from __future__ import annotations

from pathlib import Path

import torch

from yolo_ad_refine_tpu_torch.engine.checkpoint import load_checkpoint
from yolo_ad_refine_tpu_torch.models.model import DetectionModel, build_detection_model
from yolo_ad_refine_tpu_torch.models.parser import load_model_cfg
from yolo_ad_refine_tpu_torch.utils import increment_path, not_ported, select_device
from yolo_ad_refine_tpu_torch.utils.callbacks import Callbacks


class YOLO:
    """User-facing model facade: build from a yaml with seeded weights (or
    load a checkpoint directory), predict, train and validate."""

    def __init__(self, model: str = "yolo11n.yaml", task: str | None = None,
                 device: str | torch.device = "cuda", dtype: torch.dtype = torch.float32,
                 seed: int = 0, imgsz: int = 640, nc: int | None = None, verbose: bool = False):
        device = select_device(device)
        model = str(model)
        if model.endswith((".yaml", ".yml")):
            self.model: DetectionModel = build_detection_model(
                load_model_cfg(model), nc=nc, device=device, dtype=dtype, seed=seed,
                imgsz=imgsz, verbose=verbose)
        else:
            self.model = load_checkpoint(model, device).to(dtype)
        if task is not None and task != self.model.task:
            raise ValueError(f"task={task!r} does not fit {model}, whose head gives "
                             f"task={self.model.task!r}")
        self.task = self.model.task
        self.device, self.dtype, self.imgsz = device, dtype, imgsz
        self.overrides = {"model": model, "imgsz": imgsz, "task": self.task}
        self.callbacks = Callbacks()

    def add_callback(self, event: str, fn) -> None:
        """Run ``fn(trainer)`` at a trainer hook (utils/callbacks.py HOOKS)."""
        self.callbacks.add(event, fn)

    def predict(self, source=None, **kwargs):
        from yolo_ad_refine_tpu_torch.engine.predictor import DetectionPredictor

        return DetectionPredictor({**self.overrides, **kwargs})(source=source, model=self.model)

    def __call__(self, source=None, **kwargs):
        return self.predict(source, **kwargs)

    def train(self, **kwargs) -> dict:
        """Train this model with default.yaml merged with ``kwargs`` (data=,
        epochs=, batch= (-1: autobatch on the card), imgsz=, multi_scale=,
        cache=, resume= (a ``last`` directory of the port's or of the JAX
        package's), ...); afterwards ``self.model`` is the best checkpoint's
        model."""
        from yolo_ad_refine_tpu_torch.train.trainer import DetectionTrainer

        overrides = {**self.overrides, **kwargs, "mode": "train"}
        trainer = DetectionTrainer(overrides=overrides, model=self.model,
                                   callbacks=self.callbacks)
        results = trainer.train()
        best = trainer.wdir / "best"
        self.model = load_checkpoint(best, self.device) if (best / "weights.pt").exists() \
            else trainer.ema.ema
        self.trainer = trainer
        return results

    def val(self, **kwargs) -> dict:
        """Validate on ``data=`` (its val split) and return the metrics. The
        model runs in its own type; ``amp=True`` runs it under bf16 autocast
        on the card, as the trainer's validation does. ``rect=True`` (with
        ``rect_buckets``, 4) letterboxes into static aspect-ratio buckets.
        ``plots`` stays off unless asked; ``plots=True`` and
        ``save_json=True`` write into ``save_dir``, by default a new
        ``<project>/<name>`` (runs/val, runs/val2, ...)."""
        from yolo_ad_refine_tpu_torch.cfg.config import get_cfg
        from yolo_ad_refine_tpu_torch.engine.validator import DetectionValidator

        args = get_cfg({**self.overrides, **kwargs, "mode": "val"})
        args.update(plots=bool(kwargs.get("plots", False)), amp=bool(kwargs.get("amp", False)))
        if (args["plots"] or args.get("save_json")) and not args.get("save_dir"):
            args["save_dir"] = str(increment_path(
                Path(args.get("project") or "runs") / (args.get("name") or "val"),
                exist_ok=bool(args.get("exist_ok")), mkdir=True))
        self.validator = DetectionValidator(args=args)
        return self.validator(model=self.model)

    def track(self, source=None, **kwargs):
        not_ported("track", "ROADMAP Queue 1 item 15, trackers")

    def export(self, **kwargs):
        not_ported("export", "ROADMAP Queue 1 item 11, export and serving")

    def info(self) -> dict:
        return {"layers": len(self.model.model), "parameters": self.model.num_params(),
                "strides": self.model.strides}
