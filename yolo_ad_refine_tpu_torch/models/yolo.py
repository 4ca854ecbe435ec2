"""YOLO user facade of the PyTorch port (reference engine/model.py Model).

``YOLO(model_yaml_or_checkpoint_dir, task=...)`` builds a model with seeded
weights (also from a model yaml's dict) or loads a checkpoint directory, one the port's trainer wrote or one
the JAX package wrote (``weights.msgpack``); ``.predict(images)``,
``.train(data=...)`` and ``.val(data=...)`` run on the card by default
(``device="cuda"``) and raise where CUDA is absent; the CPU runs only when
the caller passes ``device="cpu"`` (under a launcher, ``cuda`` is the
rank's card, ``utils.select_device``). ``task`` ("detect", "obb", "segment",
"pose" or "classify", as the JAX facade's) defaults to the one the model's
head implies, as the reference guesses it from the model; each predicts,
trains and validates, but classify, which trains and validates through
``train/classify.py`` (the JAX facade's ``train`` and ``val`` build the
detection engine, which cannot read class folders) and predicts nothing,
as the JAX package serves no classifier. ``set_classes`` sets a YOLO-World
model's vocabulary. ``.export``
writes the model for ``engine/exporter.py``'s ``AutoBackend``;
``.benchmark`` times the exported formats, ``.tune`` evolves the
training hyperparameters and ``.track`` follows objects through a video
with ByteTrack or BoT-SORT.
"""

from __future__ import annotations

import copy
from pathlib import Path

import torch

from yolo_ad_refine_tpu_torch.engine.checkpoint import load_checkpoint
from yolo_ad_refine_tpu_torch.models.model import DetectionModel, build_detection_model
from yolo_ad_refine_tpu_torch.models.parser import load_model_cfg
from yolo_ad_refine_tpu_torch.utils import LOGGER, increment_path, select_device
from yolo_ad_refine_tpu_torch.utils.callbacks import Callbacks


class YOLO:
    """User-facing model facade: build from a yaml with seeded weights (or
    load a checkpoint directory), predict, train and validate."""

    def __init__(self, model: str | dict = "yolo11n.yaml", task: str | None = None,
                 nc: int | None = None, dtype: torch.dtype = torch.float32, seed: int = 0,
                 imgsz: int = 640, verbose: bool = False, device: str | torch.device = "cuda"):
        device = select_device(device)
        if isinstance(model, dict):  # a model yaml's dict, e.g. a row swapped in a copy
            cfg, model = model, str(model.get("yaml_file", "model.yaml"))
        else:
            model = str(model)
            cfg = load_model_cfg(model) if model.endswith((".yaml", ".yml")) else None
        if cfg is not None:
            self.model: DetectionModel = build_detection_model(
                cfg, nc=nc, device=device, dtype=dtype, seed=seed, imgsz=imgsz, verbose=verbose)
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
        overrides = {**self.overrides, **kwargs, "mode": "train"}
        if self.task == "classify":
            from yolo_ad_refine_tpu_torch.train.classify import ClassificationTrainer

            trainer = ClassificationTrainer(overrides, model=self.model, callbacks=self.callbacks)
            results = trainer.train()
            self.model, self.trainer = trainer.model, trainer
            return results
        from yolo_ad_refine_tpu_torch.train.trainer import DetectionTrainer

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
        if self.task == "classify":  # top1 / top5 over data's val (else train) class folders
            from yolo_ad_refine_tpu_torch.train.classify import ClassificationDataset, validate

            root = Path(args["data"])
            ds = ClassificationDataset(root / "val" if (root / "val").exists() else root / "train",
                                       int(args["imgsz"]))
            return validate(self.model, ds, int(args["batch"]))
        args.update(plots=bool(kwargs.get("plots", False)), amp=bool(kwargs.get("amp", False)))
        if (args["plots"] or args.get("save_json")) and not args.get("save_dir"):
            args["save_dir"] = str(increment_path(
                Path(args.get("project") or "runs") / (args.get("name") or "val"),
                exist_ok=bool(args.get("exist_ok")), mkdir=True))
        self.validator = DetectionValidator(args=args)
        return self.validator(model=self.model)

    def set_classes(self, names: list, text_embeddings=None) -> "YOLO":
        """A YOLO-World model's vocabulary (JAX models/yolo.py:120-145,
        reference YOLOWorld.set_classes): ``text_embeddings`` (len(names),
        embed), or without them the names encoded by the offline hashed
        n-gram encoder (``utils/text.py``), as CLIP's weights are not
        shipped. The eval output then has a class column per name."""
        import numpy as np

        from yolo_ad_refine_tpu_torch.nn.head import WorldDetect

        head = self.model.model[self.model.head_idx]
        if not isinstance(head, WorldDetect):
            raise ValueError("set_classes requires a WorldDetect (yolo-world) model")
        self.model.names = dict(enumerate(names))
        if text_embeddings is not None:
            t = np.asarray(text_embeddings, np.float32)
            if t.ndim != 2 or t.shape[0] != len(names):
                raise ValueError(f"text_embeddings must be (len(names), embed), got {t.shape}")
        else:
            from yolo_ad_refine_tpu_torch.utils.text import encode_class_names

            t = encode_class_names([str(n) for n in names], head.embed)
            LOGGER.warning("set_classes without text_embeddings: using the offline hashed-n-gram "
                           "text encoder (no CLIP weights here; zero-shot semantics are degraded "
                           "— pass CLIP embeddings for parity)")
        self.model.text_feats = torch.from_numpy(t)
        return self

    def track(self, source=None, tracker: str = "bytetrack", **kwargs) -> list:
        """Multi-object tracking over ``source`` (``engine/track.py``):
        ``tracker`` "bytetrack" or "botsort", and imgsz, conf, iou, max_det,
        names, persist, vid_stride, tracker_args as the JAX facade takes
        them (imgsz 640 unless given, as in JAX); one frame a forward.
        Returns a Results a frame with track rows."""
        from yolo_ad_refine_tpu_torch.engine.track import track

        return track(self.model, source, tracker=tracker, **kwargs)

    def export(self, format: str = "torch_export", imgsz: int = 640, batch: int = 1,  # noqa: A002
               half: bool = True, path: str | None = None) -> Path:
        """Write this model as ``format`` (``engine/exporter.py``: checkpoint,
        torch_export (.pt2) or torchscript) for a fixed batch and imgsz,
        in bf16 with ``half``; returns the written path (``path``, by
        default ``model_<format>`` with the format's suffix)."""
        from yolo_ad_refine_tpu_torch.engine.exporter import Exporter

        exporter = Exporter(self.model, imgsz=imgsz, batch=batch, half=half)
        return exporter(format, path or f"model_{format}")

    def tune(self, iterations: int = 10, space: dict | None = None, **kwargs) -> dict:
        """Hyperparameter evolution (reference engine/model.py:811 Model.tune,
        ``engine/tuner.py``): each iteration trains a copy of this model
        with mutated hyperparameters. Returns the best hyperparameters;
        tune_results.csv, best_hyperparameters.yaml and the best weights
        land in ``<project>/tune[n]/``."""
        from yolo_ad_refine_tpu_torch.engine.tuner import Tuner

        tuner = Tuner({**self.overrides, **kwargs, "mode": "train"}, space=space)
        return tuner(lambda: copy.deepcopy(self.model), iterations=iterations)

    def benchmark(self, **kwargs) -> list[dict]:
        """The export-format matrix (``utils/benchmarks.py benchmark``):
        imgsz, batch, formats, save_dir. Returns a row per format."""
        from yolo_ad_refine_tpu_torch.utils.benchmarks import benchmark

        return benchmark(self, **kwargs)

    def info(self) -> dict:
        return {"layers": len(self.model.model), "parameters": self.model.num_params(),
                "strides": self.model.strides}
