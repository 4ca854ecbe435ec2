"""YOLO user facade of the PyTorch port (reference engine/model.py Model).

``YOLO(model_yaml).predict(images)`` runs on the card by default
(``device="cuda"``) and raises where CUDA is absent; the CPU runs only
when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from yolo_ad_refine_tpu_torch.models.model import DetectionModel, build_detection_model
from yolo_ad_refine_tpu_torch.models.parser import load_model_cfg
from yolo_ad_refine_tpu_torch.utils import select_device


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to PyTorch yet ({item})")


class YOLO:
    """User-facing model facade: build from a yaml with seeded weights and
    predict."""

    def __init__(self, model: str = "yolo11n.yaml", device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32, seed: int = 0, imgsz: int = 640,
                 nc: int | None = None, verbose: bool = False):
        device = select_device(device)
        model = str(model)
        if not model.endswith((".yaml", ".yml")):
            _not_ported("loading a checkpoint", "ROADMAP Queue 1 item 7, engine/checkpoint.py")
        self.model: DetectionModel = build_detection_model(
            load_model_cfg(model), nc=nc, device=device, dtype=dtype, seed=seed, imgsz=imgsz,
            verbose=verbose)
        self.device, self.dtype, self.imgsz = device, dtype, imgsz
        self.overrides = {"model": model, "imgsz": imgsz}

    def predict(self, source=None, **kwargs):
        from yolo_ad_refine_tpu_torch.engine.predictor import DetectionPredictor

        return DetectionPredictor({**self.overrides, **kwargs})(source=source, model=self.model)

    def __call__(self, source=None, **kwargs):
        return self.predict(source, **kwargs)

    def train(self, **kwargs):
        _not_ported("train", "ROADMAP Queue 1 item 8, the train slice")

    def val(self, **kwargs):
        _not_ported("val", "ROADMAP Queue 1 item 7, the validation slice")

    def track(self, source=None, **kwargs):
        _not_ported("track", "ROADMAP Queue 1 item 15, trackers")

    def export(self, **kwargs):
        _not_ported("export", "ROADMAP Queue 1 item 11, export and serving")

    def info(self) -> dict:
        return {"layers": len(self.model.model), "parameters": self.model.num_params(),
                "strides": self.model.strides}
