"""Executable detection graph.

Counterpart of ``yolo_ad_refine_tpu/models/model.py`` (reference
ultralytics/nn/tasks.py BaseModel._predict_once:141-168 savelist routing,
DetectionModel:309-398). The yaml rows are ``self.model[i]``, so parameter
names read ``model.{i}.<...>`` as in the reference. Strides are derived from
shapes: the head divides the input height by each level's height.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from yolo_ad_refine_tpu_torch.models.parser import load_model_cfg, parse_model_yaml
from yolo_ad_refine_tpu_torch.nn.head import ModulatedDeformConv
from yolo_ad_refine_tpu_torch.utils import LOGGER, select_device

HEAD_TASKS = {"OBB": "obb", "Segment": "segment", "Pose": "pose"}  # any other head: detect
_WEIGHTED = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear, ModulatedDeformConv)


class DetectionModel(nn.Module):
    """A yaml-built detector. ``forward`` in eval mode returns the head's
    eval output: ``(y, feats)`` with y (B, N, 4+nc), or for the OBB head
    ``(y, (feats, angle))`` with the angle appended to y (Segment:
    ``(y, (feats, mc, proto))``, the coefficients appended; Pose:
    ``(y, (feats, kpt))``, the decoded keypoints appended); in train mode the
    per-level maps (with the head's extra outputs for OBB, Segment, Pose). ``task`` follows the head, as
    the JAX predictor derives it (reference: the task guessed from the
    model)."""

    def __init__(self, cfg: str | dict = "yolo11n.yaml", ch: int = 3, nc: int | None = None,
                 verbose: bool = False):
        super().__init__()
        self.yaml = load_model_cfg(cfg)
        if nc and nc != self.yaml.get("nc"):
            LOGGER.info(f"Overriding model.yaml nc={self.yaml.get('nc')} with nc={nc}")
            self.yaml["nc"] = nc
        self.specs, self.meta = parse_model_yaml(self.yaml, ch=ch, verbose=verbose)
        self.nc = self.meta["nc"]
        self.model = nn.ModuleList(s.module for s in self.specs)
        self.froms = [s.f for s in self.specs]
        self.save = set(self.meta["save"])
        self.head_idx = next((s.i for s in self.specs if s.is_head), -1)
        self.strides = None
        self.names = {i: f"class{i}" for i in range(self.nc)}

    @property
    def task(self) -> str:
        return HEAD_TASKS.get(self.specs[self.head_idx].name, "detect")

    @property
    def deconv_layer_indices(self) -> tuple:
        """Yaml rows that are ConvTranspose2d: their weights are (I, O, kh, kw)."""
        return tuple(s.i for s in self.specs if isinstance(s.module, nn.ConvTranspose2d))

    def forward(self, x):
        input_h = x.shape[2]
        ys: list = []
        out = x
        for i, (m, f) in enumerate(zip(self.model, self.froms)):

            def fetch(j, i=i):
                return out if j == -1 else ys[j % i]

            if i == self.head_idx:
                return m([fetch(j) for j in f], input_h=input_h)
            out = m(fetch(f) if isinstance(f, int) else [fetch(j) for j in f])
            ys.append(out if i in self.save else None)
        return out

    @torch.no_grad()
    def probe_strides(self, imgsz: int = 640) -> tuple:
        """Per-level strides from one eval forward of a zero image."""
        p = next(self.parameters())
        training = self.training
        self.eval()
        x = torch.zeros(1, 3, imgsz, imgsz, dtype=p.dtype, device=p.device).contiguous(
            memory_format=torch.channels_last)
        feats = self(x)[1]
        if isinstance(feats, tuple):  # OBB, Segment, Pose: (feats, *extras)
            feats = feats[0]
        self.train(training)
        self.strides = tuple(imgsz // f.shape[2] for f in feats)
        return self.strides

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every conv / linear weight from ``generator``: uniform with
    bound 1/sqrt(fan_in), PyTorch's default; biases likewise. Norm layers
    and the modules' own constant parameters keep their constructor values,
    and heads set their bias priors."""
    for m in model.modules():
        if isinstance(m, _WEIGHTED):
            bound = 1.0 / math.sqrt(math.prod(m.weight.shape[1:]))  # torch's fan_in
            m.weight.uniform_(-bound, bound, generator=generator)
            if getattr(m, "bias", None) is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.MultiheadAttention):
            bound = 1.0 / math.sqrt(m.embed_dim)
            m.in_proj_weight.uniform_(-bound, bound, generator=generator)
            m.in_proj_bias.zero_()
    for m in model.modules():
        if hasattr(m, "bias_init"):
            m.bias_init()


def build_detection_model(cfg, nc: int | None = None, device: str | torch.device = "cuda",
                          dtype=torch.float32, seed: int = 0, imgsz: int = 640,
                          verbose: bool = False) -> DetectionModel:
    """Build a model from a yaml, draw its weights from ``seed``, move it to
    ``device`` / ``dtype`` and probe its strides. Inputs are channels_last,
    which the convolutions follow. ``device`` defaults to the card and raises
    where CUDA is absent; the CPU runs only when the caller passes "cpu"."""
    device = select_device(device)
    model = DetectionModel(cfg, nc=nc, verbose=verbose)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device=device, dtype=dtype).eval()
    model.probe_strides(imgsz)
    return model
