"""Executable detection graph.

Counterpart of ``yolo_ad_refine_tpu/models/model.py`` (reference
ultralytics/nn/tasks.py BaseModel._predict_once:141-168 savelist routing,
DetectionModel:309-398, WorldModel:603-669). The yaml rows are
``self.model[i]``, so parameter names read ``model.{i}.<...>`` as in the
reference. Strides are derived from shapes: the head divides the input
height by each level's height. A YOLO-World graph carries a text stream:
its C2fAttn rows read it as their guide, ImagePoolingAttn replaces it, and
WorldDetect scores against the original embeddings.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch import nn

from yolo_ad_refine_tpu_torch.models.parser import TEXT_MODULES, load_model_cfg, parse_model_yaml
from yolo_ad_refine_tpu_torch.nn.block import C2fAttn, ImagePoolingAttn
from yolo_ad_refine_tpu_torch.nn.head import ModulatedDeformConv, WorldDetect, v10Detect
from yolo_ad_refine_tpu_torch.nn.transformer import RTDETRDecoder
from yolo_ad_refine_tpu_torch.utils import LOGGER, select_device

# any other head: detect
HEAD_TASKS = {"OBB": "obb", "Segment": "segment", "Pose": "pose", "Classify": "classify"}
_WEIGHTED = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear, ModulatedDeformConv)


def _require_text(txt, module: nn.Module):
    if txt is None:
        raise ValueError(
            f"{type(module).__name__} needs text embeddings: call set_classes(names) on the "
            "YOLO facade (offline hashed-n-gram encoder) or pass text_feats")
    return txt


def placeholder_text(nc: int, embed: int) -> np.ndarray:
    """The text embeddings a YOLO-World graph starts with until
    ``set_classes``: (nc, embed) standard normal from
    ``np.random.default_rng(0)``, each row L2-normalised, as the JAX
    DetectionModel draws them (the reference seeds a randn placeholder)."""
    t = np.random.default_rng(0).standard_normal((nc, embed)).astype(np.float32)
    return t / np.linalg.norm(t, axis=-1, keepdims=True)


class DetectionModel(nn.Module):
    """A yaml-built detector. ``forward`` in eval mode returns the head's
    eval output: ``(y, feats)`` with y (B, N, 4+nc), or for the OBB head
    ``(y, (feats, angle))`` with the angle appended to y (Segment:
    ``(y, (feats, mc, proto))``, the coefficients appended; Pose:
    ``(y, (feats, kpt))``, the decoded keypoints appended); in train mode the
    per-level maps (with the head's extra outputs for OBB, Segment, Pose).
    v10Detect returns (det, {"one2many", "one2one"}) in eval and the dict
    in train; Classify the softmax in eval and the logits in train;
    RTDETRDecoder (y, raw) in eval, y (B, nq, 4+nc) normalised xywh and
    scores, and raw in train, where ``dn`` (its denoising group) reaches
    the head. A
    YOLO-World graph (C2fAttn / ImagePoolingAttn rows) takes ``text_feats``
    (nc, embed), by default ``self.text_feats`` (the placeholder until
    ``set_classes``); WorldDetect's eval output has a class column per
    text row. ``task`` follows the head, as the JAX predictor derives it
    (reference: the task guessed from the model)."""

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
        # YOLO-World graphs need a text stream from their first forward; a
        # host tensor (not a buffer: no weight of its own), moved per forward
        self.text_feats = None
        if any(s.name in TEXT_MODULES for s in self.specs):
            head = self.model[self.head_idx] if self.head_idx >= 0 else None
            embed = int(getattr(head, "embed", 512) or 512)
            self.text_feats = torch.from_numpy(placeholder_text(self.nc, embed))

    @property
    def task(self) -> str:
        return HEAD_TASKS.get(self.specs[self.head_idx].name, "detect")

    @property
    def head_kind(self) -> str:
        """How the eval output is read: "v10" (selected rows, no NMS),
        "world" (a score column per text row), "rtdetr" (normalised xywh,
        no NMS) or "detect" (any other head)."""
        head = self.model[self.head_idx]
        for kind, cls in (("rtdetr", RTDETRDecoder), ("v10", v10Detect), ("world", WorldDetect)):
            if isinstance(head, cls):
                return kind
        return "detect"

    @property
    def n_scores(self) -> int:
        """The class columns of the eval output: the text rows of a
        YOLO-World graph (after ``set_classes``, its vocabulary), else nc."""
        return int(self.text_feats.shape[0]) if self.text_feats is not None else self.nc

    @property
    def deconv_layer_indices(self) -> tuple:
        """Yaml rows that are ConvTranspose2d: their weights are (I, O, kh, kw)."""
        return tuple(s.i for s in self.specs if isinstance(s.module, nn.ConvTranspose2d))

    def _text_stream(self, x, text_feats):
        """(the text embeddings on ``x``'s device, the running text stream
        batched (B, nc, embed)), both None for a graph without text."""
        if text_feats is None:
            text_feats = self.text_feats
        if text_feats is None:
            return None, None
        text_feats = torch.as_tensor(text_feats, dtype=torch.float32).to(x.device)
        return text_feats, text_feats.expand(x.shape[0], *text_feats.shape)

    def _row_input(self, i: int, out, ys: list):
        def fetch(j):
            return out if j == -1 else ys[j % i]

        f = self.froms[i]
        return fetch(f) if isinstance(f, int) else [fetch(j) for j in f]

    def _call_row(self, i: int, inp, txt, text_feats, input_h: int, dn: dict | None = None):
        m = self.model[i]
        if i == self.head_idx:
            if isinstance(m, WorldDetect):  # scores against the original embeddings
                return m(inp, text_feats=text_feats, input_h=input_h)
            if dn is not None and not isinstance(self.froms[i], int):
                return m(inp, input_h=input_h, dn=dn)  # RT-DETR's denoising group
            return m(inp, input_h=input_h)
        if isinstance(m, (C2fAttn, ImagePoolingAttn)):
            return m(inp, _require_text(txt, m))
        return m(inp)

    def _after_row(self, i: int, inp, y, txt, ys: list):
        """(the running output, the text stream) after row i; its output is
        kept in ``ys`` where a later row reads it."""
        if isinstance(self.model[i], ImagePoolingAttn):
            txt, y = y, inp[0]  # the rows after it route around it by index
        ys.append(y if i in self.save else None)
        return y, txt

    def forward(self, x, text_feats=None, dn: dict | None = None):
        input_h = x.shape[2]
        text_feats, txt = self._text_stream(x, text_feats)
        ys: list = []
        out = x
        for i in range(len(self.model)):
            inp = self._row_input(i, out, ys)
            y = self._call_row(i, inp, txt, text_feats, input_h, dn)
            if i == self.head_idx:
                return y
            out, txt = self._after_row(i, inp, y, txt, ys)
        return out

    @torch.no_grad()
    def probe_strides(self, imgsz: int = 640) -> tuple | None:
        """Per-level strides from one eval forward of a zero image; None
        for Classify and RTDETRDecoder, which decode without strides (the
        JAX package's)."""
        if self.task == "classify" or self.head_kind == "rtdetr":
            return None
        p = next(self.parameters())
        training = self.training
        self.eval()
        x = torch.zeros(1, 3, imgsz, imgsz, dtype=p.dtype, device=p.device).contiguous(
            memory_format=torch.channels_last)
        feats = self(x)[1]
        if isinstance(feats, dict):  # v10Detect: {"one2many", "one2one"}
            feats = feats["one2one"]
        if isinstance(feats, tuple):  # OBB, Segment, Pose: (feats, *extras)
            feats = feats[0]
        self.train(training)
        self.strides = tuple(imgsz // f.shape[2] for f in feats)
        return self.strides

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def info(self) -> dict:
        """Log and return the row count, parameter count and strides."""
        n = self.num_params()
        LOGGER.info(f"model: {len(self.specs)} layers, {n:,} parameters, strides {self.strides}")
        return {"layers": len(self.specs), "parameters": n, "strides": self.strides}

    @torch.no_grad()
    def profile(self, x=None, imgsz: int = 640, batch: int = 1, iters: int = 10,
                verbose: bool = True) -> list:
        """Per-row timing in eval mode (reference BaseModel._profile_one_layer,
        tasks.py:178): each yaml row runs ``iters`` times on its real input,
        on the model's device and in its dtype, after one warm-up call; on
        the card ``torch.cuda.synchronize()`` closes the warm-up and the
        timed calls. ``x`` defaults to a zero (batch, 3, imgsz, imgsz)
        image. Returns [(i, name, ms, params)] sorted by cost."""
        p = next(self.parameters())
        if x is None:
            x = torch.zeros(batch, 3, imgsz, imgsz, dtype=p.dtype, device=p.device)
        x = x.contiguous(memory_format=torch.channels_last)
        training = self.training
        self.eval()
        cuda = x.device.type == "cuda"
        text_feats, txt = self._text_stream(x, None)
        rows, ys, out = [], [], x
        for i, spec in enumerate(self.specs):
            inp = self._row_input(i, out, ys)
            y = self._call_row(i, inp, txt, text_feats, x.shape[2])
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                self._call_row(i, inp, txt, text_feats, x.shape[2])
            if cuda:
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / iters * 1e3
            rows.append((i, spec.name, ms, sum(q.numel() for q in self.model[i].parameters())))
            if i == self.head_idx:
                break
            out, txt = self._after_row(i, inp, y, txt, ys)
        self.train(training)
        rows.sort(key=lambda r: -r[2])
        if verbose:
            total = sum(r[2] for r in rows)
            for i, name, ms, n in rows:
                LOGGER.info(f"{i:>3} {name:<28} {ms:8.3f} ms ({ms / total * 100:5.1f}%) "
                            f"{n:>10,} params")
            LOGGER.info(f"total {total:.2f} ms/batch (bs={x.shape[0]})")
        return rows


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
        elif isinstance(m, WorldDetect) and m.default_text is not None:
            m.default_text.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, RTDETRDecoder):
            m.denoising_class_embed.normal_(0.0, 1.0, generator=generator)
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
