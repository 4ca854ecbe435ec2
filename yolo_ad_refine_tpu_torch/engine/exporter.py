"""Model export and the loader over exported artifacts (AutoBackend).

Counterpart of ``yolo_ad_refine_tpu/engine/exporter.py`` (reference
engine/exporter.py, nn/autobackend.py:54). The formats:

| format       | produces                                   | loader                        |
|--------------|--------------------------------------------|-------------------------------|
| checkpoint   | weights.pt + meta.yaml directory           | engine.checkpoint             |
| torch_export | ``.pt2`` (``torch.export``), the default   | ``torch.export.load``         |
| torchscript  | ``.torchscript`` (``torch.jit.trace``)     | ``torch.jit.load``            |

``torch_export`` is the port's counterpart of the JAX package's
``stablehlo``. The exported callable is the JAX one: an NHWC image batch in
0-255 (float32; ``AutoBackend`` casts uint8) at the fixed export batch and
imgsz -> the decoded (B, N, 4+nc) predictions, 4+nc+1 for an OBB model (its
angle last). The /255, the cast to the export's type and the NCHW layout
happen inside the program; NMS stays outside, as in the JAX package. A
``<file>.meta.json`` sidecar records imgsz, batch, nc, names, task,
strides, dtype, device, the DCN implementation and radius, and how the
validator reads the output: the head kind (``DetectionModel.head_kind``:
detect, v10, world or rtdetr) and the score columns (``n_scores``: a
YOLO-World model's vocabulary). A Classify model is not exported: the JAX
package serves no classifier (its exporter unpacks the output as (y,
feats)), and the program's first output would be one image's row.

The AYHead's DCN enters the program as the port's dispatcher op
(``yat_ad::dcn_forward``, or ``yat_ad::dcn_separable_forward`` /
``yat_ad::dcn_window_forward`` under ``YAT_DCN_IMPL=mxu`` / ``pallas``), so
a loaded program on the card launches the hand-written kernel. The choice
and the radius are read from the environment when the program is traced,
as the JAX exporter fixes them at its trace, and written to the sidecar.

Limits: a program runs on the device it was exported on (``torch.export``
and ``torch.jit.trace`` record the device of the tensors they create). A
``.torchscript`` file that calls a ``yat_ad::`` op loads only in a Python
process that has imported this package (``AutoBackend`` imports the ops
first); libtorch in C++ cannot load it. ``half=True`` exports the model in
bf16. StableHLO, SavedModel, TFLite and pb are JAX or TensorFlow formats,
ONNX needs a package this image lacks, and TensorRT, CoreML, ncnn and
paddle are other ecosystems: they raise ``UnsupportedFormat``.
"""

from __future__ import annotations

import copy
import json
import os
from pathlib import Path

import numpy as np
import torch
from torch import nn

from yolo_ad_refine_tpu_torch.utils import LOGGER, select_device

FORMATS = ("checkpoint", "torch_export", "torchscript")
SUFFIX = {"torch_export": ".pt2", "torchscript": ".torchscript"}
UNSUPPORTED = {
    "stablehlo": "StableHLO is the JAX package's format; torch_export (.pt2) is its counterpart",
    "saved_model": "a TensorFlow format, which the JAX package makes through jax2tf",
    "tflite": "a TensorFlow format, which the JAX package makes through jax2tf",
    "pb": "a TensorFlow format, which the JAX package makes through jax2tf",
    "onnx": "the onnx package is not available in this environment",
    "engine": "TensorRT is not available in this environment",
    "coreml": "CoreML is for Apple devices",
    "ncnn": "ncnn is for mobile CPUs",
    "paddle": "paddle is not available in this environment",
}


class UnsupportedFormat(ValueError):
    pass


class ExportedForward(nn.Module):
    """The exported callable: (B, H, W, 3) 0-255 -> the model's decoded
    predictions, with the model in ``dtype``."""

    def __init__(self, model: nn.Module, dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.dtype = dtype

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = (img.permute(0, 3, 1, 2).to(self.dtype) / 255.0).contiguous(
            memory_format=torch.channels_last)
        return self.model(x)[0]


def dcn_choice(model: nn.Module) -> dict:
    """The DCN implementation and radius the model's DyDCNv2 runs now (None
    for a model without one): what an export fixes at its trace."""
    from yolo_ad_refine_tpu_torch.nn.head import DyDCNv2
    from yolo_ad_refine_tpu_torch.ops.deform import dcn_impl

    dcn = next((m for m in model.modules() if isinstance(m, DyDCNv2)), None)
    if dcn is None:
        return {"dcn_impl": None, "dcn_radius": None}
    fn, radius = dcn_impl(dcn.radius)
    return {"dcn_impl": os.environ.get("YAT_DCN_IMPL", "auto"), "dcn_op": fn.__name__,
            "dcn_radius": radius}


class Exporter:
    """``Exporter(model, imgsz, batch, half)(fmt, path)`` writes ``model`` (a
    port DetectionModel) as ``fmt`` and returns the written path."""

    def __init__(self, model, imgsz: int = 640, batch: int = 1, half: bool = True):
        if model.task == "classify":
            raise ValueError(
                "exporting a Classify model: the JAX package serves and exports no classifier "
                "(its exporter unpacks the output as (y, feats)), and the exported callable "
                "returns the first output, which for a Classify head is the first image's "
                "probabilities; run the model's forward, or save it with "
                "engine.checkpoint.save_checkpoint")
        self.model = model
        self.imgsz = imgsz
        self.batch = batch
        self.dtype = torch.bfloat16 if half else torch.float32

    def __call__(self, fmt: str = "torch_export", path: str | Path = "export") -> Path:
        fmt = fmt.lower()
        if fmt in UNSUPPORTED:
            raise UnsupportedFormat(f"format '{fmt}': {UNSUPPORTED[fmt]}; the port exports "
                                    f"{', '.join(FORMATS)}")
        if fmt not in FORMATS:
            raise UnsupportedFormat(f"unknown format '{fmt}'; supported: {', '.join(FORMATS)}")
        out = getattr(self, f"export_{fmt}")(Path(path))
        LOGGER.info(f"export {fmt} -> {out}")
        return out

    def export_checkpoint(self, path: Path) -> Path:
        from yolo_ad_refine_tpu_torch.engine.checkpoint import save_checkpoint

        return save_checkpoint(path, model=self.model, names=getattr(self.model, "names", None))

    def _program(self) -> tuple[ExportedForward, torch.Tensor]:
        """The callable over a copy of the model in the export's type, and
        an example input at the export's shape on the model's device."""
        model = copy.deepcopy(self.model).eval().to(self.dtype)
        dev = next(model.parameters()).device
        example = torch.zeros((self.batch, self.imgsz, self.imgsz, 3), dtype=torch.float32,
                              device=dev)
        return ExportedForward(model, self.dtype).eval(), example

    def _write_meta(self, path: Path, fmt: str, device: torch.device) -> None:
        m = self.model
        meta = {"format": fmt, "imgsz": self.imgsz, "batch": self.batch, "nc": int(m.nc),
                "names": {int(k): v for k, v in (getattr(m, "names", None) or {}).items()},
                "task": m.task, "head": m.head_kind, "n_scores": int(m.n_scores),
                "strides": list(m.strides or ()),
                "dtype": str(self.dtype).removeprefix("torch."), "device": str(device),
                "input": "NHWC float32 RGB in 0-255", **dcn_choice(m)}
        Path(f"{path}.meta.json").write_text(json.dumps(meta, indent=1))

    def export_torch_export(self, path: Path) -> Path:
        prog, example = self._program()
        with torch.no_grad():
            exported = torch.export.export(prog, (example,))
        path = path.with_suffix(SUFFIX["torch_export"])
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.export.save(exported, str(path))
        self._write_meta(path, "torch_export", example.device)
        return path

    def export_torchscript(self, path: Path) -> Path:
        prog, example = self._program()
        with torch.no_grad():
            traced = torch.jit.trace(prog, (example,), check_trace=False)
        path = path.with_suffix(SUFFIX["torchscript"])
        path.parent.mkdir(parents=True, exist_ok=True)
        traced.save(str(path))
        self._write_meta(path, "torchscript", example.device)
        return path


def load_dcn_ops() -> None:
    """Import the modules that register the port's ``yat_ad::`` DCN ops, so a
    program that calls them resolves."""
    import yolo_ad_refine_tpu_torch.ops.deform  # noqa: F401
    import yolo_ad_refine_tpu_torch.ops.deform_mxu  # noqa: F401
    import yolo_ad_refine_tpu_torch.ops.deform_pallas  # noqa: F401


class AutoBackend:
    """Inference over an exported artifact: ``AutoBackend(weights)(img)`` ->
    the (B, N, 4+nc) decoded predictions on the backend's device.

    ``weights``: a checkpoint directory of the port's (``weights.pt``) or of
    the JAX package's (``weights.msgpack``, as its ``Exporter("checkpoint")``
    writes it); a ``.pt2`` or ``.torchscript`` file with its ``.meta.json``;
    or an ``http://<host:port>/<model>`` Triton Inference Server URL.
    ``device`` is the card unless the caller asks for the CPU; a ``.pt2`` or
    ``.torchscript`` program runs on the device it was exported on, and
    another raises. ``img``: (B, H, W, 3) RGB in 0-255, numpy or tensor,
    uint8 or float, at the artifact's batch and imgsz (a checkpoint takes
    any). ``meta`` holds the sidecar's keys (a checkpoint's: nc, names,
    task, strides); ``program`` is the loaded callable (a ``GraphModule``
    for ``.pt2``, a ``ScriptModule`` for ``.torchscript``)."""

    def __init__(self, weights: str | Path, device: str | torch.device = "cuda"):
        self.device = select_device(device)
        if isinstance(weights, str) and weights.startswith(("http://", "grpc://")):
            from yolo_ad_refine_tpu_torch.utils.triton import TritonRemoteModel

            self.kind, self.path = "triton", weights
            remote = TritonRemoteModel(weights)
            self.meta = {}
            self.program = lambda x: torch.from_numpy(
                np.ascontiguousarray(remote(x.cpu().numpy())[0])).to(self.device)
            return
        self.path = Path(weights)
        if self.path.is_dir() and any((self.path / f).exists()
                                      for f in ("weights.pt", "weights.msgpack")):
            from yolo_ad_refine_tpu_torch.engine.checkpoint import load_checkpoint

            self.kind = "checkpoint"
            model = load_checkpoint(self.path, self.device)
            if model.task == "classify":
                raise ValueError(f"{self.path}: AutoBackend serves detection models; the JAX "
                                 "package serves no classifier")
            self.meta = {"nc": model.nc, "names": model.names, "task": model.task,
                         "head": model.head_kind, "n_scores": model.n_scores,
                         "strides": list(model.strides or ()), **dcn_choice(model)}
            self.program = ExportedForward(model, next(model.parameters()).dtype).eval()
        elif self.path.suffix in (".pt2", ".torchscript"):
            self.meta = json.loads(Path(f"{self.path}.meta.json").read_text())
            self.meta["names"] = {int(k): v for k, v in self.meta["names"].items()}
            if torch.device(self.meta["device"]).type != self.device.type:
                raise ValueError(f"{self.path} was exported on {self.meta['device']} and runs "
                                 f"there; it cannot run on {self.device}: export it on the device "
                                 "that serves it")
            load_dcn_ops()  # the programs call the yat_ad:: ops by name
            if self.path.suffix == ".pt2":
                self.kind = "torch_export"
                self.program = torch.export.load(str(self.path)).module()
            else:
                self.kind = "torchscript"
                self.program = torch.jit.load(str(self.path), map_location=self.device)
        else:
            raise FileNotFoundError(f"unrecognized weights: {weights}")

    @property
    def nc(self) -> int | None:
        return self.meta.get("nc")

    @property
    def names(self) -> dict | None:
        return self.meta.get("names")

    @property
    def task(self) -> str:
        return self.meta.get("task", "detect")

    @property
    def head(self) -> str:
        """The head kind (detect, v10, world or rtdetr); a sidecar written
        without it counts as detect."""
        return self.meta.get("head", "detect")

    @property
    def n_scores(self) -> int | None:
        """The score columns; a sidecar written without them counts nc."""
        return self.meta.get("n_scores", self.nc)

    @property
    def batch(self) -> int | None:
        """The artifact's fixed batch (None: any)."""
        return self.meta.get("batch")

    def __call__(self, img) -> torch.Tensor:
        x = torch.as_tensor(np.ascontiguousarray(img) if isinstance(img, np.ndarray) else img)
        with torch.inference_mode():
            return self.program(x.to(self.device, torch.float32))
