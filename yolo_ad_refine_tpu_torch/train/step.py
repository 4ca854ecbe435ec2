"""One training step: forward, loss, backward, optimizer, EMA.

Counterpart of ``yolo_ad_refine_tpu/train/step.py`` (reference
engine/trainer.py:367-427): uint8 images are scaled by 1/255, the model
runs its train-mode forward (under bf16 autocast when ``amp_dtype`` is
set), the loss runs in fp32, the gradient flows back through K1 bwd on the
card, the optimizer steps every ``accumulate`` batches and the EMA of
params and BN stats advances on each optimizer step. The JAX package's
train-prologue and remat options shape XLA programs on the TPU and have no
counterpart here.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from yolo_ad_refine_tpu_torch.train.loss import DetectionLoss
from yolo_ad_refine_tpu_torch.train.optim import ModelEMA, Optimizer


def images_to_tensor(img, device) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB (numpy or tensor) -> (B, 3, H, W) channels_last
    float32 in [0, 1] on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(img)) if isinstance(img, np.ndarray) else img
    t = t.to(device, non_blocking=True).permute(0, 3, 1, 2)
    return (t.float() / 255.0).contiguous(memory_format=torch.channels_last)


def targets_to_device(batch: dict, device):
    return tuple(torch.as_tensor(batch[k]).to(device, non_blocking=True)
                 for k in ("cls", "bboxes", "mask"))


class TrainStep:
    """Callable train step over a model, its loss, optimizer and EMA.
    ``__call__(batch)`` returns the metrics as device tensors (no sync):
    loss, box_loss, cls_loss, dfl_loss and dcn_offset_max. ``on_phase``, when
    set, is called with each phase's name (``PHASES``) as the phase ends;
    ``engine/profile_train.py`` times the phases through it."""

    PHASES = ("forward", "loss", "backward", "optimizer + EMA")

    def __init__(self, model: nn.Module, loss_fn: DetectionLoss, optimizer: Optimizer,
                 ema: ModelEMA, amp_dtype: torch.dtype | None = None):
        self.model, self.loss_fn, self.optimizer, self.ema = model, loss_fn, optimizer, ema
        self.amp_dtype = amp_dtype
        self.on_phase = None

    def _end(self, phase: str) -> None:
        if self.on_phase is not None:
            self.on_phase(phase)

    def __call__(self, batch: dict) -> dict:
        model = self.model
        dev = next(model.parameters()).device
        model.train()
        img = images_to_tensor(batch["img"], dev)
        cls, bboxes, mask = targets_to_device(batch, dev)
        ctx = (torch.autocast(dev.type, dtype=self.amp_dtype) if self.amp_dtype is not None
               else contextlib.nullcontext())
        with ctx:
            feats = model(img)
        self._end("forward")
        out = self.loss_fn(feats, cls, bboxes, mask)
        self._end("loss")
        out.total.backward()
        self._end("backward")
        if self.optimizer.step():
            self.ema.update(model)
        self._end("optimizer + EMA")
        off_max = getattr(model.model[model.head_idx], "dcn_offset_max", None)
        c = out.components
        return {"loss": out.total.detach(), "components": c, "box_loss": c[0], "cls_loss": c[1],
                "dfl_loss": c[2],
                "dcn_offset_max": off_max if off_max is not None else torch.zeros((), device=dev)}
