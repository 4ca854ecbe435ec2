"""One training step: forward, loss, backward, optimizer, EMA.

Counterpart of ``yolo_ad_refine_tpu/train/step.py`` (reference
engine/trainer.py:367-427): uint8 images are scaled by 1/255, the model
runs its train-mode forward (under bf16 autocast when ``amp_dtype`` is
set), the loss runs in fp32 on that output whole (the per-level maps, or
the OBB head's (feats, angle), Segment's (feats, mc, proto), Pose's
(feats, kpt)) with the batch's targets and the task's extra ones (the
loss's ``extra_keys``: the segment batch's index ``masks``, the pose
batch's ``keypoints``), the gradient flows back through K1 bwd on the
card, the optimizer steps every ``accumulate`` batches and the EMA of
params and BN stats advances on each optimizer step. ``wrapped`` (DDP or
FSDP2, ``parallel.wrap_model``) runs the forward of a data-parallel step,
within ``parallel.global_batch`` with the loss, so that both compute the
global batch's statistics; DDP's all-reduce waits under ``no_sync`` for
the batch that steps the optimizer. ``dn_fn(batch, generator)`` (RT-DETR,
the JAX step's ``dn_fn`` hook) builds the denoising group from the batch's
targets on the device (``cls``, ``bboxes``, ``mask``) and a
torch.Generator on that device seeded with ``seed``, drawn anew each
step; the forward takes it as ``dn``. The JAX package's
train-prologue and remat options shape XLA programs on the TPU and have no
counterpart here.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from yolo_ad_refine_tpu_torch.parallel import global_batch
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
    loss, the components, box_loss (the first component), cls_loss and
    dfl_loss (the last two) and dcn_offset_max. ``on_phase``, when
    set, is called with each phase's name (``PHASES``) as the phase ends;
    ``engine/profile_train.py`` times the phases through it."""

    PHASES = ("forward", "loss", "backward", "optimizer + EMA")

    def __init__(self, model: nn.Module, loss_fn: DetectionLoss, optimizer: Optimizer,
                 ema: ModelEMA, amp_dtype: torch.dtype | None = None,
                 wrapped: nn.Module | None = None, dn_fn=None, seed: int = 0):
        self.model, self.loss_fn, self.optimizer, self.ema = model, loss_fn, optimizer, ema
        self.dn_fn, self.seed, self.generator = dn_fn, seed, None
        self.amp_dtype = amp_dtype
        self.wrapped = model if wrapped is None else wrapped
        self.data_parallel = wrapped is not None
        self.grads_pending = False  # DDP: this rank's summed gradients, not yet averaged
        self.on_phase = None

    def _end(self, phase: str) -> None:
        if self.on_phase is not None:
            self.on_phase(phase)

    def __call__(self, batch: dict) -> dict:
        model = self.model
        p = next(model.parameters())
        dev = p.device
        model.train()
        img = images_to_tensor(batch["img"], dev).to(p.dtype)  # fp64: the tests' reference
        cls, bboxes, mask = targets_to_device(batch, dev)
        extras = tuple(torch.as_tensor(batch[k]).to(dev, non_blocking=True)
                       for k in getattr(self.loss_fn, "extra_keys", ()))
        kw = {}
        if self.dn_fn is not None:
            if self.generator is None:
                self.generator = torch.Generator(device=dev).manual_seed(self.seed)
            kw["dn"] = self.dn_fn({"cls": cls, "bboxes": bboxes, "mask": mask}, self.generator)
        ctx =(torch.autocast(dev.type, dtype=self.amp_dtype) if self.amp_dtype is not None
               else contextlib.nullcontext())
        # DDP all-reduces the gradients only on the batch that steps the optimizer
        local = (isinstance(self.wrapped, nn.parallel.DistributedDataParallel)
                 and (self.optimizer.batches + 1) % self.optimizer.accumulate != 0)
        with self.wrapped.no_sync() if local else contextlib.nullcontext(), \
                global_batch(self.data_parallel):
            with ctx:
                feats = self.wrapped(img, **kw)
            self._end("forward")
            out = self.loss_fn(feats, cls, bboxes, mask, *extras)
            self._end("loss")
            out.total.backward()
        self.grads_pending = local
        self._end("backward")
        if self.optimizer.step():
            self.ema.update(model)
        self._end("optimizer + EMA")
        off_max = getattr(model.model[model.head_idx], "dcn_offset_max", None)
        c = out.components
        return {"loss": out.total.detach(), "components": c, "box_loss": c[0], "cls_loss": c[-2],
                "dfl_loss": c[-1],
                "dcn_offset_max": off_max if off_max is not None else torch.zeros((), device=dev)}

    @torch.no_grad()
    def average_pending_grads(self) -> None:
        """Average over the ranks the gradients that DDP's skipped
        all-reduces left local, so the summed gradient (a checkpoint's) is
        the global one; the next all-reduce averages them again unchanged."""
        if self.grads_pending:
            n = torch.distributed.get_world_size()
            for p in self.model.parameters():
                if p.grad is not None:
                    torch.distributed.all_reduce(p.grad)
                    p.grad.div_(n)
            self.grads_pending = False
