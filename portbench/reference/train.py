"""A training step of the flagship in plain PyTorch, fp32: forward in train
mode, the loss, backward, the global-norm clip at 10, Nesterov SGD with the
decay group's weight decay and the warm-up schedules, and the EMA of the
floating state. A frozen copy of the semantics of the port's
``train/step.py``, ``train/optim.py`` (``build_optimizer``, ``Optimizer``,
``ModelEMA``, ``make_lr_fn``, ``make_momentum_fn``) at accumulate 1.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.loss import detection_loss
from portbench.reference.modules import BatchNorm2d

# the shallow row whose first-step output is compared (row 1, the second stem
# conv: two convolutions deep, before rounding is amplified), for its first images
ROW, ROW_IMAGES = 1, 8


def group_of(name: str, p: torch.Tensor) -> str:
    last = name.split(".")[-1]
    if last.endswith("bias"):
        return "bias"
    return "nodecay" if (1 if last == "alphas" else p.ndim) <= 1 else "decay"


def targets(batch: dict, dev) -> tuple:
    """A host batch's class ids, boxes and mask on ``dev``."""
    return tuple(torch.from_numpy(batch[k]).to(dev) for k in ("cls", "bboxes", "mask"))


class Schedules:
    """lr of each group and SGD's momentum at optimizer step ``k``."""

    def __init__(self, h: dict, nb: int):
        self.h, self.nb = h, nb
        self.nw = max(round(h["warmup_epochs"] * nb), 100) if h["warmup_epochs"] > 0 else 0

    def lr(self, group: str, k: int) -> float:
        h = self.h
        base = h["lr0"] * ((1 - (k // self.nb) / h["epochs"]) * (1.0 - h["lrf"]) + h["lrf"])
        if self.nw == 0 or k >= self.nw:
            return base
        start = h["warmup_bias_lr"] if group == "bias" else 0.0
        return start + min(max(k / self.nw, 0.0), 1.0) * (base - start)

    def momentum(self, k: int) -> float:
        h = self.h
        if self.nw == 0:
            return h["momentum"]
        return h["warmup_momentum"] + min(max(k / self.nw, 0.0), 1.0) * (
            h["momentum"] - h["warmup_momentum"])


class Trainer:
    """Steps ``model`` (a ``reference.model.Detector`` on the card) as the
    program's trainer would at batch ``batch``; ``ema`` is a dict of fp32
    copies of its floating state."""

    def __init__(self, model, h: dict, nb: int, batch: int, nc: int):
        self.model, self.h, self.nc = model, h, nc
        self.sched = Schedules(h, nb)
        self.wd = h["weight_decay"] * batch * 1 / h["nbs"]
        self.groups = {n: group_of(n, p) for n, p in model.named_parameters()}
        self.buf: dict = {}
        self.steps = 0
        self.ema = {k: v.detach().float().clone() for k, v in model.state_dict().items()
                    if v.dtype.is_floating_point}
        self.first_grad: dict = {}
        self.first_maps: list = []
        self.first_row = None
        row = model.model[ROW]

        def keep_row(_module, _inputs, output):  # the first call: the step's forward
            if self.first_row is None:
                self.first_row = output[:ROW_IMAGES].detach().float()

        row.register_forward_hook(keep_row)

    def step(self, batch: dict) -> torch.Tensor:
        """One step on a host batch of the loader's layout; returns the
        components [box, cls, dfl]."""
        model = self.model
        dev = next(model.parameters()).device
        model.train()
        img = torch.from_numpy(batch["img"]).to(dev).permute(0, 3, 1, 2).float() / 255.0
        img = img.contiguous(memory_format=torch.channels_last)
        cls, boxes, mask = targets(batch, dev)
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.update_stats = True
        maps = model(img)
        if self.steps == 0:
            self.first_maps = [m.detach().float() for m in maps]
        comps, total = detection_loss(maps, cls, boxes, mask, self.nc)
        for m in model.modules():  # the checkpoints' recomputation moves no statistics
            if isinstance(m, BatchNorm2d):
                m.update_stats = False
        for p in model.parameters():
            p.grad = None
        total.backward()
        self._sgd()
        self._ema()
        return comps.detach()

    @torch.no_grad()
    def _sgd(self):
        named = [(n, p) for n, p in self.model.named_parameters() if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(p.grad)
                                                     for _, p in named]))
        scale = torch.where(norm < 10.0, 1.0, 10.0 / norm)
        k, mom = self.steps, self.sched.momentum(self.steps)
        for n, p in named:
            g = p.grad * scale
            if self.steps == 0:
                self.first_grad[n] = g.clone()
            group = self.groups[n]
            d = g + self.wd * p if group == "decay" else g
            buf = self.buf.get(n)
            buf = d.clone() if buf is None else buf.mul_(mom).add_(d)
            self.buf[n] = buf
            p.sub_(self.sched.lr(group, k) * (d + mom * buf))
        self.steps += 1

    @torch.no_grad()
    def _ema(self):
        d = 0.9999 * (1.0 - math.exp(-self.steps / 2000.0))
        d = float(torch.tensor(d, dtype=torch.float32))
        for k, v in self.model.state_dict().items():
            if k in self.ema:
                self.ema[k].mul_(d).add_(v.detach().float() * (1.0 - d))
