"""Fixed dropout masks for the port's models, so that two runs of a train
step (the port against the JAX package, or the card against the CPU) drop
the same units. Imports no JAX: ``chip_smoke.py`` uses it on the card.

``FixedDropout`` computes train-mode dropout as flax's ``nn.Dropout`` does,
x / (1 - p) where kept and 0 elsewhere, with a given keep mask instead of
a random draw; in eval it is the identity, as any dropout.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class FixedDropout(nn.Module):
    """Dropout at rate ``p`` that keeps exactly ``keep`` (a bool tensor of
    the input's shape) in train mode."""

    def __init__(self, keep: torch.Tensor, p: float):
        super().__init__()
        self.keep, self.p = keep, p

    def forward(self, x):
        if not self.training:
            return x
        keep = self.keep.to(x.device)
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                   device=x.device))


def dropout_modules(model: nn.Module) -> dict[str, nn.Dropout]:
    """Every ``nn.Dropout`` of ``model`` with a positive rate, by name."""
    return {n: m for n, m in model.named_modules() if isinstance(m, nn.Dropout) and m.p > 0}


def set_masks(model: nn.Module, masks: dict[str, torch.Tensor]) -> None:
    """Replace each named dropout of ``model`` by a FixedDropout with its
    mask (NCHW, bool), at the replaced module's rate."""
    for name, keep in masks.items():
        parent, _, attr = name.rpartition(".")
        owner = model.get_submodule(parent) if parent else model
        old = getattr(owner, attr)
        p = old.p
        setattr(owner, attr, FixedDropout(keep, p).train(old.training))


def dropout_input_shapes(model: nn.Module, x: torch.Tensor) -> dict[str, tuple]:
    """The input shape of each dropout of ``model`` in one forward of ``x``
    (eval mode, under no_grad)."""
    shapes, hooks = {}, []
    for name, m in dropout_modules(model).items():
        hooks.append(m.register_forward_pre_hook(
            lambda mod, args, name=name: shapes.__setitem__(name, tuple(args[0].shape))))
    training = model.training
    try:
        with torch.no_grad():
            model.eval()(x)
    finally:
        model.train(training)
        for h in hooks:
            h.remove()
    return shapes


def seeded_masks(shapes: dict[str, tuple], p: float, seed: int = 0) -> dict[str, torch.Tensor]:
    """Keep masks for the given input shapes, each unit kept with
    probability 1 - p, drawn from ``np.random.default_rng(seed)``."""
    r = np.random.default_rng(seed)
    return {n: torch.from_numpy(r.random(s) >= p) for n, s in sorted(shapes.items())}
