"""The reference computed one precision below the configuration's: the
control that every compared number is set against.

Serving states fp32 (cuDNN's convolutions in TF32): the control is the
reference in bfloat16, weights and activations. Training states bf16
autocast: the control is the reference with every convolution's and
linear layer's weight and input rounded to float8 e4m3 (per-tensor scale
to its largest finite value, 448) on the way in, the products in fp32, and
the gradient passed straight through the rounding.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils import parametrize

from portbench.reference import modules as M

FP8_MAX = 448.0
QUANTISED = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear, M.ModulatedDeformConv)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at a per-tensor scale, with the identity
    as its gradient."""
    scale = t.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


class _Fp8(nn.Module):
    def forward(self, w):
        return fp8(w)


def _inputs_fp8(_module, args):
    return tuple(fp8(a) if torch.is_tensor(a) and a.is_floating_point() else a for a in args)


def to_fp8(model: nn.Module) -> nn.Module:
    """Round each quantised layer's weight and first inputs to fp8 in
    ``model``, in place."""
    for m in model.modules():
        if isinstance(m, QUANTISED):
            parametrize.register_parametrization(m, "weight", _Fp8())
            m.register_forward_pre_hook(_inputs_fp8)
    return model
