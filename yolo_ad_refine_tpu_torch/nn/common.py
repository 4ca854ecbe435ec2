"""Core convolution / normalization modules (NCHW, channels_last).

Counterpart of ``yolo_ad_refine_tpu/nn/common.py`` (reference
ultralytics/nn/modules/conv.py Conv/Concat, head.py:607 Conv_GN,
block.py:63 DFL). BatchNorm uses the reference's eps=1e-3 /
momentum=0.03 (its ``initialize_weights`` overrides every BatchNorm2d) and
updates its running variance with the biased batch variance, as the JAX
package's flax BatchNorm does; GroupNorm uses eps=1e-5.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from yolo_ad_refine_tpu_torch.nn.registry import register


def autopad(k: int, p: int | None = None, d: int = 1) -> int:
    """'same'-shape padding for odd kernels (reference conv.py:20)."""
    if d > 1:
        k = d * (k - 1) + 1
    if p is None:
        p = k // 2
    return p


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round channels up to the nearest multiple (reference utils/ops.py)."""
    return math.ceil(x / divisor) * divisor


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode update of ``running_var`` uses
    the biased (two-pass, fp32) batch variance, as flax's BatchNorm with
    ``use_fast_variance=False`` does (``yolo_ad_refine_tpu/nn/common.py``);
    torch's own update uses the unbiased one. Normalisation, eval and the
    parameter and buffer names are torch's."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean * m)
            self.running_var.mul_(1.0 - m).add_(var * m)
            self.num_batches_tracked.add_(1)
        return y


def batch_norm(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-3, momentum=0.03)


def _act(act) -> nn.Module:
    if act is True:
        return nn.SiLU()
    if act in (False, None):
        return nn.Identity()
    return act


@register
class Conv(nn.Module):
    """Conv2d(bias=False) + BatchNorm + SiLU (reference conv.py:27-56)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, d: int = 1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), groups=g, dilation=d, bias=False)
        self.bn = batch_norm(c2)
        self.act = _act(act)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class ConvGN(nn.Module):
    """Conv2d(bias=False) + GroupNorm(16) + SiLU (reference head.py:607-624)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, d: int = 1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), groups=g, dilation=d, bias=False)
        self.gn = nn.GroupNorm(16, c2, eps=1e-5)
        self.act = _act(act)

    def forward(self, x):
        return self.act(self.gn(self.conv(x)))


def plain_conv2d(c1: int, c2: int, k: int = 1, s: int = 1) -> nn.Conv2d:
    """Bare torch nn.Conv2d yaml row (bias=True, p=0)."""
    return nn.Conv2d(c1, c2, k, s, 0, bias=True)


def plain_conv_transpose2d(c1: int, c2: int, k: int = 3, s: int = 2, p: int = 1,
                           op: int = 1) -> nn.ConvTranspose2d:
    """Bare torch nn.ConvTranspose2d yaml row; output size (H-1)*s - 2p + k + op."""
    return nn.ConvTranspose2d(c1, c2, k, s, p, output_padding=op, bias=True)


@register
class Concat(nn.Module):
    """Concatenate a list of tensors along channels."""

    def __init__(self, dim: int = 1):
        super().__init__()
        self.d = dim

    def forward(self, xs):
        return torch.cat(xs, dim=self.d)


def max_pool_same(x, k: int, s: int = 1):
    """MaxPool2d(k, stride, padding=k//2) with -inf padding."""
    return F.max_pool2d(x, k, s, k // 2)


def dfl_decode(x, reg_max: int = 16):
    """Distribution Focal Loss decode: (..., 4*reg_max) logits -> (..., 4)
    expected distances (softmax expectation over the reg_max bins)."""
    shape = x.shape[:-1]
    x = x.reshape(*shape, 4, reg_max)
    x = torch.softmax(x.float(), dim=-1)
    proj = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return torch.einsum("...r,r->...", x, proj)
