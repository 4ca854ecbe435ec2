"""Channel-preserving attention gates, NCHW.

Counterpart of ``yolo_ad_refine_tpu/nn/attention.py`` (reference
nn/modules/attention.py: EMA:24, SimAM:53, TripletAttention:661,
LSKBlock:878, SEAttention:896, EfficientChannelAttention:1880). Each takes
the channels of its input row and returns a map of the input's shape; the
submodule names are the JAX package's, so its variables carry over.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from yolo_ad_refine_tpu_torch.nn.common import batch_norm
from yolo_ad_refine_tpu_torch.nn.registry import register


@register
class EMA(nn.Module):
    """Efficient Multi-scale Attention (reference attention.py:24): the
    batch regrouped into ``b * factor`` maps of ``c // factor`` channels, H
    and W strip pools through a shared 1x1, a GroupNorm path and a 3x3 path
    weighting each other by their softmaxed channel means."""

    def __init__(self, c: int, factor: int = 8):
        super().__init__()
        self.factor = factor
        cg = c // factor
        if cg <= 0:
            raise ValueError(f"EMA groups {c} channels by {factor}: none is left a group")
        self.conv1x1 = nn.Conv1d(cg, cg, 1)
        self.gn = nn.GroupNorm(cg, cg, eps=1e-6)  # flax's default epsilon
        self.conv3x3 = nn.Conv2d(cg, cg, 3, padding=1)

    def forward(self, x):
        b, c, h, w = x.shape
        g = self.factor
        cg = c // g
        gx = x.reshape(b * g, cg, h, w)
        hw = self.conv1x1(torch.cat([gx.mean(dim=3), gx.mean(dim=2)], 2))  # (bg, cg, h+w)
        a_h = torch.sigmoid(hw[:, :, :h])[..., None]
        a_w = torch.sigmoid(hw[:, :, h:])[:, :, None, :]
        x1 = self.gn(gx * a_h * a_w)
        x2 = self.conv3x3(gx)
        x11 = torch.softmax(x1.mean(dim=(2, 3)), dim=-1)
        x21 = torch.softmax(x2.mean(dim=(2, 3)), dim=-1)
        weights = (torch.einsum("bc,bcn->bn", x11, x2.reshape(b * g, cg, h * w))
                   + torch.einsum("bc,bcn->bn", x21, x1.reshape(b * g, cg, h * w)))
        return (gx * torch.sigmoid(weights.reshape(b * g, 1, h, w))).reshape(b, c, h, w)


@register
class SimAM(nn.Module):
    """Parameter-free energy attention (reference attention.py:53)."""

    def __init__(self, c: int | None = None, e_lambda: float = 1e-4):
        super().__init__()
        self.e_lambda = e_lambda

    def forward(self, x):
        n = x.shape[2] * x.shape[3] - 1
        d = (x - x.mean(dim=(2, 3), keepdim=True)) ** 2
        y = d / (4 * (d.sum(dim=(2, 3), keepdim=True) / n + self.e_lambda)) + 0.5
        return x * torch.sigmoid(y)


class _AttentionGate(nn.Module):
    """Max and mean over dim 1 -> 7x7 conv + BN -> sigmoid gate."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, 7, padding=3, bias=False)
        self.bn = batch_norm(1)

    def forward(self, x):
        z = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], 1)
        return x * torch.sigmoid(self.bn(self.conv(z)))


@register
class TripletAttention(nn.Module):
    """Rotate-and-gate over the three axis pairings (reference :661): ``cw``
    gates along H over (C, W), ``hc`` along W over (H, C), ``hw`` along C."""

    def __init__(self, c: int | None = None, no_spatial: bool = False):
        super().__init__()
        self.no_spatial = no_spatial
        self.cw = _AttentionGate()
        self.hc = _AttentionGate()
        if not no_spatial:
            self.hw = _AttentionGate()

    def forward(self, x):
        o1 = self.cw(x.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
        o2 = self.hc(x.permute(0, 3, 2, 1)).permute(0, 3, 2, 1)
        if self.no_spatial:
            return 0.5 * (o1 + o2)
        return (o1 + o2 + self.hw(x)) / 3.0


@register
class LSKBlock(nn.Module):
    """Large-selective-kernel block (reference :852-894): two depthwise
    receptive fields, an avg / max squeeze selecting between them, the
    residual."""

    def __init__(self, c: int):
        super().__init__()
        self.proj_1 = nn.Conv2d(c, c, 1)
        self.conv0 = nn.Conv2d(c, c, 5, padding=2, groups=c)
        self.conv_spatial = nn.Conv2d(c, c, 7, padding=9, groups=c, dilation=3)
        self.conv1 = nn.Conv2d(c, c // 2, 1)
        self.conv2 = nn.Conv2d(c, c // 2, 1)
        self.conv_squeeze = nn.Conv2d(2, 2, 7, padding=3)
        self.conv = nn.Conv2d(c // 2, c, 1)
        self.proj_2 = nn.Conv2d(c, c, 1)

    def forward(self, x):
        y = F.gelu(self.proj_1(x))
        a1 = self.conv0(y)
        a2 = self.conv_spatial(a1)
        a1, a2 = self.conv1(a1), self.conv2(a2)
        attn = torch.cat([a1, a2], 1)
        agg = torch.cat([attn.mean(dim=1, keepdim=True), attn.amax(dim=1, keepdim=True)], 1)
        sig = torch.sigmoid(self.conv_squeeze(agg))
        attn = self.conv(a1 * sig[:, :1] + a2 * sig[:, 1:])
        return self.proj_2(y * attn) + x


@register
class SEAttention(nn.Module):
    """Squeeze-and-excitation (reference :896)."""

    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(c, max(1, c // reduction), bias=False)
        self.fc2 = nn.Linear(max(1, c // reduction), c, bias=False)

    def forward(self, x):
        y = self.fc2(torch.relu(self.fc1(x.mean(dim=(2, 3)))))
        return x * torch.sigmoid(y)[:, :, None, None]


@register
class EfficientChannelAttention(nn.Module):
    """ECA (reference :1880): global average pool, a Conv1d over the
    channel sequence with an adaptive odd kernel, sigmoid."""

    def __init__(self, c: int):
        super().__init__()
        t = int(abs((math.log2(c) + 1) / 2))
        k = t if t % 2 else t + 1
        self.conv1 = nn.Conv1d(1, 1, k, padding=k // 2, bias=False)

    def forward(self, x):
        y = self.conv1(x.mean(dim=(2, 3))[:, None, :])[:, 0]
        return x * torch.sigmoid(y)[:, :, None, None]
