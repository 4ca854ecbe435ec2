"""Dynamic Snake Attention Network (DSAN) modules, NCHW.

Counterpart of ``yolo_ad_refine_tpu/nn/dsan.py`` (reference
ultralytics/nn/modules/dsan.py: Mlp:12, DSCNPair:48, DSA:80, DSAN:98;
ops_dscn/modules/dscn.py: DSCNX:89, DSCNY:194). The snake sampling is
``ops/dscn.py``. Dead in the reference's active path (only tasks1.py
routes to it) but part of its surface: DSAN and DSA are yaml rows.
"""

from __future__ import annotations

import torch
from torch import nn

from yolo_ad_refine_tpu_torch.nn.common import LayerNorm2d, batch_norm
from yolo_ad_refine_tpu_torch.nn.registry import register
from yolo_ad_refine_tpu_torch.nn.tssa import gelu_exact
from yolo_ad_refine_tpu_torch.ops.dscn import dscn_sample


class DSCN1D(nn.Module):
    """One snake-conv branch (reference DSCNX:89 / DSCNY:194): offsets from
    a depthwise (1, k) or (k, 1) conv of ``off_x``, channel LayerNorm, GELU
    and a Linear (zero at construction, so the snake starts straight);
    the sampling by ``dscn_sample``. DSCNX projects its input first, DSCNY
    does not."""

    def __init__(self, channels: int, kernel_size: int = 3, dw_kernel_size: int | None = None,
                 stride: int = 1, pad: int = 1, dilation: int = 1, group: int = 4,
                 offset_scale: float = 1.0, axis: str = "x", with_proj: bool = True):
        super().__init__()
        c = channels
        self.k, self.stride, self.pad, self.dilation = kernel_size, stride, pad, dilation
        self.group, self.offset_scale, self.axis = group, offset_scale, axis
        dwk = dw_kernel_size or kernel_size
        kern, padding = ((1, dwk), (0, (dwk - 1) // 2)) if axis == "x" else \
            ((dwk, 1), ((dwk - 1) // 2, 0))
        self.input_proj = nn.Linear(c, c) if with_proj else None
        self.dw_conv = nn.Sequential(nn.Conv2d(c, c, kern, padding=padding, groups=c),
                                     LayerNorm2d(c, eps=1e-6))
        self.offset = nn.Linear(c, group * kernel_size)
        nn.init.zeros_(self.offset.weight)
        nn.init.zeros_(self.offset.bias)

    def forward(self, x, off_x):
        y = x.permute(0, 2, 3, 1)
        if self.input_proj is not None:
            y = self.input_proj(y)
        offset = self.offset(gelu_exact(self.dw_conv(off_x)).permute(0, 2, 3, 1))
        out = dscn_sample(y, offset, self.k, self.axis, self.stride, self.pad, self.dilation,
                          self.group, self.offset_scale)
        return out.permute(0, 3, 1, 2)


class DSCNPair(nn.Module):
    """Depthwise 5x5 -> snake-x -> snake-y -> 1x1, gating the input
    (reference dsan.py:48-71)."""

    def __init__(self, c: int, kernel_size: int = 7, dw_kernel_size: int = 5, pad: int = 3,
                 stride: int = 1, dilation: int = 1, group: int = 1):
        super().__init__()
        self.conv0 = nn.Conv2d(c, c, 5, padding=2, groups=c)
        self.dscn_x = DSCN1D(c, kernel_size, dw_kernel_size, stride, pad, dilation, group,
                             axis="x", with_proj=True)
        self.dscn_y = DSCN1D(c, kernel_size, dw_kernel_size, stride, pad, dilation, group,
                             axis="y", with_proj=False)
        self.conv = nn.Conv2d(c, c, 1)

    def forward(self, x):
        a = self.conv0(x)
        return x * self.conv(self.dscn_y(self.dscn_x(a, a), a))


@register
class DSA(nn.Module):
    """1x1 -> GELU -> DSCNPair gate -> 1x1, plus the input (reference
    dsan.py:80-96)."""

    def __init__(self, c: int, kernel_size: int = 7, dw_kernel_size: int = 5, stride: int = 1,
                 dilation: int = 1, group: int = 1):
        super().__init__()
        pad = (dilation * (kernel_size - 1)) // 2
        self.proj_1 = nn.Conv2d(c, c, 1)
        self.spatial_gating_unit = DSCNPair(c, kernel_size, dw_kernel_size, pad, stride,
                                            dilation, group)
        self.proj_2 = nn.Conv2d(c, c, 1)

    def forward(self, x):
        return self.proj_2(self.spatial_gating_unit(gelu_exact(self.proj_1(x)))) + x


class Mlp(nn.Module):
    """1x1 -> depthwise 3x3 -> GELU -> 1x1 (reference dsan.py:12-46)."""

    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Conv2d(c, hidden, 1)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Conv2d(hidden, c, 1)

    def forward(self, x):
        return self.fc2(gelu_exact(self.dwconv(self.fc1(x))))


@register
class DSAN(nn.Module):
    """BN -> DSA (x layer_scale_1) + x, then BN -> Mlp (x layer_scale_2) + x
    (reference dsan.py:98-137)."""

    def __init__(self, c: int, kernel_size: int = 7, dw_kernel_size: int = 5, stride: int = 1,
                 dilation: int = 1, group: int = 1, mlp_ratio: float = 4.0):
        super().__init__()
        self.layer_scale_1 = nn.Parameter(torch.full((c,), 1e-2))
        self.layer_scale_2 = nn.Parameter(torch.full((c,), 1e-2))
        self.norm1 = batch_norm(c)
        self.attn = DSA(c, kernel_size, dw_kernel_size, stride, dilation, group)
        self.norm2 = batch_norm(c)
        self.mlp = Mlp(c, int(c * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x)) * self.layer_scale_1.view(1, -1, 1, 1).to(x.dtype)
        return x + self.mlp(self.norm2(x)) * self.layer_scale_2.view(1, -1, 1, 1).to(x.dtype)
