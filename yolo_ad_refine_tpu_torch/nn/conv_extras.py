"""YOLOv10 backbone blocks, the conv extras and YOLOv9's GELAN blocks.

Counterpart of ``yolo_ad_refine_tpu/nn/conv_extras.py``
(reference ultralytics/nn/modules/block.py: SCDown:1084, RepVGGDW:753,
CIB:815, C2fCIB:854, PSA:967). NCHW modules; submodule names follow the JAX
package's flax names (``cv1_0`` .. ``cv1_4`` as the Sequential ``cv1``,
``ffn_0`` / ``ffn_1`` as ``ffn``), so ``utils/jax_weights.py`` maps them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from yolo_ad_refine_tpu_torch.nn.block import C2f, Attention
from yolo_ad_refine_tpu_torch.nn.common import (
    Conv, DWConv, autopad, batch_norm, max_pool_same)
from yolo_ad_refine_tpu_torch.nn.registry import register


@register
class Conv2(nn.Module):
    """k x k conv and a parallel 1x1 conv, summed, one shared BatchNorm
    (reference conv.py:57): both branches bare convs without bias."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1, d: int = 1,
                 act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, None, d), groups=g, dilation=d,
                              bias=False)
        self.cv2 = nn.Conv2d(c1, c2, 1, s, 0, groups=g, bias=False)
        self.bn = batch_norm(c2)
        self.act = act is True

    def forward(self, x):
        y = self.bn(self.conv(x) + self.cv2(x))
        return F.silu(y) if self.act else y


@register
class LightConv(nn.Module):
    """1x1 Conv without activation, then a depth-wise ReLU DWConv (reference
    conv.py:83; the yaml row's class, its second conv under ``dw``)."""

    def __init__(self, c1: int, c2: int, k: int = 1):
        super().__init__()
        self.conv1 = Conv(c1, c2, 1, act=False)
        self.conv2 = DWConv(c2, c2, k, act=nn.ReLU())

    def forward(self, x):
        return self.conv2(self.conv1(x))


@register
class Focus(nn.Module):
    """Space-to-depth 2x2, then a Conv (reference conv.py:200); the four
    phases in the torch order (h even w even, h odd w even, h even w odd,
    h odd w odd)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, act=True):
        super().__init__()
        self.conv = Conv(c1 * 4, c2, k, s, p, g, act=act)

    def forward(self, x):
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2],
                                    x[..., 1::2, 1::2]], 1))


@register
class GhostConv(nn.Module):
    """A Conv to half the channels and a cheap 5x5 depth-wise Conv of it,
    concatenated (reference conv.py:224)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1, act=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, g=g, act=act)
        self.cv2 = Conv(c_, c_, 5, 1, g=c_, act=act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


@register
class RepConv(nn.Module):
    """RepVGG block in its train form (reference conv.py:244): a 3x3 and a
    1x1 Conv without activation, summed, plus a BatchNorm of the input with
    ``use_bn_identity`` where the shape allows, then SiLU if ``act`` is True
    (any other ``act`` leaves the sum bare, as the JAX module does)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1, act=True,
                 use_bn_identity: bool = False):
        super().__init__()
        if k != 3:
            raise ValueError(f"RepConv takes k=3, not {k}")
        self.conv1 = Conv(c1, c2, 3, s, g=g, act=False)
        self.conv2 = Conv(c1, c2, 1, s, p=0, g=g, act=False)
        self.bn = batch_norm(c1) if use_bn_identity and c1 == c2 and s == 1 else None
        self.act = act is True

    def forward(self, x):
        y = self.conv1(x) + self.conv2(x)
        if self.bn is not None:
            y = y + self.bn(x)
        return F.silu(y) if self.act else y


@register
class ChannelAttention(nn.Module):
    """Global average pool, 1x1 conv with bias, sigmoid gate (reference conv.py:280)."""

    def __init__(self, c1: int):
        super().__init__()
        self.fc = nn.Conv2d(c1, c1, 1, bias=True)

    def forward(self, x):
        return x * torch.sigmoid(self.fc(x.mean((2, 3), keepdim=True)))


@register
class SpatialAttention(nn.Module):
    """The channel mean and max, a k x k conv, sigmoid gate (reference conv.py:293)."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        if kernel_size not in (3, 7):
            raise ValueError(f"SpatialAttention takes kernel_size 3 or 7, not {kernel_size}")
        self.cv1 = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, x):
        s = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return x * torch.sigmoid(self.cv1(s))


@register
class CBAM(nn.Module):
    """Channel, then spatial attention (reference conv.py:309)."""

    def __init__(self, c1: int, kernel_size: int = 7):
        super().__init__()
        self.channel_attention = ChannelAttention(c1)
        self.spatial_attention = SpatialAttention(kernel_size)

    def forward(self, x):
        return self.spatial_attention(self.channel_attention(x))


@register
class SCDown(nn.Module):
    """1x1 channel mix, then a depthwise strided downsample (reference block.py:1084)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, k, s, g=c2, act=False)

    def forward(self, x):
        return self.cv2(self.cv1(x))


@register
class RepVGGDW(nn.Module):
    """Depthwise 7x7 and 3x3 branches summed, then SiLU (reference block.py:753)."""

    def __init__(self, ed: int):
        super().__init__()
        self.conv = Conv(ed, ed, 7, 1, p=3, g=ed, act=False)
        self.conv1 = Conv(ed, ed, 3, 1, p=1, g=ed, act=False)

    def forward(self, x):
        return F.silu(self.conv(x) + self.conv1(x))


@register
class CIB(nn.Module):
    """Conditional identity block (reference block.py:815): depthwise 3x3,
    1x1, depthwise 3x3 (or RepVGGDW with ``lk``), 1x1, depthwise 3x3."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5,
                 lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = nn.Sequential(
            Conv(c1, c1, 3, g=c1), Conv(c1, 2 * c_, 1),
            RepVGGDW(2 * c_) if lk else Conv(2 * c_, 2 * c_, 3, g=2 * c_),
            Conv(2 * c_, c2, 1), Conv(c2, c2, 3, g=c2))
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv1(x)
        return x + y if self.add else y


@register
class C2fCIB(C2f):
    """C2f whose inner blocks are CIBs (reference block.py:854)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, lk: bool = False,
                 g: int = 1, e: float = 0.5):
        self.lk = lk
        super().__init__(c1, c2, n, shortcut, g, e)

    def inner_block(self, c: int) -> nn.Module:
        return CIB(c, c, self.shortcut, e=1.0, lk=self.lk)


@register
class PSA(nn.Module):
    """Position-sensitive attention (reference block.py:967): split, the
    attention residual and the conv-FFN residual on one half, merge."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        super().__init__()
        if c1 != c2:
            raise ValueError(f"PSA keeps its channels: c1={c1} != c2={c2}")
        self.c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c1, 1)
        self.attn = Attention(self.c, num_heads=max(1, self.c // 64), attn_ratio=0.5)
        self.ffn = nn.Sequential(Conv(self.c, self.c * 2, 1),
                                 Conv(self.c * 2, self.c, 1, act=False))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        b = b + self.attn(b)
        b = b + self.ffn(b)
        return self.cv2(torch.cat([a, b], 1))


# YOLOv9 GELAN blocks (reference block.py:569-679)


def avg_pool_2x2_s1(x):
    """torch avg_pool2d(x, 2, 1, 0): window 2, stride 1, no padding, mean;
    an H x W map becomes (H - 1) x (W - 1)."""
    return F.avg_pool2d(x, 2, 1, 0)


class RepBottleneck(nn.Module):
    """Bottleneck whose first conv is a RepConv (reference block.py:569)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = RepConv(c1, c_, 3, 1)
        self.cv2 = Conv(c_, c2, 3, 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class RepCSP(nn.Module):
    """C3 with RepBottleneck inner blocks (reference block.py:579)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(RepBottleneck(c_, c_, shortcut, e=1.0) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


@register
class RepNCSPELAN4(nn.Module):
    """GELAN block (reference block.py:589): ``cv1`` split in two halves,
    then two chained RepCSP + Conv branches, all four concatenated."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int, n: int = 1):
        super().__init__()
        self.c = c3 // 2
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv2 = nn.Sequential(RepCSP(c3 - self.c, c4, n), Conv(c4, c4, 3, 1))
        self.cv3 = nn.Sequential(RepCSP(c4, c4, n), Conv(c4, c4, 3, 1))
        self.cv4 = Conv(c3 + 2 * c4, c2, 1, 1)

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, :self.c], y[:, self.c:]]
        ys.append(self.cv2(ys[-1]))
        ys.append(self.cv3(ys[-1]))
        return self.cv4(torch.cat(ys, 1))


@register
class ELAN1(nn.Module):
    """ELAN with plain 3x3 Convs for branches (reference block.py:614, v9t / s)."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int):
        super().__init__()
        self.c = c3 // 2
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv2 = Conv(c3 - self.c, c4, 3, 1)
        self.cv3 = Conv(c4, c4, 3, 1)
        self.cv4 = Conv(c3 + 2 * c4, c2, 1, 1)

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, :self.c], y[:, self.c:]]
        ys.append(self.cv2(ys[-1]))
        ys.append(self.cv3(ys[-1]))
        return self.cv4(torch.cat(ys, 1))


@register
class AConv(nn.Module):
    """2x2 stride-1 average pool, then a 3x3 stride-2 Conv (reference block.py:627)."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.cv1 = Conv(c1, c2, 3, 2, 1)

    def forward(self, x):
        return self.cv1(avg_pool_2x2_s1(x))


@register
class ADown(nn.Module):
    """Downsample in two halves (reference block.py:641): after a 2x2
    stride-1 average pool, a 3x3 stride-2 Conv of the first c1 // 2
    channels beside a 3x3 stride-2 max pool (-inf padding) and a 1x1 Conv
    of the rest."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        c = c2 // 2
        self.half = c1 // 2
        self.cv1 = Conv(self.half, c, 3, 2, 1)
        self.cv2 = Conv(c1 - self.half, c, 1, 1, 0)

    def forward(self, x):
        x = avg_pool_2x2_s1(x)
        x1 = self.cv1(x[:, :self.half])
        x2 = self.cv2(max_pool_same(x[:, self.half:], 3, 2))
        return torch.cat([x1, x2], 1)


@register
class SPPELAN(nn.Module):
    """SPP-ELAN (reference block.py:661): a 1x1 Conv, three chained k x k
    stride-1 max pools, the four concatenated and mixed by a 1x1 Conv."""

    def __init__(self, c1: int, c2: int, c3: int, k: int = 5):
        super().__init__()
        self.k = k
        self.cv1 = Conv(c1, c3, 1, 1)
        self.cv5 = Conv(4 * c3, c2, 1, 1)

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(max_pool_same(ys[-1], self.k, 1))
        return self.cv5(torch.cat(ys, 1))
