"""YOLOv10 backbone blocks.

Counterpart of the v10 part of ``yolo_ad_refine_tpu/nn/conv_extras.py``
(reference ultralytics/nn/modules/block.py: SCDown:1084, RepVGGDW:753,
CIB:815, C2fCIB:854, PSA:967). NCHW modules; submodule names follow the JAX
package's flax names (``cv1_0`` .. ``cv1_4`` as the Sequential ``cv1``,
``ffn_0`` / ``ffn_1`` as ``ffn``), so ``utils/jax_weights.py`` maps them.
The other blocks of that file are not ported yet (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from yolo_ad_refine_tpu_torch.nn.block import C2f, Attention
from yolo_ad_refine_tpu_torch.nn.common import Conv
from yolo_ad_refine_tpu_torch.nn.registry import register


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
