"""Backbone / neck building blocks (stock YOLO11 + the fork's MLCA / HS-FPN set).

Counterpart of ``yolo_ad_refine_tpu/nn/block.py`` (reference
ultralytics/nn/modules/block.py: Bottleneck:341, C2f:232, C3:256, C3k:742,
C3k2:731, SPPF:177, Attention/PSABlock/C2PSA:874-1049, ELA_HSFPN:1408,
Multiply:1442, Add:1448, Fusion:1500, MLCA:1540, Bottleneck_MLCA:1586,
C3k_MLCA/C3k2_MLCA:1596-1605). NCHW modules; submodule names follow the
reference so a state_dict carries over.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from yolo_ad_refine_tpu_torch.nn.common import Conv, max_pool_same
from yolo_ad_refine_tpu_torch.nn.registry import register


class Bottleneck(nn.Module):
    """Standard residual bottleneck (reference block.py:341)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k=(3, 3),
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        k0, k1 = (kk if isinstance(kk, int) else kk[0] for kk in k)
        self.cv1 = Conv(c1, c_, k0, 1)
        self.cv2 = Conv(c_, c2, k1, 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


@register
class C2f(nn.Module):
    """CSP bottleneck with 2 convolutions and n inner blocks (reference block.py:232)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.shortcut, self.g = shortcut, g
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(self.inner_block(self.c) for _ in range(n))

    def inner_block(self, c: int) -> nn.Module:
        return Bottleneck(c, c, self.shortcut, self.g, k=(3, 3), e=1.0)

    def forward(self, x):
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


@register
class C3(nn.Module):
    """CSP bottleneck with 3 convolutions (reference block.py:256)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k=((1, 1), (3, 3))):
        super().__init__()
        c_ = int(c2 * e)
        self.shortcut, self.g, self.k = shortcut, g, k
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(self.inner_block(c_) for _ in range(n)))

    def inner_block(self, c: int) -> nn.Module:
        return Bottleneck(c, c, self.shortcut, self.g, k=self.k, e=1.0)

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3k(C3):
    """C3 with a configurable inner kernel (reference block.py:742)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k: int = 3):
        super().__init__(c1, c2, n, shortcut, g, e, k=(k, k))


@register
class C3k2(C2f):
    """C2f whose inner blocks are C3k(n=2) when c3k=True (reference block.py:731)."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True):
        self.c3k = c3k
        super().__init__(c1, c2, n, shortcut, g, e)

    def inner_block(self, c: int) -> nn.Module:
        if self.c3k:
            return C3k(c, c, 2, self.shortcut, self.g)
        return Bottleneck(c, c, self.shortcut, self.g, k=(3, 3), e=0.5)


@register
class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: 3 chained maxpool(k) (reference block.py:177)."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(max_pool_same(ys[-1], self.k, 1))
        return self.cv2(torch.cat(ys, 1))


class Attention(nn.Module):
    """YOLO11 area attention (reference block.py:874)."""

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        nh_kd = self.key_dim * num_heads
        self.qkv = Conv(dim, dim + nh_kd * 2, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        n = h * w
        qkv = self.qkv(x).reshape(b, self.num_heads, self.key_dim * 2 + self.head_dim, n)
        q, k, v = qkv.split([self.key_dim, self.key_dim, self.head_dim], dim=2)
        attn = torch.softmax((q.transpose(-2, -1) @ k) * self.scale, dim=-1)
        out = (v @ attn.transpose(-2, -1)).reshape(b, c, h, w)
        out = out + self.pe(v.reshape(b, c, h, w))
        return self.proj(out)


class PSABlock(nn.Module):
    """Attention + conv-FFN block with residuals (reference block.py:963)."""

    def __init__(self, c: int, attn_ratio: float = 0.5, num_heads: int = 4,
                 shortcut: bool = True):
        super().__init__()
        self.attn = Attention(c, num_heads, attn_ratio)
        self.ffn = nn.Sequential(Conv(c, c * 2, 1), Conv(c * 2, c, 1, act=False))
        self.add = shortcut

    def forward(self, x):
        a = self.attn(x)
        x = x + a if self.add else a
        f = self.ffn(x)
        return x + f if self.add else f


@register
class C2PSA(nn.Module):
    """Split + n PSABlocks + merge (reference block.py:1010)."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c2, 1)
        self.m = nn.Sequential(*(self.inner_block(self.c) for _ in range(n)))

    def inner_block(self, c: int) -> nn.Module:
        return PSABlock(c, 0.5, max(1, c // 64))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        return self.cv2(torch.cat([a, self.m(b)], 1))


class MLCA(nn.Module):
    """Mixed Local Channel Attention (reference block.py:1540-1584).

    Local 5x5 and global adaptive pools, each through an ECA-style
    Conv1d(1, 1, k) over the channel sequence, sigmoids mixed 50/50 and
    un-pooled to (H, W) by adaptive averaging, multiplied into x.
    """

    def __init__(self, in_size: int, local_size: int = 5, gamma: int = 2, b: int = 1,
                 local_weight: float = 0.5):
        super().__init__()
        self.local_size = local_size
        self.local_weight = local_weight
        t = int(abs(math.log2(in_size) + b) / gamma)
        k = t if t % 2 else t + 1
        self.conv = nn.Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False)
        self.conv_local = nn.Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False)

    def forward(self, x):
        bsz, c, h, w = x.shape
        ls = self.local_size
        local = F.adaptive_avg_pool2d(x, ls)                      # (b, c, ls, ls)
        glob = local.mean(dim=(2, 3))                              # (b, c)
        # channel-fastest sequences, as the reference's view/transpose
        seq_local = local.reshape(bsz, c, ls * ls).transpose(1, 2).reshape(bsz, 1, -1)
        y_local = self.conv_local(seq_local).reshape(bsz, ls * ls, c).transpose(1, 2)
        y_global = self.conv(glob.reshape(bsz, 1, c)).reshape(bsz, c)
        att_local = torch.sigmoid(y_local).reshape(bsz, c, ls, ls)
        # The reference un-pools the global branch through (c, b, 1), which
        # adaptive_avg_pool2d reads as (C=c, H=b, W=1): spatial row i of the
        # attention is the mean over BATCH segment i (a batch-mixing quirk of
        # the upstream code, reproduced; for b=1 it is a broadcast).
        att_global = F.adaptive_avg_pool2d(torch.sigmoid(y_global).t().unsqueeze(-1), ls)[None]
        att = att_global * (1 - self.local_weight) + att_local * self.local_weight
        return x * F.adaptive_avg_pool2d(att, (h, w))


class BottleneckMLCA(nn.Module):
    """Bottleneck with MLCA after cv2 (reference block.py:1586)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k=(3, 3),
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.attention = MLCA(c2)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.attention(self.cv2(self.cv1(x)))
        return x + y if self.add else y


class C3kMLCA(C3k):
    """C3k with MLCA bottlenecks at e=1.0 (reference block.py:1596)."""

    def inner_block(self, c: int) -> nn.Module:
        return BottleneckMLCA(c, c, self.shortcut, self.g, k=self.k, e=1.0)


@register(name="C3k2_MLCA")
class C3k2MLCA(C3k2):
    """C3k2 with MLCA bottlenecks (reference block.py:1601)."""

    def inner_block(self, c: int) -> nn.Module:
        if self.c3k:
            return C3kMLCA(c, c, 2, self.shortcut, self.g)
        return BottleneckMLCA(c, c, self.shortcut, self.g, k=(3, 3), e=0.5)


@register(name="ELA_HSFPN")
class ELAHSFPN(nn.Module):
    """Efficient Local Attention for HS-FPN (reference block.py:1408-1424).

    Per-axis average pools through a shared Conv1d(k=7) + GroupNorm(16) +
    sigmoid; returns x*a_h*a_w (flag=True) or the map a_h*a_w (flag=False).
    """

    def __init__(self, c: int, flag: bool = True):
        super().__init__()
        self.flag = flag
        self.conv1x1 = nn.Sequential(nn.Conv1d(c, c, 7, padding=3, bias=True),
                                     nn.GroupNorm(16, c, eps=1e-5))

    def forward(self, x):
        a_h = torch.sigmoid(self.conv1x1(x.mean(dim=3)))[..., None]     # (b, c, h, 1)
        a_w = torch.sigmoid(self.conv1x1(x.mean(dim=2)))[..., None, :]  # (b, c, 1, w)
        return x * a_h * a_w if self.flag else a_h * a_w


@register
class Multiply(nn.Module):
    """Elementwise product of a 2-input list (reference block.py:1442)."""

    def forward(self, xs):
        return xs[0] * xs[1]


@register
class Add(nn.Module):
    """Elementwise sum of an input list (reference block.py:1448)."""

    def forward(self, xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out


@register
class Fusion(nn.Module):
    """Multi-input fusion node (reference block.py:1500-1537), mode 'bifpn':
    learnable ReLU-normalised weights. The other modes are not ported yet."""

    def __init__(self, inc_list, fusion: str = "bifpn"):
        super().__init__()
        if fusion != "bifpn":
            raise NotImplementedError(
                f"Fusion mode {fusion!r} is not ported yet (ROADMAP Queue 1 item 13, the rest "
                "of the module library); the port has 'bifpn'")
        self.fusion = fusion
        self.fusion_weight = nn.Parameter(torch.ones(len(inc_list), dtype=torch.float32))

    def forward(self, xs):
        w = torch.relu(self.fusion_weight)
        w = (w / (w.sum() + 1e-4)).to(xs[0].dtype)
        return sum(w[i] * xs[i] for i in range(len(xs)))
