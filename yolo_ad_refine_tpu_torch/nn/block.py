"""Backbone / neck building blocks (stock YOLO11 + the fork's MLCA / HS-FPN set).

Counterpart of ``yolo_ad_refine_tpu/nn/block.py`` (reference
ultralytics/nn/modules/block.py: Bottleneck:341, C2f:232, C3:256, C3k:742,
C3k2:731, SPPF:177, Attention/PSABlock/C2PSA:874-1049, ELA_HSFPN:1408,
Multiply:1442, Add:1448, Fusion:1500, MLCA:1540, Bottleneck_MLCA:1586,
C3k_MLCA/C3k2_MLCA:1596-1605, the PPHGNetV2 set HGStem:105, HGBlock:136
and RepC3:283 with conv.py LightConv:83 / RepConv:173, and YOLO-World's MaxSigmoidAttnBlock:418,
C2fAttn:453, ImagePoolingAttn:480). NCHW modules; submodule names follow the
reference so a state_dict carries over.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from yolo_ad_refine_tpu_torch.nn.common import Conv, autocast_off, max_pool_same
from yolo_ad_refine_tpu_torch.nn.registry import register
from yolo_ad_refine_tpu_torch.parallel import all_gather_cat, in_global_batch


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
class SequentialBlocks(nn.Module):
    """A chain of distinct blocks: the parser's form of a repeated non-CSP
    row (reference tasks.py:1095 wraps it in ``nn.Sequential``). Its
    ``blocks.i`` are flax's ``blocks_i``, the names it gives a tuple
    attribute's submodules."""

    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return x


@register
class SPP(nn.Module):
    """Spatial pyramid pooling, parallel max-pools of sizes ``k`` (reference
    block.py:146; the YOLOv3 zoo configs)."""

    def __init__(self, c1: int, c2: int, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * (len(self.k) + 1), c2, 1, 1)

    def forward(self, x):
        y = self.cv1(x)
        return self.cv2(torch.cat([y, *(max_pool_same(y, k, 1) for k in self.k)], 1))


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
        # In data-parallel training the batch is the global one, as under
        # the JAX package's mesh: every rank's rows, gathered.
        sig = torch.sigmoid(y_global)
        if self.training and in_global_batch():
            sig = all_gather_cat(sig)
        att_global = F.adaptive_avg_pool2d(sig.t().unsqueeze(-1), ls)[None]
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
class GSConv(nn.Module):
    """Slim-neck GSConv (reference block.py:1457-1479): half the channels by
    a dense conv, the other half by a 5x5 depthwise conv over them, then a
    pairwise channel shuffle, out[j * c_ + i] = cat[2i + j]."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, d: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, p, g, d)
        self.cv2 = Conv(c_, c_, 5, 1, None, c_, d)

    def forward(self, x):
        x1 = self.cv1(x)
        y = torch.cat([x1, self.cv2(x1)], 1)
        b, n, h, w = y.shape
        return y.reshape(b, n // 2, 2, h, w).transpose(1, 2).reshape(b, n, h, w)


class SDI(nn.Module):
    """Selective Dimension Interaction fusion (reference block.py:1481-1498,
    from U-Net v2): each input resampled to the first input's size (adaptive
    average pooling down, align-corners bilinear up, by width), projected by
    a GSConv to the first input's channels, and the results multiplied."""

    def __init__(self, channels):
        super().__init__()
        self.convs = nn.ModuleList(GSConv(c, channels[0]) for c in channels)

    def forward(self, xs):
        th, tw = xs[0].shape[2:]
        ans = None
        for x, conv in zip(xs, self.convs):
            if x.shape[3] > tw:
                x = F.adaptive_avg_pool2d(x, (th, tw))
            elif x.shape[3] < tw:
                x = F.interpolate(x, size=(th, tw), mode="bilinear", align_corners=True)
            y = conv(x)
            ans = y if ans is None else ans * y
        return ans


FUSION_MODES = ("weight", "adaptive", "concat", "bifpn", "SDI")


@register
class Fusion(nn.Module):
    """Multi-input fusion node (reference block.py:1500-1537). Modes:
    'weight' (1x1 Convs, summed), 'adaptive' (1x1 Convs under a softmax gate),
    'concat', 'bifpn' (learnable ReLU-normalised weights, the flagship's)
    and 'SDI' (GSConv-projected products)."""

    def __init__(self, inc_list, fusion: str = "bifpn"):
        super().__init__()
        if fusion not in FUSION_MODES:
            raise ValueError(f"Fusion mode {fusion!r} is none of {FUSION_MODES}")
        self.fusion = fusion
        if fusion in ("weight", "adaptive"):
            self.fusion_conv = nn.ModuleList(Conv(c, c, 1) for c in inc_list)
        if fusion == "adaptive":
            self.fusion_adaptive = Conv(sum(inc_list), len(inc_list), 1)
        elif fusion == "bifpn":
            self.fusion_weight = nn.Parameter(torch.ones(len(inc_list), dtype=torch.float32))
        elif fusion == "SDI":
            self.SDI = SDI(tuple(inc_list))

    def forward(self, xs):
        if self.fusion == "SDI":
            return self.SDI(xs)
        if self.fusion == "concat":
            return torch.cat(xs, 1)
        if self.fusion == "bifpn":
            w = torch.relu(self.fusion_weight)
            w = (w / (w.sum() + 1e-4)).to(xs[0].dtype)
            return sum(w[i] * xs[i] for i in range(len(xs)))
        xs = [conv(x) for conv, x in zip(self.fusion_conv, xs)]
        if self.fusion == "weight":
            return sum(xs[1:], xs[0])
        gate = torch.softmax(self.fusion_adaptive(torch.cat(xs, 1)), dim=1)
        return sum(gate[:, i:i + 1] * xs[i] for i in range(len(xs)))


class MaxSigmoidAttnBlock(nn.Module):
    """Text-guided max-sigmoid gate (reference block.py:418): the image
    embedding scores against every class text embedding, the maximum over
    the classes, sigmoided per head, gates the 3x3-projected features."""

    def __init__(self, c1: int, c2: int, nh: int = 1, ec: int = 128, gc: int = 512,
                 scale: bool = False):
        super().__init__()
        self.nh, self.hc = nh, c2 // nh
        self.ec = Conv(c1, ec, 1, act=False) if c1 != ec else None
        self.gl = nn.Linear(gc, ec)
        self.bias = nn.Parameter(torch.zeros(nh))
        self.proj_conv = Conv(c1, c2, 3, 1, act=False)
        self.scale = nn.Parameter(torch.ones(nh)) if scale else None

    def forward(self, x, guide):
        b, _, h, w = x.shape
        embed = self.ec(x) if self.ec is not None else x
        with autocast_off(x):
            g = self.gl(guide.float()).reshape(guide.shape[0], -1, self.nh, self.hc)
            e = embed.float().reshape(b, self.nh, self.hc, h, w)
            aw = torch.einsum("bmchw,bnmc->bmhwn", e, g).amax(dim=-1) / (self.hc ** 0.5)
            aw = torch.sigmoid(aw + self.bias[None, :, None, None])
            if self.scale is not None:
                aw = aw * self.scale[None, :, None, None]
        y = self.proj_conv(x)
        return (y.reshape(b, self.nh, self.hc, h, w) * aw[:, :, None].to(y.dtype)).reshape(
            b, -1, h, w)


@register
class C2fAttn(nn.Module):
    """C2f with a trailing text-guided attention branch (reference block.py:453)."""

    def __init__(self, c1: int, c2: int, n: int = 1, ec: int = 128, nh: int = 1, gc: int = 512,
                 shortcut: bool = False, g: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((3 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0)
                               for _ in range(n))
        self.attn = MaxSigmoidAttnBlock(self.c, self.c, nh=nh, ec=ec, gc=gc)

    def forward(self, x, guide):
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        ys.append(self.attn(ys[-1], guide))
        return self.cv2(torch.cat(ys, 1))


@register
class ImagePoolingAttn(nn.Module):
    """Image-aware text refinement (reference block.py:480): each level's
    1x1 projection, max-pooled to k x k patches, is attended by the text
    embeddings; the result is added to them. In fp32, as the JAX package
    computes it; its flax names (``projections_i``, ``query_0`` (LayerNorm)
    / ``query_1`` (Dense), ``key_*``, ``value_*``, ``proj``) follow from the
    Sequential / ModuleList indices."""

    def __init__(self, ec: int = 256, ch=(), ct: int = 512, nh: int = 8, k: int = 3,
                 scale: bool = False):
        super().__init__()
        self.ec, self.nh, self.k = ec, nh, k
        # flax's LayerNorm epsilon (1e-6), not torch's default
        self.query = nn.Sequential(nn.LayerNorm(ct, eps=1e-6), nn.Linear(ct, ec))
        self.key = nn.Sequential(nn.LayerNorm(ec, eps=1e-6), nn.Linear(ec, ec))
        self.value = nn.Sequential(nn.LayerNorm(ec, eps=1e-6), nn.Linear(ec, ec))
        self.proj = nn.Linear(ec, ct)
        self.projections = nn.ModuleList(nn.Conv2d(c, ec, 1) for c in ch)
        self.scale = nn.Parameter(torch.zeros(1)) if scale else None

    def forward(self, xs, text):
        bs, k2 = xs[0].shape[0], self.k * self.k
        with autocast_off(text):
            # torch's bins are the JAX package's adaptive_max_pool2d's (its nn/block.py:397)
            x = torch.cat([F.adaptive_max_pool2d(p(x.float()), self.k).reshape(bs, self.ec, k2)
                           for p, x in zip(self.projections, xs)], -1).transpose(1, 2)
            text = text.float()
            hc = self.ec // self.nh
            q = self.query(text).reshape(bs, -1, self.nh, hc)
            kk = self.key(x).reshape(bs, -1, self.nh, hc)
            v = self.value(x).reshape(bs, -1, self.nh, hc)
            aw = torch.softmax(torch.einsum("bnmc,bkmc->bmnk", q, kk) / hc ** 0.5, dim=-1)
            out = self.proj(torch.einsum("bmnk,bkmc->bnmc", aw, v).reshape(bs, -1, self.ec))
            if self.scale is not None:
                out = out * self.scale
            return out + text


# PPHGNetV2 blocks and the RepConv family (RT-DETR's backbone and neck;
# JAX nn/block.py:262-363)


@register
class HGStem(nn.Module):
    """PPHGNetV2 stem (reference block.py:105): five ReLU convs and a 2x2
    stride-1 max-pool, each 2x2 stage on a map zero-padded by one row and
    column at the bottom and right (its inputs are ReLU outputs, >= 0)."""

    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        relu = nn.ReLU()
        self.stem1 = Conv(c1, cm, 3, 2, act=relu)
        self.stem2a = Conv(cm, cm // 2, 2, 1, 0, act=relu)
        self.stem2b = Conv(cm // 2, cm, 2, 1, 0, act=relu)
        self.stem3 = Conv(cm * 2, cm, 3, 2, act=relu)
        self.stem4 = Conv(cm, c2, 1, 1, act=relu)

    def forward(self, x):
        x = F.pad(self.stem1(x), (0, 1, 0, 1))
        x2 = self.stem2b(F.pad(self.stem2a(x), (0, 1, 0, 1)))
        x1 = F.max_pool2d(x, 2, 1)
        return self.stem4(self.stem3(torch.cat([x1, x2], 1)))


class LightConv(nn.Module):
    """1x1 conv without activation, then a depth-wise ReLU conv (reference
    conv.py:83; the copy of JAX nn/block.py:283)."""

    def __init__(self, c1: int, c2: int, k: int = 1):
        super().__init__()
        self.conv1 = Conv(c1, c2, 1, act=False)
        self.conv2 = Conv(c2, c2, k, g=c2, act=nn.ReLU())

    def forward(self, x):
        return self.conv2(self.conv1(x))


@register
class HGBlock(nn.Module):
    """PPHGNetV2 block (reference block.py:136): ``n`` chained (Light)Convs,
    their outputs and the input concatenated, squeezed by ``sc`` and
    excited by ``ec``, with a residual where ``shortcut`` and c1 == c2."""

    def __init__(self, c1: int, cm: int, c2: int, k: int = 3, n: int = 6,
                 lightconv: bool = False, shortcut: bool = False):
        super().__init__()
        relu = nn.ReLU()
        self.m = nn.ModuleList(
            LightConv(c1 if i == 0 else cm, cm, k) if lightconv
            else Conv(c1 if i == 0 else cm, cm, k, act=relu) for i in range(n))
        self.sc = Conv(c1 + n * cm, c2 // 2, 1, 1, act=relu)
        self.ec = Conv(c2 // 2, c2, 1, 1, act=relu)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        ys = [x]
        for m in self.m:
            ys.append(m(ys[-1]))
        y = self.ec(self.sc(torch.cat(ys, 1)))
        return y + x if self.add else y


class RepConv(nn.Module):
    """Train-form RepVGG conv (reference conv.py:173 with bn=False): a k x k
    and a 1x1 conv, each with BN and no activation, summed, then SiLU."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        self.conv1 = Conv(c1, c2, k, s, act=False)
        self.conv2 = Conv(c1, c2, 1, s, act=False)

    def forward(self, x):
        return F.silu(self.conv1(x) + self.conv2(x))


@register
class RepC3(nn.Module):
    """Rep C3 (reference block.py:283): ``n`` RepConvs after ``cv1``, plus
    the parallel ``cv2``, then ``cv3`` where e < 1."""

    def __init__(self, c1: int, c2: int, n: int = 3, e: float = 1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c1, c2, 1, 1)
        self.m = nn.ModuleList(RepConv(c2 if i == 0 else c_, c_) for i in range(n))
        self.cv3 = Conv(c_, c2, 1, 1) if c_ != c2 else nn.Identity()

    def forward(self, x):
        a = self.cv1(x)
        for m in self.m:
            a = m(a)
        return self.cv3(a + self.cv2(x))
