"""TinyViT image encoder of MobileSAM, PyTorch port.

Counterpart of ``yolo_ad_refine_tpu/models/sam/tiny_encoder.py`` (reference
models/sam/modules/tiny_encoder.py): ``Conv2d_BN`` (BatchNorm eps 1e-5 on
its inference statistics), ``MBConv``, ``PatchMerging`` (stride 1 into
320, 448 or 576 channels), the spatially biased ``Attention`` over unique
|offset| classes, ``TinyViTBlock`` (windowed attention, a 3x3 depthwise
local conv, an MLP) and ``TinyViT`` with the SAM neck. Parameter names
are the reference's (``layers.1.blocks.0.attn.attention_biases``); the
classifier head (``norm_head``, ``head``) is built for the checkpoint's
parameters and not run. Conv stages are NCHW, token stages (B, N, C).
LayerNorms take the JAX package's eps 1e-6.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F
from torch import nn

from yolo_ad_refine_tpu_torch.models.sam.modules import LayerNorm2d


class Conv2d_BN(nn.Sequential):  # noqa: N801 (the reference's name)
    """Conv (no bias) + BatchNorm (reference tiny_encoder.py:24)."""

    def __init__(self, a: int, b: int, ks: int = 1, stride: int = 1, pad: int = 0,
                 groups: int = 1):
        super().__init__()
        self.add_module("c", nn.Conv2d(a, b, ks, stride, pad, groups=groups, bias=False))
        self.add_module("bn", nn.BatchNorm2d(b, eps=1e-5))


class PatchEmbed(nn.Module):
    """Two stride-2 Conv2d_BN with GELU between (reference :62)."""

    def __init__(self, in_chans: int, embed_dim: int):
        super().__init__()
        n = embed_dim
        self.seq = nn.Sequential(Conv2d_BN(in_chans, n // 2, 3, 2, 1), nn.GELU(),
                                 Conv2d_BN(n // 2, n, 3, 2, 1))

    def forward(self, x):
        return self.seq(x)


class MBConv(nn.Module):
    """1x1 expand, 3x3 depthwise, 1x1 project, residual (reference :104)."""

    def __init__(self, in_chans: int, out_chans: int, expand_ratio: float = 4.0):
        super().__init__()
        hidden = int(in_chans * expand_ratio)
        self.conv1 = Conv2d_BN(in_chans, hidden, 1)
        self.conv2 = Conv2d_BN(hidden, hidden, 3, 1, 1, groups=hidden)
        self.conv3 = Conv2d_BN(hidden, out_chans, 1)

    def forward(self, x):
        y = F.gelu(self.conv1(x))
        y = F.gelu(self.conv2(y))
        return F.gelu(x + self.conv3(y))


class PatchMerging(nn.Module):
    """1x1 -> 3x3 depthwise (stride 1 into 320, 448 or 576 channels, else
    2) -> 1x1 (reference :165); NCHW in and out."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        stride = 1 if out_dim in (320, 448, 576) else 2
        self.conv1 = Conv2d_BN(dim, out_dim, 1)
        self.conv2 = Conv2d_BN(out_dim, out_dim, 3, stride, 1, groups=out_dim)
        self.conv3 = Conv2d_BN(out_dim, out_dim, 1)

    def forward(self, x):
        x = F.gelu(self.conv1(x))
        x = F.gelu(self.conv2(x))
        return self.conv3(x)


def _bias_idxs(resolution: tuple[int, int]):
    """(N, N) index of each token pair's |offset| class, and the class count."""
    points = list(itertools.product(range(resolution[0]), range(resolution[1])))
    offsets: dict = {}
    idxs = []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    n = len(points)
    return torch.tensor(idxs, dtype=torch.long).view(n, n), len(offsets)


class Attention(nn.Module):
    """LayerNorm, fused qkv, per-head trainable biases over the tokens'
    |offset| classes (reference :363); x (B, N, C)."""

    def __init__(self, dim: int, key_dim: int, num_heads: int = 8, attn_ratio: float = 4,
                 resolution: tuple[int, int] = (14, 14)):
        super().__init__()
        self.num_heads, self.key_dim = num_heads, key_dim
        self.d = int(attn_ratio * key_dim)
        self.dh = self.d * num_heads
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, self.dh + 2 * key_dim * num_heads)
        self.proj = nn.Linear(self.dh, dim)
        idxs, n_off = _bias_idxs(resolution)
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, n_off))
        self.register_buffer("attention_bias_idxs", idxs, persistent=False)

    def forward(self, x):
        b, n, _ = x.shape
        qkv = self.qkv(self.norm(x)).view(b, n, self.num_heads, -1)
        q, k, v = qkv.split([self.key_dim, self.key_dim, self.d], dim=3)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        attn = (q @ k.transpose(-2, -1)) * self.key_dim**-0.5
        attn = attn + self.attention_biases[:, self.attention_bias_idxs][None]
        attn = attn.float().softmax(-1).to(v.dtype)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, self.dh))


class Mlp(nn.Module):
    """LayerNorm -> fc1 -> GELU -> fc2 (reference :331)."""

    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.norm = nn.LayerNorm(in_features, eps=1e-6)
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, in_features)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(self.norm(x))))


class TinyViTBlock(nn.Module):
    """Windowed biased attention (attn_ratio 1), local depthwise conv, MLP
    (reference :492); x (B, H*W, C) over ``input_resolution``."""

    def __init__(self, dim: int, input_resolution: tuple[int, int], num_heads: int,
                 window_size: int = 7, mlp_ratio: float = 4.0, local_conv_size: int = 3):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.window_size = window_size
        self.attn = Attention(dim, dim // num_heads, num_heads, 1.0, (window_size, window_size))
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.local_conv = Conv2d_BN(dim, dim, local_conv_size, 1, local_conv_size // 2,
                                    groups=dim)

    def forward(self, x):
        h, w = self.input_resolution
        b, hw, c = x.shape
        ws = self.window_size
        res = x
        if h == ws and w == ws:
            x = self.attn(x)
        else:
            xi = x.view(b, h, w, c)
            pb, pr = (ws - h % ws) % ws, (ws - w % ws) % ws
            if pb or pr:
                xi = F.pad(xi, (0, 0, 0, pr, 0, pb))
            ph, pw = h + pb, w + pr
            nh, nw = ph // ws, pw // ws
            xi = xi.view(b, nh, ws, nw, ws, c).transpose(2, 3).reshape(b * nh * nw, ws * ws, c)
            xi = self.attn(xi)
            xi = xi.view(b, nh, nw, ws, ws, c).transpose(2, 3).reshape(b, ph, pw, c)
            x = xi[:, :h, :w].reshape(b, hw, c)
        x = res + x
        xs = self.local_conv(x.transpose(1, 2).reshape(b, c, h, w))
        x = xs.view(b, c, hw).transpose(1, 2)
        return x + self.mlp(x)


class ConvLayer(nn.Module):
    """The MBConv stage and its PatchMerging (reference :222)."""

    def __init__(self, dim: int, depth: int, out_dim: int):
        super().__init__()
        self.blocks = nn.ModuleList(MBConv(dim, dim) for _ in range(depth))
        self.downsample = PatchMerging(dim, out_dim)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x)


class BasicLayer(nn.Module):
    """A stage of TinyViTBlocks on an (r, r) grid, then PatchMerging unless
    it is the last (reference :650). NCHW in and out."""

    def __init__(self, dim: int, r: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, out_dim: int | None):
        super().__init__()
        self.blocks = nn.ModuleList(TinyViTBlock(dim, (r, r), num_heads, window_size, mlp_ratio)
                                    for _ in range(depth))
        self.downsample = PatchMerging(dim, out_dim) if out_dim else None

    def forward(self, x):
        b, c, h, w = x.shape
        x = x.flatten(2).transpose(1, 2)
        for blk in self.blocks:
            x = blk(x)
        x = x.transpose(1, 2).reshape(b, c, h, w)
        return self.downsample(x) if self.downsample is not None else x


class TinyViT(nn.Module):
    """Reference :765 with the SAM neck: image (B, 3, S, S) -> embeddings
    (B, 256, S/16, S/16)."""

    def __init__(self, img_size: int = 1024, embed_dims=(64, 128, 160, 320), depths=(2, 2, 6, 2),
                 num_heads=(2, 4, 5, 10), window_sizes=(7, 7, 14, 7), mlp_ratio: float = 4.0,
                 num_classes: int = 1000):
        super().__init__()
        self.patch_embed = PatchEmbed(3, embed_dims[0])
        pr = img_size // 4
        layers = [ConvLayer(embed_dims[0], depths[0], embed_dims[1])]
        for i in range(1, len(depths)):
            r = pr // (2 ** (i - 1 if i == 3 else i))
            layers.append(BasicLayer(embed_dims[i], r, depths[i], num_heads[i], window_sizes[i],
                                     mlp_ratio,
                                     embed_dims[i + 1] if i < len(depths) - 1 else None))
        self.layers = nn.ModuleList(layers)
        self.norm_head = nn.LayerNorm(embed_dims[-1])
        self.head = nn.Linear(embed_dims[-1], num_classes)
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dims[-1], 256, 1, bias=False), LayerNorm2d(256),
            nn.Conv2d(256, 256, 3, padding=1, bias=False), LayerNorm2d(256))

    def forward(self, x):
        x = self.patch_embed(x)
        for layer in self.layers:
            x = layer(x)
        return self.neck(x)
