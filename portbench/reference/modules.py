"""The flagship's modules, frozen: a copy of the port's ``nn/`` classes that
``yolo11-701-YOLO-AD-Refine.yaml`` builds, in plain PyTorch.

Copied from ``yolo_ad_refine_tpu_torch`` (``nn/common.py``, ``nn/block.py``,
``nn/tssa.py``, ``nn/head.py``, ``ops/anchors.py``) so that a later change to
the program cannot move the yardstick. The parameter and buffer names are
the program's, so one state dict loads into both. Departures from the
program: no data-parallel branch (one process), BatchNorm's ``update_stats``
switch (for activation checkpointing), and the deformable conv is
``dcn.modulated_deform_conv2d``, plain PyTorch, in place of the program's
kernels.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.dcn import modulated_deform_conv2d

# ---- from nn/common.py
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
    parameter and buffer names are torch's. ``update_stats`` False leaves
    the running statistics alone: the reference's recomputation under
    activation checkpointing sets it, so that they move once a step."""

    update_stats = True

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if self.update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
                self._update_running(mean, var)
        return y

    def _update_running(self, mean, var):
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean * m)
        self.running_var.mul_(1.0 - m).add_(var * m)
        self.num_batches_tracked.add_(1)


def batch_norm(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-3, momentum=0.03)


def _act(act) -> nn.Module:
    if act is True:
        return nn.SiLU()
    if act in (False, None):
        return nn.Identity()
    return act


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


def autocast_off(x: torch.Tensor):
    """Autocast off on ``x``'s device (none on the meta device, where the
    operations are counted)."""
    if x.device.type == "meta":
        return contextlib.nullcontext()
    return torch.autocast(x.device.type, enabled=False)


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


# ---- from nn/block.py
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
        sig = torch.sigmoid(y_global)
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


class C3k2MLCA(C3k2):
    """C3k2 with MLCA bottlenecks (reference block.py:1601)."""

    def inner_block(self, c: int) -> nn.Module:
        if self.c3k:
            return C3kMLCA(c, c, 2, self.shortcut, self.g)
        return BottleneckMLCA(c, c, self.shortcut, self.g, k=(3, 3), e=0.5)


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


class Multiply(nn.Module):
    """Elementwise product of a 2-input list (reference block.py:1442)."""

    def forward(self, xs):
        return xs[0] * xs[1]


class Add(nn.Module):
    """Elementwise sum of an input list (reference block.py:1448)."""

    def forward(self, xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out


class Fusion(nn.Module):
    """Multi-input fusion node (reference block.py:1500-1537) in the
    flagship's mode, 'bifpn': learnable ReLU-normalised weights."""

    def __init__(self, inc_list, fusion: str = "bifpn"):
        super().__init__()
        if fusion != "bifpn":
            raise ValueError(f"the reference fuses by 'bifpn' only, not {fusion!r}")
        self.fusion_weight = nn.Parameter(torch.ones(len(inc_list), dtype=torch.float32))

    def forward(self, xs):
        w = torch.relu(self.fusion_weight)
        w = (w / (w.sum() + 1e-4)).to(xs[0].dtype)
        return sum(w[i] * xs[i] for i in range(len(xs)))


# ---- from nn/tssa.py
def gelu_exact(x):
    """Exact (erf) GELU, torch's default."""
    return F.gelu(x)


def pad_reflect_end(x, h_n: int, w_n: int):
    """Reflect-pad the bottom/right of (..., H, W) by (h_n, w_n) with numpy's
    'reflect' rule, which also covers pads as long as the axis (torch's
    reflect pad does not): index i maps into period 2*(n-1)."""

    def index(n: int, pad: int):
        i = torch.arange(n + pad, device=x.device)
        if n == 1:
            return torch.zeros_like(i)
        i = i % (2 * (n - 1))
        return torch.where(i >= n, 2 * (n - 1) - i, i)

    h, w = x.shape[-2:]
    if h_n:
        x = x.index_select(-2, index(h, h_n))
    if w_n:
        x = x.index_select(-1, index(w, w_n))
    return x


class AdaptiveDynamicTanh(nn.Module):
    """Multi-scale DyT with SE-style importance gating (reference block.py:2493).
    ``scale_weights`` is unused in the forward, as in the reference, and kept
    for its state_dict."""

    def __init__(self, c: int, num_scales: int = 3):
        super().__init__()
        self.num_scales = num_scales
        self.alphas = nn.Parameter(torch.linspace(0.3, 1.0, num_scales).view(1, -1, 1, 1))
        self.scale_weights = nn.Parameter(torch.full((num_scales,), 1.0 / num_scales))
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.importance_gate = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(c, c // 4, 1), nn.ReLU(),
            nn.Conv2d(c // 4, num_scales, 1), nn.Softmax(dim=1))

    def forward(self, x):
        importance = self.importance_gate(x)  # (b, ns, 1, 1)
        out = 0.0
        for i in range(self.num_scales):
            out = out + torch.tanh(self.alphas[0, i].to(x.dtype) * x) * importance[:, i:i + 1]
        return out * self.weight.view(1, -1, 1, 1).to(x.dtype) + self.bias.view(1, -1, 1, 1).to(x.dtype)


class PFFStage(nn.Module):
    """One ProgressiveFeatureFusion stage: depthwise 3x3 + BN + GELU, then a
    1x1 channel mix and a depthwise 7x7 spatial mix."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, 1, 1, groups=c)
        self.norm = batch_norm(c)
        self.channel_mix = nn.Conv2d(c, c, 1)
        self.spatial_mix = nn.Conv2d(c, c, 7, 1, 3, groups=c)

    def forward(self, x):
        p = gelu_exact(self.norm(self.conv(x)))
        return self.channel_mix(p) + self.spatial_mix(p) + x


class ProgressiveFeatureFusion(nn.Module):
    """3-stage depthwise/channel-mix refinement with learned stage weights
    (reference block.py:2579-2630)."""

    def __init__(self, c: int, num_stages: int = 3):
        super().__init__()
        self.num_stages = num_stages
        self.stages = nn.ModuleList(PFFStage(c) for _ in range(num_stages))
        self.stage_fusion = nn.ModuleList(nn.Conv2d(2 * c, c, 1) for _ in range(num_stages - 1))
        self.stage_attention = nn.Parameter(torch.full((num_stages,), 1.0 / num_stages))

    def forward(self, x):
        outs = []
        current = x
        for i, stage in enumerate(self.stages):
            out = stage(current)
            outs.append(out)
            if i < self.num_stages - 1:
                current = self.stage_fusion[i](torch.cat([current, out], 1))
        final = sum(self.stage_attention[i].to(x.dtype) * outs[i] for i in range(self.num_stages))
        return final + x


class CrossScaleAttentionTSSA(nn.Module):
    """TSSA at scales (1, 2, 4) fused by multi-head attention (reference
    block.py:2417-2491). Returns tokens (B, H*W, C)."""

    def __init__(self, dim: int, num_heads: int = 8, scales=(1, 2, 4)):
        super().__init__()
        self.dim, self.num_heads, self.scales = dim, num_heads, tuple(scales)
        self.temps = nn.Parameter(torch.ones(len(self.scales), num_heads, 1))
        self.qkv_projections = nn.ModuleList(
            nn.Linear(dim, dim * 3, bias=False) for _ in self.scales)
        self.cross_scale_fusion = nn.MultiheadAttention(dim, num_heads, batch_first=True)
        self.to_out = nn.Sequential(nn.Linear(dim, dim))

    def forward(self, x):
        b, c, h, w = x.shape
        nh, d = self.num_heads, self.dim // self.num_heads
        outs = []
        for i, scale in enumerate(self.scales):
            xs = x
            if scale > 1:
                xs = F.adaptive_avg_pool2d(x, (h // scale, w // scale))
                xs = F.interpolate(xs, size=(h, w), mode="bilinear", align_corners=False)
            tokens = xs.flatten(2).transpose(1, 2)                     # (b, n, c)
            q, k, v = self.qkv_projections[i](tokens).chunk(3, dim=-1)
            acc = torch.promote_types(q.dtype, torch.float32)  # fp32 math, fp64 kept
            q, k, v = (t.reshape(b, -1, nh, d).transpose(1, 2).to(acc) for t in (q, k, v))
            with autocast_off(x):
                q_normed = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
                pi = torch.softmax((q_normed ** 2).sum(-1) * self.temps[i], dim=-1)  # over tokens
                dots = torch.einsum("bhn,bhnd->bhd", pi, k ** 2)[:, :, None, :]
                out = -(v * pi[..., None]) * (1.0 / (1.0 + dots))
            outs.append(out.transpose(1, 2).reshape(b, h * w, self.dim).to(x.dtype))
        if len(outs) > 1:
            stacked = torch.cat(outs, dim=1)
            fused = self.cross_scale_fusion(stacked, stacked, stacked, need_weights=False)[0]
            fused = fused.reshape(b, len(outs), h * w, c).mean(dim=1)
        else:
            fused = outs[0]
        return self.to_out(fused)


class EDFFN(nn.Module):
    """Frequency-domain FFN from EVSSM (reference block.py:2376-2415).

    1x1 expand -> depthwise 3x3 -> GELU gate -> 1x1 project -> reflect-pad to
    8-multiples -> per-8x8-patch rfft2 * learnable real filter -> irfft2 ->
    crop. The filter is stored (C, 1, 1, 8, 5) as in the reference.
    """

    def __init__(self, dim: int, ffn_expansion_factor: float = 2.0, patch_size: int = 8):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        self.patch_size = patch_size
        self.project_in = nn.Conv2d(dim, hidden * 2, 1, bias=False)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, 3, 1, 1, groups=hidden * 2, bias=False)
        self.project_out = nn.Conv2d(hidden, dim, 1, bias=False)
        self.fft = nn.Parameter(torch.ones(dim, 1, 1, patch_size, patch_size // 2 + 1))

    def forward(self, x):
        y = self.dwconv(self.project_in(x))
        y1, y2 = y.chunk(2, dim=1)
        y = self.project_out(gelu_exact(y1) * y2)
        b, c, h, w = y.shape
        ps = self.patch_size
        h_n, w_n = (ps - h % ps) % ps, (ps - w % ps) % ps
        yp = pad_reflect_end(y, h_n, w_n)
        hp, wp = h + h_n, w + w_n
        patches = yp.reshape(b, c, hp // ps, ps, wp // ps, ps).permute(0, 1, 2, 4, 3, 5)
        f = torch.fft.rfft2(patches.float()) * self.fft.float()
        patches = torch.fft.irfft2(f, s=(ps, ps))
        yp = patches.permute(0, 1, 2, 4, 3, 5).reshape(b, c, hp, wp)
        return yp[:, :, :h, :w].to(x.dtype).contiguous(memory_format=torch.channels_last)


class ProgressiveTSSAFusion(nn.Module):
    """The C2PTSSA inner block (reference block.py:2632-2698): PFF ->
    AdaptiveDyT -> CrossScaleTSSA (x learnable 0.1 residual) -> PFF ->
    AdaptiveDyT -> EDFFN (x learnable 0.1 residual)."""

    def __init__(self, c: int, num_heads: int = 4, shortcut: bool = True):
        super().__init__()
        self.shortcut = shortcut
        self.residual_weight1 = nn.Parameter(torch.tensor(0.1))
        self.residual_weight2 = nn.Parameter(torch.tensor(0.1))
        self.progressive_fusion1 = ProgressiveFeatureFusion(c)
        self.dyt1 = AdaptiveDynamicTanh(c)
        self.attn = CrossScaleAttentionTSSA(c, num_heads)
        self.progressive_fusion2 = ProgressiveFeatureFusion(c)
        self.dyt2 = AdaptiveDynamicTanh(c)
        self.ffn = EDFFN(c, 2)

    def forward(self, x):
        b, c, h, w = x.shape
        identity = x
        x = self.progressive_fusion1(x)
        attn = self.attn(self.dyt1(x)).transpose(1, 2).reshape(b, c, h, w)
        x = identity + attn * self.residual_weight1.to(x.dtype) if self.shortcut else attn
        x = self.progressive_fusion2(x)
        f = self.ffn(self.dyt2(x))
        return x + f * self.residual_weight2.to(x.dtype) if self.shortcut else f


class C2PTSSA(C2PSA):
    """Flagship layer-10 module (reference block.py:2700-2710)."""

    def inner_block(self, c: int) -> nn.Module:
        return ProgressiveTSSAFusion(c, num_heads=max(1, c // 64))


# ---- from ops/anchors.py
def make_anchors(feat_shapes, strides, grid_cell_offset: float = 0.5,
                 dtype=torch.float32, device=None):
    """Anchor centers from per-level (h, w) feature shapes.

    Returns anchor_points (N, 2) xy in grid units and stride_tensor (N, 1).
    """
    anchor_points, stride_tensor = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=dtype, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=dtype, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        anchor_points.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        stride_tensor.append(torch.full((h * w, 1), float(s), dtype=dtype, device=device))
    return torch.cat(anchor_points), torch.cat(stride_tensor)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True):
    """Decode (l, t, r, b) distances at anchor points into xywh or xyxy boxes."""
    lt, rb = distance[..., :2], distance[..., 2:4]
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim=-1)
    return torch.cat([x1y1, x2y2], dim=-1)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max: float):
    """Encode xyxy boxes as (l, t, r, b) distances clamped to
    [0, reg_max - 0.01], the DFL targets (reference tal.py:330)."""
    x1y1, x2y2 = bbox[..., :2], bbox[..., 2:4]
    dist = torch.cat([anchor_points - x1y1, x2y2 - anchor_points], dim=-1)
    return dist.clamp(0, reg_max - 0.01)


# ---- from nn/head.py
def decode_detections(feats, strides, nc: int, reg_max: int = 16):
    """Per-level (B, no, H, W) maps -> (B, N, 4+nc): xywh boxes in input
    pixels and sigmoided scores."""
    b = feats[0].shape[0]
    no = 4 * reg_max + nc
    x_cat = torch.cat([f.reshape(b, no, -1) for f in feats], dim=2).transpose(1, 2)
    box, cls = x_cat[..., : 4 * reg_max], x_cat[..., 4 * reg_max:]
    shapes = [(f.shape[2], f.shape[3]) for f in feats]
    anchors, stride_t = make_anchors(shapes, strides, 0.5, device=x_cat.device)
    dbox = dist2bbox(dfl_decode(box, reg_max), anchors[None], xywh=True) * stride_t[None]
    return torch.cat([dbox, torch.sigmoid(cls.float())], dim=-1)


def _strides(feats, input_h, default):
    return tuple(input_h // f.shape[2] for f in feats) if input_h is not None else default


class TaskDecomposition(nn.Module):
    """TOOD dynamic layer attention (reference head.py:626-669): a per-image
    sigmoid gate scales each stacked group of channels before the shared 1x1
    reduction conv + GroupNorm + SiLU."""

    def __init__(self, feat_channels: int, stacked_convs: int = 1, la_down_rate: int = 16):
        super().__init__()
        self.feat_channels, self.stacked_convs = feat_channels, stacked_convs
        in_ch = feat_channels * stacked_convs
        self.la_conv1 = nn.Conv2d(in_ch, in_ch // la_down_rate, 1)
        self.la_conv2 = nn.Conv2d(in_ch // la_down_rate, stacked_convs, 1)
        self.reduction_conv = ConvGN(in_ch, feat_channels, 1)

    def forward(self, feat, avg_feat=None):
        b, _, h, w = feat.shape
        if avg_feat is None:
            avg_feat = feat.mean(dim=(2, 3), keepdim=True)
        gate = torch.sigmoid(self.la_conv2(torch.relu(self.la_conv1(avg_feat))))  # (b, s, 1, 1)
        gated = feat.reshape(b, self.stacked_convs, self.feat_channels, h, w) * gate[:, :, None]
        gated = gated.reshape(b, -1, h, w)
        return self.reduction_conv(gated)


class CoordAtt(nn.Module):
    """Coordinate attention (reference head.py:671-707)."""

    def __init__(self, inp: int, oup: int, reduction: int = 32):
        super().__init__()
        mip = max(8, inp // reduction)
        self.conv1 = nn.Conv2d(inp, mip, 1)
        self.bn1 = batch_norm(mip)
        self.conv_h = nn.Conv2d(mip, oup, 1)
        self.conv_w = nn.Conv2d(mip, oup, 1)

    def forward(self, x):
        h = x.shape[2]
        x_h = x.mean(dim=3, keepdim=True)                        # (b, c, h, 1)
        x_w = x.mean(dim=2, keepdim=True).permute(0, 1, 3, 2)    # (b, c, w, 1)
        y = F.hardswish(self.bn1(self.conv1(torch.cat([x_h, x_w], dim=2))))
        a_h = torch.sigmoid(self.conv_h(y[:, :, :h]))                        # (b, o, h, 1)
        a_w = torch.sigmoid(self.conv_w(y[:, :, h:].permute(0, 1, 3, 2)))    # (b, o, 1, w)
        return x * a_w * a_h


class CrossTaskInteraction(nn.Module):
    """Bidirectional gated cls/reg exchange (reference head.py:722-747)."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.cls_to_reg = nn.Conv2d(c, c, 1)
        self.reg_to_cls = nn.Conv2d(c, c, 1)
        self.cls_gate = nn.Sequential(nn.Conv2d(2 * c, c, 1), nn.Sigmoid())
        self.reg_gate = nn.Sequential(nn.Conv2d(2 * c, c, 1), nn.Sigmoid())

    def forward(self, cls_feat, reg_feat):
        c2r = self.cls_to_reg(cls_feat)
        r2c = self.reg_to_cls(reg_feat)
        cls_gate = self.cls_gate(torch.cat([cls_feat, r2c], 1))
        reg_gate = self.reg_gate(torch.cat([reg_feat, c2r], 1))
        return cls_feat + r2c * cls_gate, reg_feat + c2r * reg_gate


class ModulatedDeformConv(nn.Module):
    """The weight of a 3x3 modulated deformable conv (no bias) and its call
    into ``dcn(x, offset, mask, weight, radius)``, the plain DCN here."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c2, c1, 3, 3))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x, offset, mask, dcn, radius: int | None):
        return dcn(x, offset, mask, self.weight, radius=radius)


class DyDCNv2(nn.Module):
    """Modulated deformable conv 3x3 + GroupNorm(16) (reference head.py:751-782),
    sampling unbounded as the program's default (``YAT_DCN_IMPL`` unset)."""

    def __init__(self, c1: int, c2: int, radius: float = 3.0):
        super().__init__()
        self.radius = radius
        self.conv = ModulatedDeformConv(c1, c2)
        self.norm = nn.GroupNorm(16, c2, eps=1e-5)

    def forward(self, x, offset, mask):
        return self.norm(self.conv(x, offset, mask, modulated_deform_conv2d, None))


class ResidualBlockGN(nn.Module):
    """Two Conv_GN 3x3 + projection shortcut (reference head.py:1031-1047)."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.shortcut = ConvGN(c1, c2, 1, act=False) if c1 != c2 else None
        self.conv1 = ConvGN(c1, c2, 3)
        self.conv2 = ConvGN(c2, c2, 3)

    def forward(self, x):
        res = x if self.shortcut is None else self.shortcut(x)
        return self.conv2(self.conv1(x)) + res


class Scale(nn.Module):
    """Learnable scalar multiplier (reference head.py:783)."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(scale, dtype=torch.float32))

    def forward(self, x):
        return x * self.scale.to(x.dtype)


class AYHead(nn.Module):
    """The flagship decoupled detect head (reference head.py:1049-1252).

    Per level: Conv_GN 1x1 stem -> shared Conv_GN 3x3 x2 -> TaskDecomposition
    x2 -> CrossTaskInteraction; cls branch -> ResidualBlockGN; reg branch ->
    offset/mask conv (18 offsets + 9 masks) -> DyDCNv2 -> CoordAtt; a
    foreground-probability conv gates the cls logits; the reg output is
    scaled per level. Trunk modules are shared across levels.

    In train mode the forward also records ``dcn_offset_max``, max |offset|
    over the three levels (raw offsets, detached), where the train step
    reads it, as the JAX head sows it into "diagnostics". ``dcn_radius``
    (the model yaml's top-level key) is the DyDCNv2's clip radius, which the
    trainer's offset guard reads.
    """

    def __init__(self, nc: int = 80, ch=(), reg_max: int = 16, strides=(8, 16, 32),
                 dcn_radius: float = 3.0):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        self.dcn_radius = dcn_radius
        self.nl = len(ch)
        hidc = max(ch) if ch else 512
        task_ch = hidc // 2
        self.stems = nn.ModuleList(ConvGN(c, hidc, 1) for c in ch)
        self.share_conv = nn.ModuleList([ConvGN(hidc, task_ch, 3), ConvGN(task_ch, task_ch, 3)])
        self.cls_decomp = TaskDecomposition(task_ch, 1, 16)
        self.reg_decomp = TaskDecomposition(task_ch, 1, 16)
        self.cross_task = CrossTaskInteraction(task_ch)
        self.rep_block_cls = ResidualBlockGN(task_ch, task_ch)
        self.coord_attention_reg = CoordAtt(task_ch, task_ch)
        self.DyDCNV2 = DyDCNv2(task_ch, task_ch, radius=dcn_radius)
        self.spatial_conv_offset = nn.Conv2d(task_ch, 27, 3, padding=1)
        self.cls_prob_conv = nn.Sequential(
            nn.Conv2d(task_ch, task_ch // 2, 1), nn.ReLU(),
            nn.Conv2d(task_ch // 2, 1, 3, padding=1), nn.Sigmoid())
        self.cv2 = nn.Conv2d(task_ch, 4 * reg_max, 1)
        self.cv3 = nn.Conv2d(task_ch, nc, 1)
        self.scale = nn.ModuleList(Scale(1.0) for _ in range(self.nl))
        self.dcn_offset_max = None

    def bias_init(self):
        self.cv2.bias.data.fill_(1.0)
        self.cv3.bias.data.fill_(-math.log((1 - 0.01) / 0.01))

    def forward(self, xs, input_h: int | None = None):
        outputs, offset_max = [], []
        for i in range(self.nl):
            feat = self.share_conv[1](self.share_conv[0](self.stems[i](xs[i])))
            avg_feat = feat.mean(dim=(2, 3), keepdim=True)
            cls_feat, reg_feat = self.cross_task(self.cls_decomp(feat, avg_feat),
                                                 self.reg_decomp(feat, avg_feat))
            cls_feat_enh = self.rep_block_cls(cls_feat)
            om = self.spatial_conv_offset(feat)
            offset = om[:, :18].float().contiguous(memory_format=torch.channels_last)
            mask = torch.sigmoid(om[:, 18:].float()).contiguous(memory_format=torch.channels_last)
            offset_max.append(offset.detach().abs().amax())
            reg_enh = self.coord_attention_reg(
                self.DyDCNV2(reg_feat.contiguous(memory_format=torch.channels_last), offset, mask))
            prob = self.cls_prob_conv(feat)
            reg_output = self.scale[i](self.cv2(reg_enh))
            cls_output = self.cv3(cls_feat_enh * prob)
            outputs.append(torch.cat([reg_output, cls_output], 1))
        if self.training:
            self.dcn_offset_max = torch.stack(offset_max).amax()
            return outputs
        y = decode_detections(outputs, _strides(outputs, input_h, self.strides), self.nc,
                              self.reg_max)
        return y, outputs
