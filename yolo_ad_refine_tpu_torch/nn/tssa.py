"""Token-statistics attention, frequency-domain FFN and the flagship C2PTSSA.

Counterpart of the flagship's part of ``yolo_ad_refine_tpu/nn/tssa.py``
(reference ultralytics/nn/modules/block.py: EDFFN:2376,
CrossScaleAttentionTSSA:2417, AdaptiveDynamicTanh:2493,
ProgressiveFeatureFusion:2579, ProgressiveTSSA_Fusion:2632, C2PTSSA:2700).
The EDFFN FFT runs in fp32, as the reference forces with ``.float()``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from yolo_ad_refine_tpu_torch.nn.block import C2PSA
from yolo_ad_refine_tpu_torch.nn.common import batch_norm
from yolo_ad_refine_tpu_torch.nn.registry import register


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


@register(name="C2PTSSA", aliases=("C2ProgressiveTSSA_Fusion",))
class C2PTSSA(C2PSA):
    """Flagship layer-10 module (reference block.py:2700-2710)."""

    def inner_block(self, c: int) -> nn.Module:
        return ProgressiveTSSAFusion(c, num_heads=max(1, c // 64))
