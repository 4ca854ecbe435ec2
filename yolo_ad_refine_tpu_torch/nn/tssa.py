"""Token-statistics attention, frequency-domain FFN, Mona adapters, and the
C2PSA-style blocks built on them.

Counterpart of ``yolo_ad_refine_tpu/nn/tssa.py`` (reference
ultralytics/nn/modules/block.py: DynamicTanh:1624, AttentionTSSA:1646,
TSSAlock_DYT_Mona_EDFFN:1685, C2TSSA_DYT_Mona_EDFFN:1705, PSABlock_EDFFN /
C2PSA_EDFFN:1612-1618, HierarchicalMona:1782, AdaptiveTSSA_Enhanced:1901,
C2AdaptiveTSSA_Enhanced:2033, SEBlock:2049, StandardFFN:2066,
SimpleFeatureProcessor:2080, ProgressiveTSSA_Fusion0:2152,
ProgressiveFeatureFusion1:2206, ProgressiveTSSA_Fusion1:2285,
C2ProgressiveTSSA_Fusion1:2339, C2SFA:2358, EDFFN:2376,
CrossScaleAttentionTSSA:2417, AdaptiveDynamicTanh:2493,
ProgressiveFeatureFusion:2579, ProgressiveTSSA_Fusion:2632, C2PTSSA:2700;
Mona / MonaOp: mona.py:12-65). The EDFFN FFT and the TSSA token statistics
run in fp32 whatever the input's type (autocast off), as the JAX package
computes them; fp64 inputs keep fp64.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from yolo_ad_refine_tpu_torch.nn.block import C2PSA, Attention
from yolo_ad_refine_tpu_torch.nn.common import LayerNorm2d, autocast_off, batch_norm
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


def _channels(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) parameter as (1, C, 1, 1) in ``x``'s type."""
    return t.view(1, -1, 1, 1).to(x.dtype)


class DynamicTanh(nn.Module):
    """Norm-free normalisation tanh(alpha * x) * w + b over the channels
    (reference block.py:1624)."""

    def __init__(self, c: int, alpha_init: float = 0.5):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), alpha_init))
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return torch.tanh(self.alpha.to(x.dtype) * x) * _channels(self.weight, x) + \
            _channels(self.bias, x)


class AttentionTSSA(nn.Module):
    """Token Statistics Self-Attention, O(N) in tokens (reference
    block.py:1646), on tokens (B, N, C). One shared bias-free projection,
    weights L2-normalised over the tokens, and Pi softmaxed over the heads
    (the fork's ``nn.Softmax(dim=1)`` on (b, h, n)). ``dim // num_heads``
    raises for ``num_heads == 0``, as the JAX module does."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.dim, self.num_heads, self.head_dim = dim, num_heads, dim // num_heads
        self.qkv = nn.Linear(dim, dim, bias=False)
        self.temp = nn.Parameter(torch.ones(num_heads, 1))
        self.to_out = nn.Sequential(nn.Linear(dim, dim))

    def forward(self, x):
        b, n, _ = x.shape
        w = self.qkv(x).reshape(b, n, self.num_heads, self.head_dim).transpose(1, 2)
        acc = torch.promote_types(w.dtype, torch.float32)  # fp32 math, fp64 kept
        with autocast_off(x):
            w = w.to(acc)
            w_normed = w / (torch.linalg.vector_norm(w, dim=-2, keepdim=True) + 1e-12)
            pi = torch.softmax((w_normed ** 2).sum(-1) * self.temp.to(acc), dim=1)  # over heads
            pi_norm = pi / (pi.sum(-1, keepdim=True) + 1e-8)
            dots = torch.einsum("bhn,bhnd->bhd", pi_norm, w ** 2)[:, :, None, :]
            out = -(w * pi[..., None]) * (1.0 / (1.0 + dots))
        out = out.transpose(1, 2).reshape(b, n, self.dim).to(x.dtype)
        return self.to_out(out)


class MonaOp(nn.Module):
    """Depthwise 3x3 / 5x5 / 7x7 mixer with a 1x1 projector (reference
    mona.py:12-33)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1, groups=c)
        self.conv2 = nn.Conv2d(c, c, 5, padding=2, groups=c)
        self.conv3 = nn.Conv2d(c, c, 7, padding=3, groups=c)
        self.projector = nn.Conv2d(c, c, 1)

    def forward(self, x):
        x = (self.conv1(x) + self.conv2(x) + self.conv3(x)) / 3.0 + x
        return x + self.projector(x)


class Mona(nn.Module):
    """Multi-cognitive visual adapter (reference mona.py:36-65): channel
    LayerNorm scaled by ``gamma`` plus the input scaled by ``gammax``, a 1x1
    down to 64 channels, MonaOp, GELU, dropout (0.1, train mode only), a 1x1
    back, and the residual."""

    def __init__(self, c: int, dropout: float = 0.1):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((c,), 1e-6))
        self.gammax = nn.Parameter(torch.ones(c))
        self.norm = LayerNorm2d(c, eps=1e-5)
        self.project1 = nn.Conv2d(c, 64, 1)
        self.adapter_conv = MonaOp(64)
        self.dropout = nn.Dropout(dropout)
        self.project2 = nn.Conv2d(64, c, 1)

    def forward(self, x):
        y = self.norm(x) * _channels(self.gamma, x) + x * _channels(self.gammax, x)
        y = self.dropout(gelu_exact(self.adapter_conv(self.project1(y))))
        return x + self.project2(y)


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


class TSSAlockDyTMonaEDFFN(nn.Module):
    """PSABlock variant: DyT -> TSSA residual -> Mona -> DyT -> EDFFN
    residual -> Mona (reference block.py:1685-1703)."""

    def __init__(self, c: int, num_heads: int = 4, shortcut: bool = True):
        super().__init__()
        self.shortcut = shortcut
        self.dyt1 = DynamicTanh(c)
        self.attn = AttentionTSSA(c, num_heads)
        self.mona1 = Mona(c)
        self.dyt2 = DynamicTanh(c)
        self.ffn = EDFFN(c, 2)
        self.mona2 = Mona(c)

    def forward(self, x):
        b, c, h, w = x.shape
        a = self.attn(self.dyt1(x).flatten(2).transpose(1, 2)).transpose(1, 2).reshape(b, c, h, w)
        x = self.mona1(x + a if self.shortcut else a)
        f = self.ffn(self.dyt2(x))
        return self.mona2(x + f if self.shortcut else f)


@register(name="C2TSSA_DYT_Mona_EDFFN")
class C2TSSADyTMonaEDFFN(C2PSA):
    """C2PSA around TSSAlock blocks (reference block.py:1705), the 697
    ablation's layer 10. ``c // 64`` heads with no floor: a block narrower
    than 64 channels raises, as in the JAX package."""

    def inner_block(self, c: int) -> nn.Module:
        return TSSAlockDyTMonaEDFFN(c, num_heads=c // 64)


# C2SFA ablation family (reference block.py:2049-2374)


class SEBlock(nn.Module):
    """Squeeze-and-excitation gate (reference block.py:2049-2064)."""

    def __init__(self, c: int, r: int = 16):
        super().__init__()
        self.fc0 = nn.Conv2d(c, int(c / r), 1, bias=False)
        self.fc1 = nn.Conv2d(int(c / r), c, 1, bias=False)

    def forward(self, x):
        g = self.fc1(torch.relu(self.fc0(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(g)


class StandardFFN(nn.Module):
    """1x1 expand -> GELU -> 1x1 project (reference block.py:2066-2078)."""

    def __init__(self, c: int, expansion: float = 2.0):
        super().__init__()
        self.cv1 = nn.Conv2d(c, int(c * expansion), 1, bias=False)
        self.cv2 = nn.Conv2d(int(c * expansion), c, 1, bias=False)

    def forward(self, x):
        return self.cv2(gelu_exact(self.cv1(x)))


class SimpleFeatureProcessor(nn.Module):
    """GroupNorm -> depthwise 3x3 -> GELU -> 1x1 (reference block.py:2080-2096)."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = nn.GroupNorm(max(1, c // 32), c, eps=1e-5)
        self.conv_dw = nn.Conv2d(c, c, 3, padding=1, groups=c)
        self.conv_pw = nn.Conv2d(c, c, 1)

    def forward(self, x):
        return self.conv_pw(gelu_exact(self.conv_dw(self.norm(x))))


class ProgressiveTSSAFusion0(nn.Module):
    """The C2SFA inner block (reference block.py:2152-2215): SFP -> SE gate
    (x learnable 0.1 residual), then SFP -> FFN (x learnable 0.1 residual)."""

    def __init__(self, c: int, shortcut: bool = True):
        super().__init__()
        self.shortcut = shortcut
        self.residual_weight1 = nn.Parameter(torch.tensor(0.1))
        self.residual_weight2 = nn.Parameter(torch.tensor(0.1))
        self.pre_attn_block = SimpleFeatureProcessor(c)
        self.attn = SEBlock(c)
        self.pre_ffn_block = SimpleFeatureProcessor(c)
        self.ffn = StandardFFN(c)

    def forward(self, x):
        y = self.attn(self.pre_attn_block(x))
        x = x + y * self.residual_weight1.to(x.dtype) if self.shortcut else y
        y = self.ffn(self.pre_ffn_block(x))
        return x + y * self.residual_weight2.to(x.dtype) if self.shortcut else y


@register(name="C2SFA")
class C2SFA(C2PSA):
    """C2PSA with ProgressiveTSSA_Fusion0 blocks (reference block.py:2358-2374)."""

    def inner_block(self, c: int) -> nn.Module:
        return ProgressiveTSSAFusion0(c)


# The other ablation variants (dead in the reference's active path, part of
# its module surface): PSABlock_EDFFN / C2PSA_EDFFN, HierarchicalMona,
# AdaptiveTSSA_Enhanced / C2AdaptiveTSSA_Enhanced, ProgressiveTSSA_Fusion1 /
# C2ProgressiveTSSA_Fusion1.


class PSABlockEDFFN(nn.Module):
    """PSABlock whose conv-FFN is an EDFFN (reference block.py:1612)."""

    def __init__(self, c: int, attn_ratio: float = 0.5, num_heads: int = 4,
                 shortcut: bool = True):
        super().__init__()
        self.shortcut = shortcut
        self.attn = Attention(c, num_heads, attn_ratio)
        self.ffn = EDFFN(c, 2)

    def forward(self, x):
        a = self.attn(x)
        x = x + a if self.shortcut else a
        f = self.ffn(x)
        return x + f if self.shortcut else f


@register(name="C2PSA_EDFFN")
class C2PSAEDFFN(C2PSA):
    """C2PSA with PSABlock_EDFFN blocks (reference block.py:1618)."""

    def inner_block(self, c: int) -> nn.Module:
        return PSABlockEDFFN(c, 0.5, max(1, c // 64))


class MonaLevel(nn.Module):
    """One HierarchicalMona level: 1x1 down, MonaOp, 1x1 up, channel LayerNorm."""

    def __init__(self, c: int, next_dim: int):
        super().__init__()
        self.project_down = nn.Conv2d(c, next_dim, 1)
        self.mona_op = MonaOp(next_dim)
        self.project_up = nn.Conv2d(next_dim, c, 1)
        self.norm = LayerNorm2d(c, eps=1e-5)

    def forward(self, x):
        return self.norm(self.project_up(self.mona_op(self.project_down(x))))


class HierarchicalMona(nn.Module):
    """Multi-level Mona adapter pyramid (reference block.py:1782-1899): each
    level halves the channels (floor 32) around a MonaOp; levels are chained
    by concat + 1x1 fusion, summed with learned weights and gated by a tiny
    ``gamma``."""

    def __init__(self, c: int, hierarchy_levels: int = 3):
        super().__init__()
        self.levels = hierarchy_levels
        self.final_weights = nn.Parameter(torch.full((hierarchy_levels,), 1.0 / hierarchy_levels))
        self.gamma = nn.Parameter(torch.full((c,), 1e-6))
        self.level_processors = nn.ModuleList(
            MonaLevel(c, max(32, c // (2 ** lv))) for lv in range(hierarchy_levels))
        self.level_fusion = nn.ModuleList(
            nn.Conv2d(2 * c, c, 1) for _ in range(hierarchy_levels - 1))

    def forward(self, x):
        outs, current = [], x
        for lv, level in enumerate(self.level_processors):
            y = level(current)
            outs.append(y)
            if lv < self.levels - 1:
                current = self.level_fusion[lv](torch.cat([current, y], 1))
        weighted = sum(self.final_weights[i].to(x.dtype) * outs[i] for i in range(len(outs)))
        return x + weighted * _channels(self.gamma, x)


class AdaptiveTSSAEnhanced(nn.Module):
    """AdaptiveDyT + cross-scale TSSA + HierarchicalMona + gated EDFFN
    (reference block.py:1901-2031)."""

    def __init__(self, c: int, num_heads: int = 4, shortcut: bool = True, scales=(1, 2, 4),
                 hierarchy_levels: int = 3):
        super().__init__()
        self.shortcut = shortcut
        self.dyt1 = AdaptiveDynamicTanh(c, len(scales))
        self.attn = CrossScaleAttentionTSSA(c, num_heads, scales)
        self.mona1 = HierarchicalMona(c, hierarchy_levels)
        self.dyt2 = AdaptiveDynamicTanh(c, len(scales))
        self.ffn = EDFFN(c, 2)
        self.feature_gate = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(c, c // 4, 1),
                                          nn.ReLU(), nn.Conv2d(c // 4, c, 1), nn.Sigmoid())
        self.mona2 = HierarchicalMona(c, hierarchy_levels)

    def forward(self, x):
        b, c, h, w = x.shape
        attn = self.attn(self.dyt1(x)).transpose(1, 2).reshape(b, c, h, w)
        x = self.mona1(x + attn if self.shortcut else attn)
        f = self.ffn(self.dyt2(x)) * self.feature_gate(x)
        return self.mona2(x + f if self.shortcut else f)


@register(name="C2AdaptiveTSSA_Enhanced")
class C2AdaptiveTSSAEnhanced(C2PSA):
    """C2PSA with AdaptiveTSSA_Enhanced blocks (reference block.py:2033-2047)."""

    def inner_block(self, c: int) -> nn.Module:
        return AdaptiveTSSAEnhanced(c, num_heads=max(1, c // 64))


# the reference keeps a verbatim copy of ProgressiveFeatureFusion at
# block.py:2206 for the _Fusion1 family
ProgressiveFeatureFusion1 = ProgressiveFeatureFusion


class ProgressiveTSSAFusion1(nn.Module):
    """PTSSA variant with a GroupNorm(1) attention input and a 4x EDFFN
    (reference block.py:2285-2336)."""

    def __init__(self, c: int, num_heads: int = 4, shortcut: bool = True):
        super().__init__()
        self.shortcut = shortcut
        self.res_w1 = nn.Parameter(torch.tensor(0.1))
        self.res_w2 = nn.Parameter(torch.tensor(0.1))
        self.feature_enhancement1 = ProgressiveFeatureFusion1(c)
        self.attn_norm = nn.GroupNorm(1, c, eps=1e-5)
        self.attn = CrossScaleAttentionTSSA(c, num_heads)
        self.feature_enhancement2 = ProgressiveFeatureFusion1(c)
        self.ffn = EDFFN(c, 4)

    def forward(self, x):
        b, c, h, w = x.shape
        res1 = x
        x = self.feature_enhancement1(x)
        attn = self.attn(self.attn_norm(x)).transpose(1, 2).reshape(b, c, h, w)
        x = res1 + attn * self.res_w1.to(x.dtype) if self.shortcut else attn
        res2 = x
        f = self.ffn(self.feature_enhancement2(x))
        return res2 + f * self.res_w2.to(x.dtype) if self.shortcut else f


@register(name="C2ProgressiveTSSA_Fusion1")
class C2ProgressiveTSSAFusion1(C2PSA):
    """C2PSA with ProgressiveTSSA_Fusion1 blocks, 32-channel heads
    (reference block.py:2339-2357)."""

    def inner_block(self, c: int) -> nn.Module:
        return ProgressiveTSSAFusion1(c, num_heads=max(1, c // 32))
