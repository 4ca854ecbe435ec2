"""The long tail of the reference's attention library, NCHW.

Counterpart of ``yolo_ad_refine_tpu/nn/attention_zoo.py`` (reference
nn/modules/attention.py; line references on each class). Every module keeps
its input's channels and shape, takes its input row's channels, and names
its submodules and parameters as the JAX module does, so the JAX variables
carry over (``utils/jax_weights.py``). The deformable ones sample with
``ops/deform.py _bilinear_sample`` (zero outside the map), as the JAX
modules sample with its counterpart.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolo_ad_refine_tpu_torch.nn.common import BatchNorm2d, Conv, LayerNorm2d, autopad, batch_norm
from yolo_ad_refine_tpu_torch.nn.registry import register
from yolo_ad_refine_tpu_torch.ops.deform import _bilinear_sample


def _dwconv(c: int, kh: int, kw: int, *, dilation: int = 1, pad=None, bias: bool = True):
    """Depthwise conv with torch-style explicit padding."""
    if pad is None:
        pad = (autopad(kh, None, dilation), autopad(kw, None, dilation))
    elif isinstance(pad, int):
        pad = (pad, pad)
    return nn.Conv2d(c, c, (kh, kw), padding=pad, groups=c, dilation=dilation, bias=bias)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


# channel / coordinate gates


@register
class SpatialGroupEnhance(nn.Module):
    """Group-wise spatial gating (reference attention.py:80-120). ``weight``
    and ``bias`` are (1, G, 1, 1); the JAX leaves are (1, 1, 1, G)."""

    flax_channels_last = ("weight", "bias")

    def __init__(self, c: int, groups: int = 8):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.zeros(1, groups, 1, 1))
        self.bias = nn.Parameter(torch.zeros(1, groups, 1, 1))

    def forward(self, x):
        b, c, h, w = x.shape
        g = self.groups
        xg = x.reshape(b, g, c // g, h, w)
        t = (xg * xg.mean(dim=(3, 4), keepdim=True)).sum(2).reshape(b, g, h * w)
        t = t - t.mean(dim=-1, keepdim=True)
        t = t / (t.std(dim=-1, keepdim=True, correction=0) + 1e-5)
        t = t.reshape(b, g, h, w) * self.weight + self.bias
        return (xg * torch.sigmoid(t)[:, :, None]).reshape(b, c, h, w)


@register
class EffectiveSEModule(nn.Module):
    """eSE: a single 1x1 channel gate through a hard sigmoid
    (attention.py:1052-1065)."""

    def __init__(self, c: int, add_maxpool: bool = False):
        super().__init__()
        self.add_maxpool = add_maxpool
        self.fc = nn.Conv2d(c, c, 1)

    def forward(self, x):
        se = x.mean(dim=(2, 3), keepdim=True)
        if self.add_maxpool:
            se = 0.5 * se + 0.5 * x.amax(dim=(2, 3), keepdim=True)
        return x * F.hardsigmoid(self.fc(se))


@register
class ELA(nn.Module):
    """Efficient Local Attention (attention.py:1747): one shared Conv1d(k=7)
    + GroupNorm + sigmoid on both axis pools."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1x1 = nn.Conv1d(c, c, 7, padding=3)
        self.gn = nn.GroupNorm(min(16, c), c, eps=1e-5)

    def forward(self, x):
        ah = torch.sigmoid(self.gn(self.conv1x1(x.mean(dim=3))))[..., None]
        aw = torch.sigmoid(self.gn(self.conv1x1(x.mean(dim=2))))[:, :, None, :]
        return x * ah * aw


@register
class CAA(nn.Module):
    """Context Anchor Attention, PKINet (attention.py:1765-1778)."""

    def __init__(self, c: int, h_kernel_size: int = 11, v_kernel_size: int = 11):
        super().__init__()
        self.conv1 = Conv(c, c, 1)
        self.h_conv = _dwconv(c, 1, h_kernel_size)
        self.v_conv = _dwconv(c, v_kernel_size, 1)
        self.conv2 = Conv(c, c, 1)

    def forward(self, x):
        a = F.avg_pool2d(x, 7, 1, 3)  # zero padding counted, as flax's avg_pool
        a = self.conv2(self.v_conv(self.h_conv(self.conv1(a))))
        return torch.sigmoid(a) * x


class _RectConv(nn.Module):
    """Conv (no bias) + BN + SiLU with a rectangular kernel."""

    def __init__(self, c: int, kh: int, kw: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, (kh, kw), padding=(kh // 2, kw // 2), bias=False)
        self.bn = batch_norm(c)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


@register
class MPCA(nn.Module):
    """MultiPath Coordinate Attention (attention.py:985-1009)."""

    def __init__(self, c: int):
        super().__init__()
        self.gap_conv = _RectConv(c, 1, 1)
        self.conv_hw = _RectConv(c, 3, 1)
        self.conv_pool_hw = _RectConv(c, 1, 1)

    def forward(self, x):
        h = x.shape[2]
        gap = self.gap_conv(x.mean(dim=(2, 3), keepdim=True))
        hw = self.conv_hw(torch.cat([x.mean(dim=3, keepdim=True),
                                     x.mean(dim=2)[..., None]], 2))  # (b, c, h+w, 1)
        weight = torch.sigmoid(self.conv_pool_hw(hw))
        ph = hw[:, :, :h] * weight[:, :, :h]
        pw = hw[:, :, h:] * weight[:, :, h:]
        gap = gap * weight.mean(dim=2, keepdim=True)
        return x * torch.sigmoid(ph) * torch.sigmoid(pw).transpose(2, 3) * torch.sigmoid(gap)


@register
class AFGCAttention(nn.Module):
    """Adaptive Fine-Grained Channel Attention (attention.py:1793-1823)."""

    def __init__(self, c: int, b: int = 1, gamma: int = 2):
        super().__init__()
        t = int(abs((math.log(c, 2) + b) / gamma))
        k = t if t % 2 else t + 1
        self.conv1 = nn.Conv1d(1, 1, k, padding=k // 2, bias=False)
        self.fc = nn.Linear(c, c)
        self.mix_w = nn.Parameter(torch.full((1,), -0.80))

    def forward(self, x):
        pooled = x.mean(dim=(2, 3))                        # (B, C)
        x1 = self.conv1(pooled[:, None])[:, 0]             # ECA branch
        x2 = self.fc(pooled)
        # the reference's rank-1 matmul and dim-1 sum reduce to these
        out1 = torch.sigmoid(x1.sum(-1, keepdim=True) * x2)
        out2 = torch.sigmoid(x2.sum(-1, keepdim=True) * x1)
        mixf = torch.sigmoid(self.mix_w)
        out = out1 * mixf + out2 * (1.0 - mixf)
        out = torch.sigmoid(self.conv1(out[:, None])[:, 0])
        return x * out[:, :, None, None]


# BAM


class _BAMChannel(nn.Module):
    """BAM's channel branch: Linear + BatchNorm1d (torch's eps 1e-5 and
    momentum 0.1, as the JAX module takes them) + ReLU, then ``last_fc``;
    the norms run on (B, C, 1, 1)."""

    def __init__(self, c: int, reduction: int = 16, num_layers: int = 3):
        super().__init__()
        self.n = num_layers - 1
        cr = c // reduction
        for i in range(self.n):
            self.add_module(f"fc{i}", nn.Linear(c if i == 0 else cr, cr))
            self.add_module(f"bn{i}", BatchNorm2d(cr, eps=1e-5, momentum=0.1))
        self.last_fc = nn.Linear(cr, c)

    def forward(self, x):
        v = x.mean(dim=(2, 3))
        for i in range(self.n):
            v = getattr(self, f"fc{i}")(v)
            v = torch.relu(getattr(self, f"bn{i}")(v[:, :, None, None])[:, :, 0, 0])
        return self.last_fc(v)[:, :, None, None]


class _BAMSpatial(nn.Module):
    """BAM's spatial branch: 1x1 reduce, ``num_layers`` dilated 3x3s, 1x1 to one map."""

    def __init__(self, c: int, reduction: int = 16, num_layers: int = 3, dia_val: int = 2):
        super().__init__()
        cr = c // reduction
        self.n = num_layers
        self.conv_reduce1 = nn.Conv2d(c, cr, 1)
        self.bn_reduce1 = batch_norm(cr)
        p = autopad(3, None, dia_val)
        for i in range(num_layers):
            self.add_module(f"conv_{i}", nn.Conv2d(cr, cr, 3, padding=p, dilation=dia_val))
            self.add_module(f"bn_{i}", batch_norm(cr))
        self.last_conv = nn.Conv2d(cr, 1, 1)

    def forward(self, x):
        v = torch.relu(self.bn_reduce1(self.conv_reduce1(x)))
        for i in range(self.n):
            v = torch.relu(getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(v)))
        return self.last_conv(v)


@register
class BAMBlock(nn.Module):
    """Bottleneck Attention Module (attention.py:733-760)."""

    def __init__(self, c: int, reduction: int = 16, dia_val: int = 2):
        super().__init__()
        self.sa = _BAMSpatial(c, reduction, dia_val=dia_val)
        self.ca = _BAMChannel(c, reduction)

    def forward(self, x):
        return (1.0 + torch.sigmoid(self.sa(x) + self.ca(x))) * x


# large-kernel spatial gates


@register
class LSKBlockSA(nn.Module):
    """LSK spatial gating unit on its own (attention.py:852-876)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv0 = _dwconv(c, 5, 5)
        self.conv_spatial = _dwconv(c, 7, 7, dilation=3, pad=9)
        self.conv1 = nn.Conv2d(c, c // 2, 1)
        self.conv2 = nn.Conv2d(c, c // 2, 1)
        self.conv_squeeze = nn.Conv2d(2, 2, 7, padding=3)
        self.conv = nn.Conv2d(c // 2, c, 1)

    def forward(self, x):
        a1 = self.conv0(x)
        a2 = self.conv_spatial(a1)
        a1, a2 = self.conv1(a1), self.conv2(a2)
        attn = torch.cat([a1, a2], 1)
        agg = torch.cat([attn.mean(dim=1, keepdim=True), attn.amax(dim=1, keepdim=True)], 1)
        sig = torch.sigmoid(self.conv_squeeze(agg))
        return x * self.conv(a1 * sig[:, 0:1] + a2 * sig[:, 1:2])


@register
class LSKA(nn.Module):
    """Large-Separable-Kernel-Attention (attention.py:1067-1115)."""

    # (k0, k_sp, dilation, pad_sp) by k_size: the reference's if-ladder
    CFG = {7: (3, 3, 2, 2), 11: (3, 5, 2, 4), 23: (5, 7, 3, 9),
           35: (5, 11, 3, 15), 41: (5, 13, 3, 18), 53: (5, 17, 3, 24)}

    def __init__(self, c: int, k_size: int = 7):
        super().__init__()
        k0, ksp, dil, psp = self.CFG[k_size]
        self.conv0h = _dwconv(c, 1, k0, pad=(0, k0 // 2))
        self.conv0v = _dwconv(c, k0, 1, pad=(k0 // 2, 0))
        self.conv_spatial_h = _dwconv(c, 1, ksp, dilation=dil, pad=(0, psp))
        self.conv_spatial_v = _dwconv(c, ksp, 1, dilation=dil, pad=(psp, 0))
        self.conv1 = nn.Conv2d(c, c, 1)

    def forward(self, x):
        a = self.conv_spatial_v(self.conv_spatial_h(self.conv0v(self.conv0h(x))))
        return x * self.conv1(a)


@register(name="SegNext_Attention")
class SegNextAttention(nn.Module):
    """Multi-scale strip-conv attention, SegNeXt (attention.py:1117-1149)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv0 = _dwconv(c, 5, 5)
        for i, k in enumerate((7, 11, 21)):
            self.add_module(f"conv{i}_1", _dwconv(c, 1, k, pad=(0, k // 2)))
            self.add_module(f"conv{i}_2", _dwconv(c, k, 1, pad=(k // 2, 0)))
        self.conv3 = nn.Conv2d(c, c, 1)

    def forward(self, x):
        attn = self.conv0(x)
        out = attn
        for i in range(3):
            out = out + getattr(self, f"conv{i}_2")(getattr(self, f"conv{i}_1")(attn))
        return self.conv3(out) * x


@register
class CPCA(nn.Module):
    """Channel-Prior Convolutional Attention (attention.py:927-983). The
    reference applies its one 1x1 ``conv`` three times; so does this."""

    def __init__(self, c: int, reduce: int = 4):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 1)
        self.ca_fc1 = nn.Conv2d(c, max(1, c // reduce), 1)
        self.ca_fc2 = nn.Conv2d(max(1, c // reduce), c, 1)
        self.dconv5_5 = _dwconv(c, 5, 5)
        for k in (7, 11, 21):
            self.add_module(f"dconv1_{k}", _dwconv(c, 1, k, pad=(0, k // 2)))
            self.add_module(f"dconv{k}_1", _dwconv(c, k, 1, pad=(k // 2, 0)))

    def _ca(self, v):
        return torch.sigmoid(self.ca_fc2(torch.relu(self.ca_fc1(v))))

    def forward(self, x):
        x = F.gelu(self.conv(x))
        x = x * (self._ca(x.mean(dim=(2, 3), keepdim=True)) +
                 self._ca(x.amax(dim=(2, 3), keepdim=True)))
        x0 = self.dconv5_5(x)
        out = x0
        for k in (7, 11, 21):
            out = out + getattr(self, f"dconv{k}_1")(getattr(self, f"dconv1_{k}")(x0))
        return self.conv(self.conv(out) * x)


# deformable large-kernel attention


def deform_conv_depthwise(x, offset, weight, k: int, dilation: int, padding: int):
    """torchvision's DeformConv2d with groups == channels and no bias, as
    the JAX ``_deform_conv_depthwise``: x (B, C, H, W), offset (B, 2k², H, W)
    as (dy, dx) a tap, weight (C, 1, k, k); tap (i, j) of output (y, x)
    samples (y - padding + i·dilation + dy, x - padding + j·dilation + dx)."""
    b, c, h, w = x.shape
    kk = k * k
    dev = x.device
    acc = torch.promote_types(offset.dtype, torch.float32)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=acc, device=dev),
                            torch.arange(w, dtype=acc, device=dev), indexing="ij")
    taps = torch.arange(kk, device=dev)
    tap_dy = ((taps // k) * dilation - padding).to(acc)
    tap_dx = ((taps % k) * dilation - padding).to(acc)
    off = _nhwc(offset).to(acc).reshape(b, h * w, kk, 2)
    cy = (gy.reshape(1, h * w, 1) + tap_dy + off[..., 0]).reshape(b, h * w * kk)
    cx = (gx.reshape(1, h * w, 1) + tap_dx + off[..., 1]).reshape(b, h * w * kk)
    sampled = _bilinear_sample(_nhwc(x).reshape(b, h * w, c), cy, cx, h, w)
    out = torch.einsum("bnkc,kc->bnc", sampled.reshape(b, h * w, kk, c),
                       weight.reshape(c, kk).t().to(sampled.dtype))
    return out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class DeformConvDW(nn.Module):
    """Offset conv + depthwise deformable conv (attention.py:1011-1036).
    ``weight`` is (C, 1, k, k); the JAX leaf is (k, k, C)."""

    def __init__(self, c: int, k: int = 3, padding: int = 1, dilation: int = 1):
        super().__init__()
        self.k, self.padding, self.dilation = k, padding, dilation
        self.offset_net = nn.Conv2d(c, 2 * k * k, k, padding=padding, dilation=dilation)
        self.weight = nn.Parameter(torch.empty(c, 1, k, k))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x):
        return deform_conv_depthwise(x, self.offset_net(x), self.weight, self.k, self.dilation,
                                     self.padding)


@register(name="deformable_LKA")
class DeformableLKA(nn.Module):
    """Deformable Large-Kernel Attention (attention.py:1038-1050)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv0 = DeformConvDW(c, k=5, padding=2)
        self.conv_spatial = DeformConvDW(c, k=7, padding=9, dilation=3)
        self.conv1 = nn.Conv2d(c, c, 1)

    def forward(self, x):
        return x * self.conv1(self.conv_spatial(self.conv0(x)))


# DAttention (Vision Transformer with Deformable Attention, CVPR2022)


def _grid(h: int, w: int, dtype, device):
    gy = torch.arange(h, dtype=dtype, device=device) / max(h - 1, 1) * 2 - 1
    gx = torch.arange(w, dtype=dtype, device=device) / max(w - 1, 1) * 2 - 1
    return torch.stack(torch.meshgrid(gy, gx, indexing="ij"), -1).reshape(-1, 2)


@register
class DAttention(nn.Module):
    """Deformable attention (attention.py:1161-1364) with the reference's
    four positional encodings: ``dwc_pe`` (the default), ``fixed_pe``,
    ``log_cpb`` and the grid-sampled table. The JAX module sizes the fixed
    and grid tables from its first input; here they take ``q_size`` (H, W)."""

    def __init__(self, c: int, n_heads: int = 8, n_groups: int = 4, stride: int = 1,
                 offset_range_factor: int = 4, use_pe: bool = True, dwc_pe: bool = True,
                 no_off: bool = False, fixed_pe: bool = False, log_cpb: bool = False,
                 ksize: int = 3, q_size: tuple | None = None):
        super().__init__()
        self.nh, self.ng, self.stride, self.ksize = n_heads, n_groups, stride, ksize
        self.orf, self.use_pe, self.dwc_pe = offset_range_factor, use_pe, dwc_pe
        self.no_off, self.fixed_pe, self.log_cpb = no_off, fixed_pe, log_cpb
        gc = c // n_groups
        pad = ksize // 2 if ksize != stride else 0
        self.proj_q = nn.Conv2d(c, c, 1)
        self.conv_offset_dw = nn.Conv2d(gc, gc, ksize, stride, pad, groups=gc)
        self.conv_offset_ln = LayerNorm2d(gc)
        self.conv_offset_out = nn.Conv2d(gc, 2, 1, bias=False)
        self.proj_k = nn.Conv2d(c, c, 1)
        self.proj_v = nn.Conv2d(c, c, 1)
        pe = use_pe and not no_off
        if pe and dwc_pe:
            self.rpe_dw = _dwconv(c, 3, 3)
        elif pe and log_cpb:
            self.cpb_fc1 = nn.Linear(2, 32)
            self.cpb_fc2 = nn.Linear(32, n_heads // n_groups, bias=False)
        elif pe:
            if q_size is None:
                raise ValueError("DAttention's fixed_pe and grid tables need q_size=(H, W)")
            h, w = q_size
            if fixed_pe:
                hk, wk = ((s + 2 * pad - ksize) // stride + 1 for s in (h, w))
                self.rpe_table = nn.Parameter(torch.randn(n_heads, h * w, hk * wk) * 0.01)
            else:
                self.rpe_table = nn.Parameter(torch.randn(n_heads, 2 * h - 1, 2 * w - 1) * 0.01)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        nh, ng = self.nh, self.ng
        hc, gc = c // nh, c // ng
        scale = hc ** -0.5
        acc = torch.promote_types(x.dtype, torch.float32)
        q = self.proj_q(x)
        o = F.gelu(self.conv_offset_ln(self.conv_offset_dw(q.reshape(b * ng, gc, h, w))))
        off = _nhwc(self.conv_offset_out(o)).to(acc)             # (b*g, Hk, Wk, 2) as (y, x)
        hk, wk = off.shape[1], off.shape[2]
        n_sample = hk * wk
        if self.orf >= 0 and not self.no_off:
            rng_f = torch.tensor([1.0 / max(hk - 1, 1), 1.0 / max(wk - 1, 1)], dtype=acc,
                                 device=x.device)
            off = torch.tanh(off) * rng_f * self.orf
        # the reference grid: linspace(0.5, S - 0.5) normalised to [-1, 1]
        ref_y = torch.linspace(0.5, hk - 0.5, hk, dtype=acc, device=x.device) / max(hk - 1.0, 1.0)
        ref_x = torch.linspace(0.5, wk - 0.5, wk, dtype=acc, device=x.device) / max(wk - 1.0, 1.0)
        ref = torch.stack(torch.meshgrid(ref_y * 2 - 1, ref_x * 2 - 1, indexing="ij"), -1)
        if self.no_off:
            pos = ref.expand(b * ng, hk, wk, 2)
            xs = F.avg_pool2d(x, self.stride, self.stride)
            x_sampled = xs.flatten(2).transpose(1, 2)            # (b, Ns, c)
        else:
            pos = off + ref
            if self.orf < 0:
                pos = pos.clamp(-1.0, 1.0)
            xg = _nhwc(x.reshape(b * ng, gc, h, w)).reshape(b * ng, h * w, gc)
            cy = (pos[..., 0].reshape(b * ng, n_sample) + 1) / 2 * (h - 1)
            cx = (pos[..., 1].reshape(b * ng, n_sample) + 1) / 2 * (w - 1)
            smp = _bilinear_sample(xg, cy, cx, h, w)             # (b*g, Ns, gc)
            x_sampled = smp.reshape(b, ng, n_sample, gc).transpose(1, 2).reshape(b, n_sample, c)
        xs4 = x_sampled.transpose(1, 2)[:, :, None]              # (b, c, 1, Ns)
        k = self.proj_k(xs4)[:, :, 0].transpose(1, 2)
        v = self.proj_v(xs4)[:, :, 0].transpose(1, 2)
        qf = q.flatten(2).transpose(1, 2).reshape(b, h * w, nh, hc).transpose(1, 2)
        kf = k.reshape(b, n_sample, nh, hc).transpose(1, 2)
        vf = v.reshape(b, n_sample, nh, hc).transpose(1, 2)
        attn = torch.einsum("bhnc,bhmc->bhnm", qf, kf) * scale
        residual_lepe = None
        if self.use_pe and not self.no_off:
            if self.dwc_pe:
                residual_lepe = self.rpe_dw(q)
            elif self.fixed_pe:
                attn = attn + self.rpe_table[None]
            else:
                qg = _grid(h, w, acc, x.device)
                hg = nh // ng
                if self.log_cpb:
                    disp = (qg[None, :, None, :] - pos.reshape(b * ng, n_sample, 2)[:, None]) * 4.0
                    disp = torch.sign(disp) * torch.log2(disp.abs() + 1.0) / math.log2(8.0)
                    bias = self.cpb_fc2(torch.relu(self.cpb_fc1(disp.to(x.dtype))))
                else:
                    disp = (qg[None, :, None, :] - pos.reshape(b * ng, n_sample, 2)[:, None]) * 0.5
                    tb = self.rpe_table[None].expand(b, -1, -1, -1).reshape(
                        b * ng, hg, 2 * h - 1, 2 * w - 1)
                    tb = tb.permute(0, 2, 3, 1).reshape(b * ng, (2 * h - 1) * (2 * w - 1), hg)
                    cy = (disp[..., 0].reshape(b * ng, -1) + 1) / 2 * (h * 2 - 2)
                    cx = (disp[..., 1].reshape(b * ng, -1) + 1) / 2 * (w * 2 - 2)
                    bias = _bilinear_sample(tb, cy, cx, h * 2 - 1, w * 2 - 1)
                bias = bias.reshape(b, ng, h * w, n_sample, hg).permute(0, 1, 4, 2, 3)
                attn = attn + bias.reshape(b, nh, h * w, n_sample).to(attn.dtype)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhnm,bhmc->bhnc", attn, vf)
        out = out.transpose(1, 2).reshape(b, h, w, c).permute(0, 3, 1, 2)
        if residual_lepe is not None:
            out = out + residual_lepe
        return self.proj_out(out)


# focused linear attention (window)


@register
class FocusedLinearAttention(nn.Module):
    """Window linear attention with focusing (attention.py:1385-1482):
    windows of ``split_size``, the map zero-padded at the bottom and right
    to a multiple of it."""

    def __init__(self, c: int, split_size: int = 8, num_heads: int = 8,
                 focusing_factor: int = 3, kernel_size: int = 5):
        super().__init__()
        self.ws, self.nh, self.ff = split_size, num_heads, focusing_factor
        hd = c // num_heads
        self.conv_qkv = nn.Conv2d(c, 3 * c, 1, bias=False)
        self.positional_encoding = nn.Parameter(torch.zeros(1, split_size * split_size, c))
        self.scale = nn.Parameter(torch.zeros(1, 1, c))
        self.dwc = _dwconv(hd, kernel_size, kernel_size)
        self.get_v = _dwconv(c, 3, 3)

    def forward(self, x):
        b, c, h, w = x.shape
        ws, nh = self.ws, self.nh
        hd = c // nh
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        qkv = F.pad(self.conv_qkv(x), (0, pad_r, 0, pad_b))
        ph, pw = h + pad_b, w + pad_r
        nwh, nww = ph // ws, pw // ws
        t = _nhwc(qkv).reshape(b, nwh, ws, nww, ws, 3 * c).permute(0, 1, 3, 2, 4, 5)
        q, k, v = t.reshape(b * nwh * nww, ws * ws, 3 * c).chunk(3, dim=-1)
        k = k + self.positional_encoding
        scale = F.softplus(self.scale)
        q = (torch.relu(q) + 1e-6) / scale
        k = (torch.relu(k) + 1e-6) / scale
        qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        kn = torch.linalg.vector_norm(k, dim=-1, keepdim=True)
        q = q ** self.ff
        k = k ** self.ff
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12) * qn
        k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12) * kn
        bn = q.shape[0]

        def heads(t):
            return t.reshape(bn, -1, nh, hd).transpose(1, 2).reshape(bn * nh, -1, hd)

        q, k, vh = heads(q), heads(k), heads(v)
        z = 1.0 / (torch.einsum("bic,bc->bi", q, k.sum(1)) + 1e-6)
        kv = torch.einsum("bjc,bjd->bcd", k, vh)
        out = torch.einsum("bic,bcd,bi->bid", q, kv, z)
        # a depthwise conv of each head's v window, and a lepe conv of v
        fmap = self.dwc(vh.reshape(bn * nh, ws, ws, hd).permute(0, 3, 1, 2))
        fmap = _nhwc(fmap).reshape(bn * nh, ws * ws, hd)
        lepe = _nhwc(self.get_v(v.reshape(bn, ws, ws, c).permute(0, 3, 1, 2)))
        lepe = heads(lepe.reshape(bn, ws * ws, c))
        out = (out + fmap + lepe).reshape(bn, nh, ws * ws, hd).transpose(1, 2)
        out = out.reshape(b, nwh, nww, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(b, ph, pw, c)[:, :h, :w].permute(0, 3, 1, 2)


# EfficientViT cascaded group attention


class Conv2dBN(nn.Module):
    """Conv (no bias) + BN, 'same' padding (EfficientViT's Conv2d_BN)."""

    def __init__(self, c1: int, c2: int, k: int = 1, g: int = 1, bn_weight_init: float = 1.0):
        super().__init__()
        self.c = nn.Conv2d(c1, c2, k, padding=k // 2, groups=g, bias=False)
        self.bn = batch_norm(c2)
        nn.init.constant_(self.bn.weight, bn_weight_init)

    def forward(self, x):
        return self.bn(self.c(x))


def _offset_index(res: int) -> torch.Tensor:
    """(res², res²) index of each pair's (|dy|, |dx|) in first-seen order."""
    points = list(itertools.product(range(res), range(res)))
    offs, idxs = {}, []
    for p1 in points:
        for p2 in points:
            o = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            idxs.append(offs.setdefault(o, len(offs)))
    return torch.from_numpy(np.asarray(idxs, np.int64).reshape(len(points), len(points)))


@register
class CascadedGroupAttention(nn.Module):
    """EfficientViT cascaded group attention (attention.py:1604-1680) on a
    ``resolution`` x ``resolution`` map."""

    def __init__(self, c: int, key_dim: int = 16, num_heads: int = 4, attn_ratio: int = 4,
                 resolution: int = 7, kernels=(5, 5, 5, 5)):
        super().__init__()
        self.kd, self.nhd, self.res = key_dim, num_heads, resolution
        d = c // num_heads
        for i in range(num_heads):
            self.add_module(f"qkv{i}", Conv2dBN(d, key_dim * 2 + d))
            self.add_module(f"dws{i}", Conv2dBN(key_dim, key_dim, kernels[i], g=key_dim))
        self.proj = Conv2dBN(c, c, bn_weight_init=0.0)
        # not a buffer: the JAX module has no leaf for it
        self.idx = _offset_index(resolution)
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, int(self.idx.max()) + 1))

    def forward(self, x):
        b, c, h, w = x.shape
        if (h, w) != (self.res, self.res):
            raise ValueError(f"CascadedGroupAttention at resolution {self.res} takes a map of "
                             f"{self.res} x {self.res}, not {h} x {w}")
        kd, n = self.kd, h * w
        ab = self.attention_biases[:, self.idx.to(x.device)]
        feats_in = x.chunk(self.nhd, dim=1)
        feats_out = []
        feat = feats_in[0]
        for i in range(self.nhd):
            if i > 0:
                feat = feat + feats_in[i]
            q, k, v = getattr(self, f"qkv{i}")(feat).split([kd, kd, feat.shape[1]], dim=1)
            q = getattr(self, f"dws{i}")(q)
            attn = torch.einsum("bcn,bcm->bnm", q.flatten(2), k.flatten(2)) * kd ** -0.5 + \
                ab[i].to(q.dtype)
            attn = torch.softmax(attn, dim=-1)
            feat = torch.einsum("bnm,bdm->bdn", attn, v.flatten(2)).reshape(b, -1, h, w)
            feats_out.append(feat)
        return self.proj(torch.relu(torch.cat(feats_out, 1)))


@register
class LocalWindowAttention(nn.Module):
    """EfficientViT local window attention (attention.py:1683-1745): the
    map zero-padded to windows of ``window_resolution``, each attended by
    one CascadedGroupAttention. The JAX module attends a map no larger than
    a window at its own size, with biases sized from it; the port's biases
    are sized at construction, so such a map must be the window's size."""

    def __init__(self, c: int, key_dim: int = 16, num_heads: int = 4, attn_ratio: int = 4,
                 window_resolution: int = 7, kernels=(5, 5, 5, 5)):
        super().__init__()
        self.wr = window_resolution
        self.attn = CascadedGroupAttention(c, key_dim, num_heads, attn_ratio, window_resolution,
                                           kernels)

    def forward(self, x):
        b, c, h, w = x.shape
        wr = self.wr
        if h <= wr and w <= wr and (h, w) != (wr, wr):
            raise ValueError(f"LocalWindowAttention at window {wr} takes a map of {wr} x {wr} "
                             f"or one larger than a window, not {h} x {w}")
        pad_b, pad_r = (wr - h % wr) % wr, (wr - w % wr) % wr
        xp = _nhwc(F.pad(x, (0, pad_r, 0, pad_b)))
        ph, pw = h + pad_b, w + pad_r
        nh_, nw_ = ph // wr, pw // wr
        t = xp.reshape(b, nh_, wr, nw_, wr, c).permute(0, 1, 3, 2, 4, 5)
        t = _nhwc(self.attn(_nchw(t.reshape(b * nh_ * nw_, wr, wr, c))))
        t = t.reshape(b, nh_, nw_, wr, wr, c).permute(0, 1, 3, 2, 4, 5)
        return t.reshape(b, ph, pw, c)[:, :h, :w].permute(0, 3, 1, 2)


# dual-domain selection


@register
class DualDomainSelectionMechanism(nn.Module):
    """FocalNet DSM (attention.py:1825-1878). Its GELUs are the tanh form:
    the JAX module passes ``jax.nn.gelu``, whose default is the
    approximation (the reference's FocalNet uses the exact one).
    ``la_a``, ``la_b``, ``a``, ``b`` are (1, C, 1, 1); the JAX leaves are
    (1, 1, 1, C)."""

    flax_channels_last = ("la_a", "la_b", "a", "b")

    def __init__(self, c: int):
        super().__init__()
        gelu = nn.GELU(approximate="tanh")
        self.spatial = Conv(2, 1, 3, act=False)
        self.dw1 = nn.ModuleList([Conv(c, c, 5, d=2, g=c, act=gelu), Conv(c, c, 7, d=3, g=c, act=gelu)])
        self.dw2 = Conv(c, c, 3, g=c, act=gelu)
        self.la_a = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.la_b = nn.Parameter(torch.ones(1, c, 1, 1))
        self.a = nn.Parameter(torch.zeros(1, c, 1, 1))
        self.b = nn.Parameter(torch.ones(1, c, 1, 1))

    def forward(self, x):
        sg = self.spatial(torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], 1))
        out = self.dw1[1](self.dw1[0](x)) * sg + self.dw2(x)
        out = self.la_a * (out - out.mean(dim=(2, 3), keepdim=True)) * out + self.la_b * out
        return self.a * out + self.b * x


# efficient multi-frequency attention


@register
class EfficientAttention(nn.Module):
    """CloFormer-style high / low frequency attention (attention.py:773-850)."""

    def __init__(self, c: int, num_heads: int = 8, group_split=(4, 4), kernel_sizes=(5,),
                 window_size: int = 4):
        super().__init__()
        self.hd = c // num_heads
        self.group_split, self.kernel_sizes, self.ws = tuple(group_split), tuple(kernel_sizes), window_size
        self.high = []
        cat = 0
        for i, ks in enumerate(self.kernel_sizes):
            gh = self.group_split[i]
            if gh == 0:
                continue
            cg, ch = 3 * self.hd * gh, self.hd * gh
            self.add_module(f"qkv{i}", nn.Conv2d(c, cg, 1))
            self.add_module(f"mix{i}", _dwconv(cg, ks, ks))
            self.add_module(f"attn{i}_fc1", nn.Conv2d(ch, ch, 1))
            self.add_module(f"attn{i}_fc2", nn.Conv2d(ch, ch, 1))
            self.high.append(i)
            cat += ch
        g_last = self.group_split[-1]
        if g_last:
            cq = g_last * self.hd
            self.global_q = nn.Conv2d(c, cq, 1)
            self.global_kv = nn.Conv2d(c, 2 * cq, 1)
            cat += cq
        self.proj = nn.Conv2d(cat, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        hd = self.hd
        scale = hd ** -0.5
        res = []
        for i in self.high:
            qkv = getattr(self, f"mix{i}")(getattr(self, f"qkv{i}")(x))
            q, k, v = qkv.chunk(3, dim=1)
            a = getattr(self, f"attn{i}_fc1")(q * k)
            a = getattr(self, f"attn{i}_fc2")(a * torch.sigmoid(a))  # swish
            res.append(torch.tanh(a * scale) * v)
        g_last = self.group_split[-1]
        if g_last:
            q = self.global_q(x)
            kvsrc = F.avg_pool2d(x, self.ws, self.ws) if self.ws != 1 else x
            kv = self.global_kv(kvsrc).flatten(2).transpose(1, 2)
            kv = kv.reshape(b, -1, 2, g_last, hd)
            k, v = kv[:, :, 0], kv[:, :, 1]                       # (b, HW', m, hd)
            qf = q.flatten(2).transpose(1, 2).reshape(b, h * w, g_last, hd)
            attn = torch.softmax(torch.einsum("bnmd,bkmd->bmnk", qf, k) * scale, dim=-1)
            o = torch.einsum("bmnk,bkmd->bnmd", attn, v)
            res.append(o.reshape(b, h, w, g_last * hd).permute(0, 3, 1, 2))
        return self.proj(torch.cat(res, 1))


# bi-level routing attention (BiFormer)


@register(aliases=("BiLevelRoutingAttention_nchw",))
class BiLevelRoutingAttention(nn.Module):
    """BiFormer bi-level routing attention (attention.py:206-383): the map
    zero-padded to a multiple of ``n_win`` before ``qkv`` (so its bias
    reaches the pad), window means route each query window to its
    ``topk`` key windows, attention over the gathered windows, a depthwise
    lepe conv of v, and ``wo``. Ties in the routing keep the lower window
    first, as ``lax.top_k`` orders them (a stable sort). The nchw variant of
    the reference differs only in layout and is an alias."""

    def __init__(self, c: int, num_heads: int = 8, n_win: int = 7, topk: int = 4,
                 side_dwconv: int = 3):
        super().__init__()
        self.nh, self.n_win, self.topk, self.sd = num_heads, n_win, topk, side_dwconv
        self.qkv = nn.Linear(c, 3 * c)
        if side_dwconv > 0:
            self.lepe = _dwconv(c, side_dwconv, side_dwconv)
        self.wo = nn.Linear(c, c)

    def forward(self, x):
        b, c, h_in, w_in = x.shape
        nwin = self.n_win
        pad_b, pad_r = (nwin - h_in % nwin) % nwin, (nwin - w_in % nwin) % nwin
        x = _nhwc(F.pad(x, (0, pad_r, 0, pad_b)))
        h, w = x.shape[1:3]
        wh, ww = h // nwin, w // nwin
        p2, w2 = nwin * nwin, wh * ww
        scale = c ** -0.5
        topk = min(self.topk, p2)
        qkv = self.qkv(x)
        q, kv = qkv[..., :c], qkv[..., c:]

        def win(t):
            t = t.reshape(b, nwin, wh, nwin, ww, t.shape[-1]).permute(0, 1, 3, 2, 4, 5)
            return t.reshape(b, p2, w2, -1)

        qw, kvw = win(q), win(kv)
        logit = torch.einsum("bpc,bqc->bpq", qw.mean(dim=2).detach(),
                             kvw[..., :c].mean(dim=2).detach()) * scale
        r_idx = torch.sort(logit, dim=-1, descending=True, stable=True).indices[..., :topk]
        gat = kvw[torch.arange(b, device=x.device)[:, None, None], r_idx]  # (b, p2, k, w2, 2c)
        gat = gat.reshape(b, p2, topk * w2, 2 * c)
        nh = self.nh
        hd = c // nh
        qh = qw.reshape(b, p2, w2, nh, hd)
        kh = gat[..., :c].reshape(b, p2, topk * w2, nh, hd)
        vh = gat[..., c:].reshape(b, p2, topk * w2, nh, hd)
        attn = torch.softmax(torch.einsum("bpnhd,bpmhd->bphnm", qh * scale, kh), dim=-1)
        out = torch.einsum("bphnm,bpmhd->bpnhd", attn, vh).reshape(b, nwin, nwin, wh, ww, c)
        out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
        if self.sd > 0:
            out = out + _nhwc(self.lepe(_nchw(kv[..., c:])))
        return _nchw(self.wo(out)[:, :h_in, :w_in])
