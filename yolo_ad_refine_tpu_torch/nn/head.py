"""Detection heads: stock Detect, the oriented-box OBB and the fork's AYHead.

Counterpart of ``yolo_ad_refine_tpu/nn/head.py`` (reference
ultralytics/nn/modules/head.py: Detect:21-163, OBB:189-217,
TaskDecomposition:626, CoordAtt:671, CrossTaskInteraction:722, DyDCNv2:751,
Scale:783, ResidualBlockGN:1031, AYHead(1):1049-1252). Train forward returns
the per-level raw maps; eval returns ``(y, feats)`` with ``y`` (B, N, 4+nc):
xywh boxes in input pixels and sigmoided class scores (OBB appends its
angle).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from yolo_ad_refine_tpu_torch.nn.common import Conv, ConvGN, batch_norm, dfl_decode
from yolo_ad_refine_tpu_torch.nn.registry import register
from yolo_ad_refine_tpu_torch.ops.anchors import dist2bbox, make_anchors
from yolo_ad_refine_tpu_torch.ops.deform import dcn_impl


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


@register
class Detect(nn.Module):
    """Stock YOLO11 anchor-free detect head (reference head.py:21-163)."""

    def __init__(self, nc: int = 80, ch=(), reg_max: int = 16, strides=(8, 16, 32)):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1))
            for x in ch)
        self.cv3 = nn.ModuleList(
            nn.Sequential(nn.Sequential(Conv(x, x, 3, g=x), Conv(x, c3, 1)),
                          nn.Sequential(Conv(c3, c3, 3, g=c3), Conv(c3, c3, 1)),
                          nn.Conv2d(c3, nc, 1))
            for x in ch)

    def bias_init(self):
        for i, (a, b) in enumerate(zip(self.cv2, self.cv3)):
            a[-1].bias.data.fill_(1.0)
            b[-1].bias.data.fill_(math.log(5 / self.nc / (640 / self.strides[i]) ** 2))

    def maps(self, xs):
        """Per-level raw (B, 4*reg_max + nc, H, W) maps."""
        return [torch.cat([self.cv2[i](x), self.cv3[i](x)], 1) for i, x in enumerate(xs)]

    def forward(self, xs, input_h: int | None = None):
        outputs = self.maps(xs)
        if self.training:
            return outputs
        y = decode_detections(outputs, _strides(outputs, input_h, self.strides), self.nc,
                              self.reg_max)
        return y, outputs


def dist2rbox(distance, angle, anchor_points):
    """Rotated boxes (cx, cy, w, h) from lt / rb distances turned by
    ``angle`` around their anchors (reference utils/tal.py dist2rbox)."""
    lt, rb = distance.chunk(2, dim=-1)
    cos, sin = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    xf_yf = (rb - lt) / 2
    x = xf_yf[..., 0:1] * cos - xf_yf[..., 1:2] * sin
    y = xf_yf[..., 0:1] * sin + xf_yf[..., 1:2] * cos
    return torch.cat([torch.cat([x, y], -1) + anchor_points, lt + rb], -1)


@register
class OBB(Detect):
    """Oriented-box head (reference head.py:189-217): Detect plus a per-level
    angle branch ``cv4.i`` (Conv 3x3, Conv 3x3, 1x1 to ``ne``). The angle is
    (sigmoid(logit) - 0.25) * pi in fp32, in [-pi/4, 3pi/4). Train returns
    (feats, angle); eval returns (y, (feats, angle)) with y (B, N, 4+nc+ne):
    rotated xywh in input pixels, sigmoided scores, the angle."""

    def __init__(self, nc: int = 80, ne: int = 1, ch=(), reg_max: int = 16,
                 strides=(8, 16, 32)):
        super().__init__(nc, ch, reg_max, strides)
        self.ne = ne
        c4 = max(ch[0] // 4, ne)
        self.cv4 = nn.ModuleList(
            nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3), nn.Conv2d(c4, ne, 1)) for x in ch)

    def forward(self, xs, input_h: int | None = None):
        b = xs[0].shape[0]
        logits = torch.cat([self.cv4[i](x).reshape(b, self.ne, -1) for i, x in enumerate(xs)], 2)
        angle = ((torch.sigmoid(logits.float()) - 0.25) * math.pi).transpose(1, 2)  # (B, A, ne)
        feats = self.maps(xs)
        if self.training:
            return feats, angle
        no = 4 * self.reg_max + self.nc
        x_cat = torch.cat([f.reshape(b, no, -1) for f in feats], dim=2).transpose(1, 2)
        box, cls = x_cat[..., : 4 * self.reg_max], x_cat[..., 4 * self.reg_max:]
        anchors, stride_t = make_anchors([(f.shape[2], f.shape[3]) for f in feats],
                                         _strides(feats, input_h, self.strides), 0.5,
                                         device=x_cat.device)
        dist = dfl_decode(box, self.reg_max)
        rbox = dist2rbox(dist, angle[..., 0], anchors[None]) * stride_t[None]
        y = torch.cat([rbox, torch.sigmoid(cls.float()), angle], dim=-1)
        return y, (feats, angle)


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
    into the DCN implementation ``dcn(x, offset, mask, weight, radius)``
    that DyDCNv2 picked (stands in for mmcv's ModulatedDeformConv2d)."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c2, c1, 3, 3))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x, offset, mask, dcn, radius: int | None):
        if torch.is_autocast_enabled(x.device.type):  # a conv: runs in the autocast type
            x = x.to(torch.get_autocast_dtype(x.device.type)).contiguous(
                memory_format=torch.channels_last)
        return dcn(x, offset, mask, self.weight, radius)


class DyDCNv2(nn.Module):
    """Modulated deformable conv 3x3 + GroupNorm(16) (reference head.py:751-782).

    Each forward picks its implementation through ``ops/deform.py
    dcn_impl``, from ``YAT_DCN_IMPL`` and ``YAT_DCN_RADIUS`` as the JAX
    module does at each trace (its nn/head.py:517-523): by default
    (``auto``, ``exact``) K1 samples unbounded, as the reference's mmcv
    kernel and the JAX package off the TPU do; ``mxu2`` runs K1, ``mxu`` K2
    and ``pallas`` K3, each clipping the offsets at ``radius``
    (``YAT_DCN_RADIUS`` overrides it)."""

    def __init__(self, c1: int, c2: int, radius: float = 3.0):
        super().__init__()
        self.radius = radius
        self.conv = ModulatedDeformConv(c1, c2)
        self.norm = nn.GroupNorm(16, c2, eps=1e-5)

    def forward(self, x, offset, mask):
        dcn, radius = dcn_impl(self.radius)
        return self.norm(self.conv(x, offset, mask, dcn, radius))


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


@register(name="AYHead", aliases=("AYHead1",))
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
