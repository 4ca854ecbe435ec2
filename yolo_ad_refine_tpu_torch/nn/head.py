"""Heads: stock Detect, Segment, Pose, the oriented-box OBB, YOLOv10's
v10Detect, YOLO-World's WorldDetect, Classify and the fork's AYHead.

Counterpart of ``yolo_ad_refine_tpu/nn/head.py`` (reference
ultralytics/nn/modules/head.py: Detect:21-163, Segment:164-186,
Pose:219-258, OBB:189-217, v10Detect:564, WorldDetect:279, Classify:259,
block.py Proto, ContrastiveHead:526, BNContrastiveHead:549,
TaskDecomposition:626, CoordAtt:671, CrossTaskInteraction:722, DyDCNv2:751,
Scale:783, ResidualBlockGN:1031, AYHead(1):1049-1252). Train forward returns
the per-level raw maps; eval returns ``(y, feats)`` with ``y`` (B, N, 4+nc):
xywh boxes in input pixels and sigmoided class scores (OBB appends its
angle, Segment its mask coefficients, Pose its decoded keypoints).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from yolo_ad_refine_tpu_torch.nn.common import Conv, ConvGN, autocast_off, batch_norm, dfl_decode
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


def detect_branches(nc: int, ch, reg_max: int = 16) -> tuple[nn.ModuleList, nn.ModuleList]:
    """Detect's per-level box branch ``cv2.i`` (Conv 3x3, Conv 3x3, 1x1 to
    4 * reg_max) and class branch ``cv3.i`` (two depthwise 3x3 + 1x1 pairs,
    1x1 to nc)."""
    c2 = max(16, ch[0] // 4, reg_max * 4)
    c3 = max(ch[0], min(nc, 100))
    cv2 = nn.ModuleList(
        nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1)) for x in ch)
    cv3 = nn.ModuleList(
        nn.Sequential(nn.Sequential(Conv(x, x, 3, g=x), Conv(x, c3, 1)),
                      nn.Sequential(Conv(c3, c3, 3, g=c3), Conv(c3, c3, 1)),
                      nn.Conv2d(c3, nc, 1))
        for x in ch)
    return cv2, cv3


def init_branch_biases(cv2, cv3, nc: int, strides) -> None:
    """The box biases 1 and the class prior log(5 / nc / (640 / s)^2)."""
    for i, (a, b) in enumerate(zip(cv2, cv3)):
        a[-1].bias.data.fill_(1.0)
        b[-1].bias.data.fill_(math.log(5 / nc / (640 / strides[i]) ** 2))


def _strides(feats, input_h, default):
    return tuple(input_h // f.shape[2] for f in feats) if input_h is not None else default


@register
class Detect(nn.Module):
    """Stock YOLO11 anchor-free detect head (reference head.py:21-163)."""

    def __init__(self, nc: int = 80, ch=(), reg_max: int = 16, strides=(8, 16, 32)):
        super().__init__()
        self.nc, self.reg_max, self.strides = nc, reg_max, tuple(strides)
        self.cv2, self.cv3 = detect_branches(nc, ch, reg_max)

    def bias_init(self):
        init_branch_biases(self.cv2, self.cv3, self.nc, self.strides)

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


class Proto(nn.Module):
    """Mask prototypes (reference block.py Proto): Conv 3x3, a learned 2x
    upsample (ConvTranspose 2x2 stride 2), Conv 3x3, Conv 1x1 to ``c2``."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2, 1)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


def extra_branch(ch, c4: int, out_ch: int) -> nn.ModuleList:
    """The per-level ``cv4.i`` branch of Segment / Pose / OBB: Conv 3x3,
    Conv 3x3, 1x1 to ``out_ch`` (the JAX ``_extra_branch``)."""
    return nn.ModuleList(
        nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3), nn.Conv2d(c4, out_ch, 1)) for x in ch)


def flat_branch(branch: nn.ModuleList, xs) -> torch.Tensor:
    """The levels' (B, out_ch, H, W) outputs of ``branch`` flattened to
    (B, A, out_ch), anchors in the order of ``decode_detections``."""
    b = xs[0].shape[0]
    return torch.cat([m(x).reshape(b, m[-1].out_channels, -1) for m, x in zip(branch, xs)],
                     2).transpose(1, 2)


@register
class Segment(Detect):
    """Segmentation head (reference head.py:164-186): Detect plus the mask
    coefficients ``cv4.i`` (``nm`` a level) and Proto on the first level.
    Train returns (feats, mc, proto); eval returns (cat(y, mc), (feats, mc,
    proto)) with mc (B, A, nm) and proto (B, nm, H/4, W/4)."""

    def __init__(self, nc: int = 80, nm: int = 32, npr: int = 256, ch=(), reg_max: int = 16,
                 strides=(8, 16, 32)):
        super().__init__(nc, ch, reg_max, strides)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        self.cv4 = extra_branch(ch, max(ch[0] // 4, nm), nm)

    def forward(self, xs, input_h: int | None = None):
        p = self.proto(xs[0])
        mc = flat_branch(self.cv4, xs)
        feats = self.maps(xs)
        if self.training:
            return feats, mc, p
        y = decode_detections(feats, _strides(feats, input_h, self.strides), self.nc,
                              self.reg_max)
        return torch.cat([y, mc.to(y.dtype)], -1), (feats, mc, p)


@register
class Pose(Detect):
    """Keypoint head (reference head.py:219-258): Detect plus the per-level
    keypoint branch ``cv4.i`` (K * ndim a level). Train returns (feats,
    kpt) with kpt (B, A, K * ndim) raw; eval appends the keypoints decoded
    as (k * 2 + anchor - 0.5) * stride in fp32, the visibility sigmoided
    when ndim is 3, and returns (cat(y, kpts), (feats, kpt))."""

    def __init__(self, nc: int = 1, kpt_shape=(17, 3), ch=(), reg_max: int = 16,
                 strides=(8, 16, 32)):
        super().__init__(nc, ch, reg_max, strides)
        self.kpt_shape = tuple(int(v) for v in kpt_shape)
        nk = self.kpt_shape[0] * self.kpt_shape[1]
        self.cv4 = extra_branch(ch, max(ch[0] // 4, nk), nk)

    def forward(self, xs, input_h: int | None = None):
        kpt = flat_branch(self.cv4, xs)
        feats = self.maps(xs)
        if self.training:
            return feats, kpt
        strides = _strides(feats, input_h, self.strides)
        y = decode_detections(feats, strides, self.nc, self.reg_max)
        anchors, stride_t = make_anchors([(f.shape[2], f.shape[3]) for f in feats], strides, 0.5,
                                         device=kpt.device)
        b, a = kpt.shape[:2]
        k = kpt.float().reshape(b, a, *self.kpt_shape)
        xy = (k[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) * stride_t[None, :, None, :]
        if self.kpt_shape[1] == 3:
            xy = torch.cat([xy, torch.sigmoid(k[..., 2:3])], -1)
        return torch.cat([y, xy.reshape(b, a, -1).to(y.dtype)], -1), (feats, kpt)


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
        self.cv4 = extra_branch(ch, max(ch[0] // 4, ne), ne)

    def forward(self, xs, input_h: int | None = None):
        b = xs[0].shape[0]
        angle = (torch.sigmoid(flat_branch(self.cv4, xs).float()) - 0.25) * math.pi  # (B, A, ne)
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


def v10_select(y, max_det: int = 300):
    """YOLOv10's NMS-free selection (the JAX v10Detect's eval tail, reference
    v10postprocess): the top ``max_det`` anchors by their best class score,
    by a stable descending sort, which keeps ``jax.lax.top_k``'s tie order
    (lower index first). y (B, N, 4+nc) -> (B, min(max_det, N), 6): xywh
    in input pixels, the score, the class (the first maximum)."""
    scores = y[..., 4:].amax(-1)
    k = min(max_det, scores.shape[-1])
    top_s, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_s, idx = top_s[:, :k], idx[:, :k]
    rows = torch.gather(y, 1, idx[..., None].expand(-1, -1, y.shape[-1]))
    cls = rows[..., 4:].argmax(-1)
    return torch.cat([rows[..., :4], top_s[..., None], cls[..., None].to(y.dtype)], -1)


@register
class v10Detect(Detect):
    """YOLOv10 end-to-end head (reference head.py:564): Detect's branches
    (one-to-many) and a second set ``cv2_one2one`` / ``cv3_one2one`` on the
    detached inputs (one-to-one), so that no one-to-one loss reaches the
    backbone. Train returns {"one2many": maps, "one2one": maps}; eval returns
    (det, that dict), det (B, min(max_det, N), 6) from the one-to-one
    decode by ``v10_select``: no NMS."""

    def __init__(self, nc: int = 80, ch=(), reg_max: int = 16, strides=(8, 16, 32),
                 max_det: int = 300):
        super().__init__(nc, ch, reg_max, strides)
        self.max_det = max_det
        self.cv2_one2one, self.cv3_one2one = detect_branches(nc, ch, reg_max)

    def bias_init(self):
        super().bias_init()
        init_branch_biases(self.cv2_one2one, self.cv3_one2one, self.nc, self.strides)

    def forward(self, xs, input_h: int | None = None):
        one2one = [torch.cat([a(x.detach()), b(x.detach())], 1)
                   for a, b, x in zip(self.cv2_one2one, self.cv3_one2one, xs)]
        feats = {"one2many": self.maps(xs), "one2one": one2one}
        if self.training:
            return feats
        y = decode_detections(one2one, _strides(one2one, input_h, self.strides), self.nc,
                              self.reg_max)
        return v10_select(y, self.max_det), feats


class ContrastiveHead(nn.Module):
    """Image-text scores (reference block.py:526): the L2-normalised
    embedding against the normalised text rows, times exp(logit_scale),
    plus bias."""

    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.tensor([-10.0]))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def normalise(self, e):
        return e / (e.norm(dim=1, keepdim=True) + 1e-12)

    def forward(self, e, text):
        """e (B, E, H, W), text (nc, E) normalised, both fp32 -> (B, nc, H, W)."""
        return torch.einsum("behw,ce->bchw", self.normalise(e), text) * \
            self.logit_scale.exp() + self.bias


class BNContrastiveHead(ContrastiveHead):
    """ContrastiveHead whose BatchNorm replaces the L2 norm of the embedding
    (reference block.py:549): the port's BatchNorm (biased variance, eps
    1e-3), logit_scale starting at -1."""

    def __init__(self, embed: int = 512):
        super().__init__()
        self.norm = batch_norm(embed)
        self.logit_scale.data.fill_(-1.0)

    def normalise(self, e):
        return self.norm(e)


@register
class WorldDetect(nn.Module):
    """Open-vocabulary head (reference head.py:279): Detect's box branch
    ``cv2.i``, an embedding branch ``cv3.i`` (Conv 3x3, Conv 3x3, 1x1 to
    ``embed``) and the per-level contrastive head ``cv4.i`` (BNContrastiveHead
    with ``with_bn``, else ContrastiveHead) scoring against the class text
    embeddings ``text_feats`` (nc, embed), in fp32. The class count of the
    output follows the text rows (after ``set_classes``, fewer or more than
    ``nc``). Without text embeddings the learned ``default_text`` (nc,
    embed) stands in; it exists only where ``default_text`` is asked for, as
    the JAX head creates it only when it is first called without text (a
    graph with C2fAttn rows always has text). Train returns the per-level
    maps, eval (y, maps)."""

    def __init__(self, nc: int = 80, embed: int = 512, with_bn: bool = True, ch=(),
                 reg_max: int = 16, strides=(8, 16, 32), default_text: bool = False):
        super().__init__()
        self.nc, self.embed, self.reg_max, self.strides = nc, embed, reg_max, tuple(strides)
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1))
            for x in ch)
        self.cv3 = nn.ModuleList(
            nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), nn.Conv2d(c3, embed, 1)) for x in ch)
        self.cv4 = nn.ModuleList(BNContrastiveHead(embed) if with_bn else ContrastiveHead()
                                 for _ in ch)
        self.default_text = (nn.Parameter(torch.randn(nc, embed) * 0.02) if default_text
                             else None)

    def bias_init(self):
        for a in self.cv2:
            a[-1].bias.data.fill_(1.0)

    def forward(self, xs, text_feats=None, input_h: int | None = None):
        t = self.default_text if text_feats is None else text_feats
        if t is None:
            raise ValueError("WorldDetect needs text embeddings: call set_classes(names) on "
                             "the YOLO facade or pass text_feats")
        with autocast_off(xs[0]):
            t = t.to(xs[0].device, torch.float32)
            t = t / (t.norm(dim=-1, keepdim=True) + 1e-12)
        outputs = []
        for box, emb, head, x in zip(self.cv2, self.cv3, self.cv4, xs):
            r = box(x)
            e = emb(x)
            with autocast_off(x):
                logits = head(e.float(), t)
            outputs.append(torch.cat([r, logits.to(r.dtype)], 1))
        if self.training:
            return outputs
        y = decode_detections(outputs, _strides(outputs, input_h, self.strides), t.shape[0],
                              self.reg_max)
        return y, outputs


@register
class Classify(nn.Module):
    """Classification head (reference head.py:259): Conv 1x1 to ``c_``,
    global average pool, Dropout, Linear. Train returns the logits (fp32),
    eval the softmax probabilities."""

    def __init__(self, c1: int, nc: int = 1000, c_: int = 1280, dropout: float = 0.0):
        super().__init__()
        self.conv = Conv(c1, c_, 1, 1)
        self.drop = nn.Dropout(dropout)
        self.linear = nn.Linear(c_, nc)

    def forward(self, x, input_h: int | None = None):
        logits = self.linear(self.drop(self.conv(x).mean(dim=(2, 3)))).float()
        return logits if self.training else torch.softmax(logits, -1)


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
