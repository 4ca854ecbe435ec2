"""Transformer modules of RT-DETR: the AIFI encoder and the deformable decoder.

Counterpart of ``yolo_ad_refine_tpu/nn/transformer.py`` (reference
ultralytics/nn/modules/transformer.py: AIFI:86, MLP:175, MSDeformAttn:218,
DeformableTransformerDecoderLayer:318; head.py:333 RTDETRDecoder). Module
and parameter names follow the JAX modules, so ``utils/jax_weights.py``
carries their variables across: ``MHA.mha`` is the flax
MultiHeadDotProductAttention, the decoder's layers and heads sit in
``decoder_layers.i``, ``dec_bbox_head.i`` and ``dec_score_head.i``, and the
denoising class embedding is the decoder's own ``denoising_class_embed``.

The multiscale deformable attention samples with the port's plain
bilinear sampler (``ops/deform.py _bilinear_sample``: zero outside the map,
half-pixel centres, ``align_corners=False``), as the JAX module does; it is
no Pallas kernel there. The decoder's query selection keeps ``lax.top_k``'s
order among tied scores (the lower index first) through a stable sort.
Invalid anchors keep their +inf logits, so their boxes are exactly 1.0.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolo_ad_refine_tpu_torch.nn.common import batch_norm
from yolo_ad_refine_tpu_torch.nn.registry import register
from yolo_ad_refine_tpu_torch.ops.deform import _bilinear_sample


def _up(t):
    """``t`` in fp32 where the JAX module casts to fp32 (bf16 under
    autocast), kept in fp64 for fp64 inputs (the tests' reference)."""
    return t if t.dtype == torch.float64 else t.float()


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def sincos_2d(w: int, h: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
    """The 2D sine-cosine position embedding (1, h*w, dim) of the JAX AIFI:
    its grid is ``meshgrid(w, h, indexing="ij")`` flattened w-major, while
    the tokens are (h, w) row-major, as in the reference."""
    assert dim % 4 == 0
    grid_w, grid_h = np.meshgrid(np.arange(w, dtype=np.float32),
                                 np.arange(h, dtype=np.float32), indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / temperature ** (np.arange(pos_dim, dtype=np.float32) / pos_dim)
    out_w = grid_w.flatten()[:, None] @ omega[None]
    out_h = grid_h.flatten()[:, None] @ omega[None]
    return np.concatenate([np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)],
                          axis=1)[None]


class MHA(nn.Module):
    """Multi-head attention over (B, T, C) tokens. ``attn_blocked`` (T, T)
    bool is True where attention is blocked (the flax module's mask is
    its negation)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.mha = nn.MultiheadAttention(dim, num_heads, batch_first=True)

    def forward(self, q, k, v, attn_blocked=None):
        return self.mha(q, k, v, attn_mask=attn_blocked, need_weights=False)[0]


@register
class AIFI(nn.Module):
    """Intra-scale feature interaction on P5 (reference transformer.py:86):
    one post-norm encoder layer with exact GELU, LayerNorm eps 1e-5."""

    def __init__(self, c1: int, cm: int = 2048, num_heads: int = 8):
        super().__init__()
        self.ma = MHA(c1, num_heads)
        self.norm1 = nn.LayerNorm(c1, eps=1e-5)
        self.fc1 = nn.Linear(c1, cm)
        self.fc2 = nn.Linear(cm, c1)
        self.norm2 = nn.LayerNorm(c1, eps=1e-5)
        self._pos: dict = {}

    def forward(self, x):
        b, c, h, w = x.shape
        key = (h, w, x.device, x.dtype)
        if key not in self._pos:
            self._pos[key] = torch.from_numpy(sincos_2d(w, h, c)).to(x.device, x.dtype)
        src = x.flatten(2).transpose(1, 2)  # (B, h*w, C), (h, w) row-major
        q = src + self._pos[key]
        src = self.norm1(src + self.ma(q, q, src))
        src = self.norm2(src + self.fc2(F.gelu(self.fc1(src))))
        return src.transpose(1, 2).reshape(b, c, h, w)


class MLP(nn.Module):
    """``num_layers`` Linear layers with ReLU between them (reference
    transformer.py:175)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def ms_deformable_attention(value, value_shapes, sampling_locations, attention_weights):
    """The multiscale deformable attention core (reference
    nn/modules/utils.py:42): value (B, V, nh, d), sampling_locations (B, Q,
    nh, L, P, 2) in [0, 1], attention_weights (B, Q, nh, L, P). Each level
    is sampled bilinearly with zero padding at half-pixel centres and the
    samples are summed with their weights in fp32 (fp64 for fp64 locations).
    Returns (B, Q, nh*d)."""
    b, _, nh, d = value.shape
    q, n_points = sampling_locations.shape[1], sampling_locations.shape[4]
    acc = _up(sampling_locations).dtype
    out = torch.zeros((b, q, nh, d), dtype=acc, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(value_shapes):
        val = value[:, start:start + h * w].transpose(1, 2).reshape(b * nh, h * w, d)
        start += h * w
        loc = sampling_locations[:, :, :, lvl].transpose(1, 2).reshape(b * nh, q * n_points, 2)
        sampled = _bilinear_sample(val, loc[..., 1] * h - 0.5, loc[..., 0] * w - 0.5, h, w)
        sampled = sampled.reshape(b, nh, q, n_points, d)
        wts = attention_weights[:, :, :, lvl].transpose(1, 2)  # (B, nh, Q, P)
        out = out + torch.einsum("bhqpd,bhqp->bqhd", sampled.to(acc), wts.to(acc))
    return out.reshape(b, q, nh * d)


def msda_offset_bias(nh: int, nl: int, npts: int) -> torch.Tensor:
    """The sampling offsets' initial bias: each head's direction on the unit
    square, scaled by the point's index + 1 (reference
    MSDeformAttn._reset_parameters)."""
    thetas = np.arange(nh, dtype=np.float32) * (2.0 * np.pi / nh)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(nh, 1, 1, 2), (1, nl, npts, 1))
    for i in range(npts):
        grid[:, :, i, :] *= i + 1
    return torch.from_numpy(grid.reshape(-1).astype(np.float32))


class MSDeformAttn(nn.Module):
    """Multiscale deformable attention (reference transformer.py:218)."""

    def __init__(self, d_model: int = 256, n_levels: int = 3, n_heads: int = 8,
                 n_points: int = 4):
        super().__init__()
        self.nh, self.nl, self.npts = n_heads, n_levels, n_points
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_model, d_model)

    def bias_init(self):
        """The offsets' direction grid and zero kernels, as the JAX module
        initialises them."""
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(msda_offset_bias(self.nh, self.nl, self.npts))
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()

    def forward(self, query, refer_bbox, value, value_shapes):
        """query (B, Q, C); refer_bbox (B, Q, L, 4) in [0, 1]; value (B, V, C)."""
        b, q = query.shape[:2]
        nh, nl, npts = self.nh, self.nl, self.npts
        v = self.value_proj(value).reshape(b, value.shape[1], nh, -1)
        offsets = _up(self.sampling_offsets(query).reshape(b, q, nh, nl, npts, 2))
        weights = torch.softmax(_up(self.attention_weights(query).reshape(b, q, nh, nl * npts)),
                                dim=-1).reshape(b, q, nh, nl, npts)
        rb = _up(refer_bbox)
        if rb.shape[-1] == 4:
            add = offsets / npts * rb[:, :, None, :, None, 2:] * 0.5
            locations = rb[:, :, None, :, None, :2] + add
        else:
            norm = torch.tensor([[wd, ht] for ht, wd in value_shapes], dtype=rb.dtype,
                                device=rb.device)
            locations = rb[:, :, None, :, None, :] + offsets / norm[None, None, None, :, None, :]
        out = ms_deformable_attention(v, value_shapes, locations, weights)
        return self.output_proj(out.to(query.dtype))


class DeformableDecoderLayer(nn.Module):
    """Self-attention, deformable cross-attention and FFN, each post-norm
    (reference transformer.py:318)."""

    def __init__(self, d_model: int = 256, n_heads: int = 8, d_ffn: int = 1024,
                 n_levels: int = 3, n_points: int = 4):
        super().__init__()
        self.n_levels = n_levels
        self.self_attn = MHA(d_model, n_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, embed, refer_bbox, feats, shapes, query_pos=None, attn_blocked=None):
        q = embed if query_pos is None else embed + query_pos
        embed = self.norm1(embed + self.self_attn(q, q, embed, attn_blocked))
        tgt = self.cross_attn(embed if query_pos is None else embed + query_pos,
                              refer_bbox[:, :, None, :].expand(-1, -1, self.n_levels, -1),
                              feats, shapes)
        embed = self.norm2(embed + tgt)
        return self.norm3(embed + self.linear2(F.relu(self.linear1(embed))))


def decoder_anchors(shapes, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The anchors' logits (1, V, 4), +inf where an anchor lies within 0.01
    of the border, and their validity (1, V, 1) as 0 / 1, from the levels'
    (h, w) on the host (reference RTDETRDecoder._generate_anchors)."""
    anchors = []
    for i, (h, w) in enumerate(shapes):
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                             indexing="ij")
        xy = (np.stack([gx, gy], -1) + 0.5) / np.asarray([w, h], np.float32)
        wh = np.ones_like(xy) * 0.05 * (2.0 ** i)
        anchors.append(np.concatenate([xy, wh], -1).reshape(-1, 4))
    anchors = np.concatenate(anchors)
    valid = ((anchors > 1e-2) & (anchors < 1 - 1e-2)).all(-1, keepdims=True)
    with np.errstate(divide="ignore"):
        logit = np.log(anchors / (1 - anchors))
    logit[~np.repeat(valid, 4, axis=1)] = np.inf
    return (torch.from_numpy(logit)[None].to(device),
            torch.from_numpy(valid.astype(np.float32))[None].to(device))


@register
class RTDETRDecoder(nn.Module):
    """RT-DETR's decoder head (reference head.py:333-560, JAX
    nn/transformer.py:225): the levels' 1x1 projections, anchor query
    selection of the ``nq`` best encoder scores, and ``ndl`` deformable
    decoder layers with iterative box refinement.

    Train returns (dec_bboxes (ndl, B, T, 4), dec_scores (ndl, B, T, nc),
    enc_bboxes (B, nq, 4), enc_scores (B, nq, nc)); eval returns (y, that
    tuple) with y (B, nq, 4 + nc): normalised xywh and sigmoided scores of
    the last layer. ``dn`` (train only; ``train/rtdetr.py
    make_cdn_group``): {"cls" (B, ndn), "bbox_logit" (B, ndn, 4), "valid"
    (B, ndn), "attn_blocked" (T, T) True = blocked}; its queries are put
    before the selected ones, T = ndn + nq. The values are the same in
    train and eval; the gradient stops where the JAX module's does."""

    def __init__(self, nc: int = 80, ch=(512, 1024, 2048), hd: int = 256, nq: int = 300,
                 ndp: int = 4, nh: int = 8, ndl: int = 6, d_ffn: int = 1024,
                 eval_idx: int = -1):
        super().__init__()
        self.nc, self.hd, self.nq, self.ndl = nc, hd, nq, ndl
        self.eval_idx = eval_idx if eval_idx >= 0 else ndl + eval_idx
        nl = len(ch)
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, hd, 1, bias=False), batch_norm(hd)) for c in ch)
        self.enc_output = nn.Sequential(nn.Linear(hd, hd), nn.LayerNorm(hd, eps=1e-5))
        self.enc_score_head = nn.Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, 3)
        self.denoising_class_embed = nn.Parameter(torch.zeros(nc, hd))
        self.query_pos_head = MLP(4, 2 * hd, hd, 2)
        self.decoder_layers = nn.ModuleList(
            DeformableDecoderLayer(hd, nh, d_ffn, nl, ndp) for _ in range(ndl))
        self.dec_bbox_head = nn.ModuleList(MLP(hd, hd, 4, 3) for _ in range(ndl))
        self.dec_score_head = nn.ModuleList(nn.Linear(hd, nc) for _ in range(ndl))
        self._anchors: dict = {}

    def bias_init(self):
        """The score heads' class prior, -log(99) / 80 * nc as in the JAX
        module (reference bias_init_with_prob(0.01) / 80 * nc)."""
        with torch.no_grad():
            prior = -math.log((1 - 0.01) / 0.01) / 80 * self.nc
            for head in (self.enc_score_head, *self.dec_score_head):
                head.bias.fill_(prior)

    def anchors(self, shapes, device):
        key = (tuple(shapes), device)
        if key not in self._anchors:
            self._anchors[key] = decoder_anchors(shapes, device)
        return self._anchors[key]

    def forward(self, xs, input_h: int | None = None, dn: dict | None = None):
        b = xs[0].shape[0]
        feats, shapes = [], []
        for proj, x in zip(self.input_proj, xs):
            p = proj(x)
            shapes.append((p.shape[2], p.shape[3]))
            feats.append(p.flatten(2).transpose(1, 2))
        feats = torch.cat(feats, 1)  # (B, V, hd)
        anchors, valid = self.anchors(shapes, feats.device)

        enc = self.enc_output(feats * valid.to(feats.dtype))
        enc_scores_all = self.enc_score_head(enc)  # (B, V, nc)
        # lax.top_k's order: descending, the lower index first among ties
        order = torch.sort(enc_scores_all.max(-1).values, dim=-1, descending=True,
                           stable=True).indices[:, :self.nq]
        top_feats = torch.gather(enc, 1, order[..., None].expand(-1, -1, enc.shape[-1]))
        top_anchors = torch.gather(anchors.expand(b, -1, -1), 1, order[..., None].expand(-1, -1, 4))
        refer_logit = self.enc_bbox_head(top_feats) + top_anchors
        enc_bboxes = torch.sigmoid(refer_logit)
        enc_scores = torch.gather(enc_scores_all, 1,
                                  order[..., None].expand(-1, -1, enc_scores_all.shape[-1]))

        train = self.training
        embed = top_feats
        if train:
            embed, refer_logit = embed.detach(), refer_logit.detach()
        attn_blocked = None
        if dn is not None and train:
            dn_embed = self.denoising_class_embed[dn["cls"].long()] * dn["valid"][..., None]
            embed = torch.cat([dn_embed.to(embed.dtype), embed], 1)
            refer_logit = torch.cat([dn["bbox_logit"].to(refer_logit.dtype), refer_logit], 1)
            attn_blocked = dn["attn_blocked"]

        refer = torch.sigmoid(refer_logit)
        out = embed
        dec_bboxes, dec_scores = [], []
        last_refined = None
        for i in range(self.ndl):
            out = self.decoder_layers[i](out, refer, feats, shapes, self.query_pos_head(refer),
                                         attn_blocked)
            bbox = _up(self.dec_bbox_head[i](out))
            refined = torch.sigmoid(bbox + inverse_sigmoid(refer))
            dec_scores.append(self.dec_score_head[i](out))
            if train and i > 0:
                dec_bboxes.append(torch.sigmoid(bbox + inverse_sigmoid(last_refined)))
            else:
                dec_bboxes.append(refined)
            last_refined = refined
            refer = refined.detach() if train else refined
        raw = (torch.stack(dec_bboxes), torch.stack(dec_scores), enc_bboxes, enc_scores)
        if train:
            return raw
        k = self.eval_idx
        return torch.cat([raw[0][k], torch.sigmoid(_up(raw[1][k]))], -1), raw
