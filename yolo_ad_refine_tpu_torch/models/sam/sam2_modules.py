"""SAM2 building blocks of the PyTorch port: the Hiera trunk, the FPN neck,
the memory encoder and attention, and the SAM2 mask decoder.

Counterpart of ``yolo_ad_refine_tpu/models/sam/sam2_modules.py``
(reference models/sam/modules/ encoders.py:378-794, blocks.py,
memory_attention.py, decoders.py:176-518, utils.py:63-123). Parameter
names are the reference's (``trunk.blocks.0.mlp.layers.0``,
``neck.convs.0.conv``, ``fuser.layers.0.dwconv``, ...). Maps are NCHW;
Hiera's blocks work on (B, H, W, C) and the memory attention on (B, N, C)
batch-first sequences. Rotary encoding is the JAX package's real cos / sin
pair rotation; invalid memory slots are masked with -1e9 (not -inf), so a
bank with no valid slot gives the uniform softmax the JAX package gives.
Hiera's background position embedding is resized with ``resize_bicubic``,
JAX's bicubic (Keys, a = -0.5), which ``F.interpolate`` (a = -0.75) is not.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from yolo_ad_refine_tpu_torch.models.sam.modules import (
    MLP,
    Attention,
    LayerNorm2d,
    TwoWayTransformer,
    window_partition,
    window_unpartition,
)


def _keys_cubic(x):
    """Keys' cubic convolution kernel at a = -0.5, of |offset| x."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int, device):
    """(n_in, n_out) weights of ``jax.image.resize(method="bicubic")`` along
    one axis (jax/_src/image/scale.py compute_weight_mat, upsampling or
    downsampling with antialias): half-pixel centres, each output's taps
    renormalised to sum to 1, outputs outside the input's range zero."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bicubic(x, size: tuple[int, int]):
    """Resize the last two axes of ``x`` (..., H, W) to ``size`` as
    ``jax.image.resize(..., method="bicubic")`` does."""
    wh = _resize_weights(x.shape[-2], size[0], x.device).to(x.dtype)
    ww = _resize_weights(x.shape[-1], size[1], x.device).to(x.dtype)
    return torch.einsum("...hw,hH,wW->...HW", x, wh, ww)


def position_embedding_sine(h: int, w: int, dim: int = 256, temperature: int = 10000,
                            device=None):
    """Sine PE over an (h, w) grid -> (dim, h, w) (reference blocks.py:698:
    normalised, scale 2 pi, channels [pos_y, pos_x], sin / cos interleaved)."""
    npf = dim // 2
    scale = 2 * math.pi
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
    y = y / (h + 1e-6) * scale
    x = x / (w + 1e-6) * scale
    dim_t = torch.arange(npf, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / npf)
    px = x[..., None] / dim_t
    py = y[..., None] / dim_t
    px = torch.stack([px[..., 0::2].sin(), px[..., 1::2].cos()], -1).reshape(h, w, -1)
    py = torch.stack([py[..., 0::2].sin(), py[..., 1::2].cos()], -1).reshape(h, w, -1)
    return torch.cat([py, px], -1).permute(2, 0, 1)


def get_1d_sine_pe(pos, dim: int, temperature: float = 10000.0):
    """1D sine PE of scalar positions (..., ) -> (..., dim) (reference utils.py:63)."""
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / pe_dim)
    pe = pos[..., None] / dim_t
    return torch.cat([pe.sin(), pe.cos()], -1)


def axial_rope_angles(head_dim: int, end_x: int, end_y: int, theta: float = 10000.0,
                      device=None):
    """Axial RoPE angles of an (end_y, end_x) grid, row-major -> (N, head_dim // 2)
    (reference utils.py:74)."""
    quarter = head_dim // 4
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 4, dtype=torch.float32,
                                          device=device)[:quarter] / head_dim))
    t = torch.arange(end_x * end_y, dtype=torch.float32, device=device)
    tx = t % end_x
    ty = torch.floor(t / end_x)
    return torch.cat([tx[:, None] * freqs[None], ty[:, None] * freqs[None]], -1)


def apply_rotary(x, angles):
    """Rotate the interleaved pairs of x (B, H, N, d)'s last axis by
    ``angles`` (N, d / 2), as torch's complex-view formulation does."""
    xr = x.reshape(*x.shape[:-1], -1, 2)
    cos, sin = angles.cos(), angles.sin()
    re = xr[..., 0] * cos - xr[..., 1] * sin
    im = xr[..., 0] * sin + xr[..., 1] * cos
    return torch.stack([re, im], -1).reshape(x.shape)


def _max_pool(x, stride):
    """Max pool of (B, H, W, C) by ``stride`` (kernel = stride)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), stride, stride).permute(0, 2, 3, 1)


class MultiScaleAttention(nn.Module):
    """Attention with the queries optionally max-pooled by ``q_stride``
    (reference blocks.py:503); x (B, H, W, dim)."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, q_stride=None):
        super().__init__()
        self.num_heads = num_heads
        self.q_stride = q_stride
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)

    def forward(self, x):
        b, h, w, _ = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, -1)
        q, k, v = qkv.unbind(2)
        hd = q.shape[-1]
        if self.q_stride:
            q = _max_pool(q.reshape(b, h, w, nh * hd), self.q_stride)
            h, w = q.shape[1:3]
            q = q.reshape(b, h * w, nh, hd)
        attn = (q.transpose(1, 2) @ k.permute(0, 2, 3, 1)) / math.sqrt(hd)
        attn = attn.float().softmax(-1).to(v.dtype)
        out = (attn @ v.transpose(1, 2)).transpose(1, 2).reshape(b, h, w, -1)
        return self.proj(out)


class MultiScaleBlock(nn.Module):
    """Hiera block: windowed attention, a q-pool at a stage change
    (reference blocks.py:583); x (B, H, W, dim) -> (B, H', W', dim_out)."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, mlp_ratio: float = 4.0,
                 q_stride=None, window_size: int = 0):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.window_size = window_size
        self.q_stride = q_stride
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, q_stride)
        self.norm2 = nn.LayerNorm(dim_out, eps=1e-6)
        self.mlp = MLP(dim_out, int(dim_out * mlp_ratio), dim_out, 2, act="gelu")
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = self.proj(x)
            if self.q_stride:
                shortcut = _max_pool(shortcut, self.q_stride)
        ws = self.window_size
        h, w = x.shape[1:3]
        if ws > 0:
            x, pad_hw = window_partition(x, ws)
        x = self.attn(x)
        if self.q_stride:
            ws = ws // self.q_stride[0]
            h, w = shortcut.shape[1:3]
            pad_h = (ws - h % ws) % ws if ws else 0
            pad_w = (ws - w % ws) % ws if ws else 0
            pad_hw = (h + pad_h, w + pad_w)
        if self.window_size > 0:
            x = window_unpartition(x, ws, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """7x7 stride-4 patch conv (reference blocks.py PatchEmbed)."""

    def __init__(self, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, 7, 4, 3)

    def forward(self, x):
        return self.proj(x)


class Hiera(nn.Module):
    """Hierarchical ViT trunk (reference encoders.py:645). Image (B, 3, S, S)
    -> one NCHW map a stage, the highest resolution first."""

    def __init__(self, embed_dim: int = 96, num_heads: int = 1, stages=(2, 3, 16, 3),
                 q_pool: int = 3, q_stride=(2, 2), dim_mul: float = 2.0, head_mul: float = 2.0,
                 window_pos_embed_bkg_spatial_size=(14, 14), window_spec=(8, 4, 14, 7),
                 global_att_blocks=(12, 16, 20)):
        super().__init__()
        depth = sum(stages)
        self.stage_ends = [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]
        q_pool_blocks = [e + 1 for e in self.stage_ends[:-1]][:q_pool]
        self.patch_embed = PatchEmbed(3, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, embed_dim,
                                                  *window_pos_embed_bkg_spatial_size))
        self.pos_embed_window = nn.Parameter(torch.zeros(1, embed_dim, window_spec[0],
                                                         window_spec[0]))
        blocks = []
        dim, heads, cur_stage = embed_dim, num_heads, 1
        for i in range(depth):
            dim_out = dim
            window_size = window_spec[cur_stage - 1]
            if global_att_blocks and i in global_att_blocks:
                window_size = 0
            if i - 1 in self.stage_ends:
                dim_out = int(dim * dim_mul)
                heads = int(heads * head_mul)
                cur_stage += 1
            blocks.append(MultiScaleBlock(dim, dim_out, heads,
                                          q_stride=tuple(q_stride) if i in q_pool_blocks else None,
                                          window_size=window_size))
            dim = dim_out
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        x = self.patch_embed(x)
        h, w = x.shape[2:]
        win = self.pos_embed_window
        pe = resize_bicubic(self.pos_embed, (h, w)) + win.tile(1, 1, h // win.shape[2],
                                                               w // win.shape[3])
        x = (x + pe).permute(0, 2, 3, 1)
        outputs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.stage_ends:
                outputs.append(x.permute(0, 3, 1, 2))
        return outputs


class FpnNeck(nn.Module):
    """FPN neck without output convs, nearest 2x top-down into
    ``fpn_top_down_levels`` (reference encoders.py:501). Hiera's maps (the
    highest resolution first) -> (maps, position encodings), each
    (B, d_model, H, W), the highest resolution first."""

    def __init__(self, d_model: int = 256, backbone_channel_list=(768, 384, 192, 96),
                 fpn_top_down_levels=(2, 3)):
        super().__init__()
        self.d_model = d_model
        self.convs = nn.ModuleList()
        for dim in backbone_channel_list:
            current = nn.Sequential()
            current.add_module("conv", nn.Conv2d(dim, d_model, 1))
            self.convs.append(current)
        self.fpn_top_down_levels = tuple(fpn_top_down_levels)

    def forward(self, xs):
        n = len(xs) - 1
        out, pos = [None] * len(xs), [None] * len(xs)
        prev = None
        for i in range(n, -1, -1):
            lat = self.convs[n - i](xs[i])
            if i in self.fpn_top_down_levels and prev is not None:
                prev = lat + F.interpolate(prev.float(), scale_factor=2.0,
                                           mode="nearest").to(lat.dtype)
            else:
                prev = lat
            out[i] = prev
            pos[i] = position_embedding_sine(prev.shape[2], prev.shape[3], self.d_model,
                                             device=prev.device).to(prev.dtype)[None].expand(
                prev.shape[0], -1, -1, -1)
        return out, pos


class ImageEncoder(nn.Module):
    """Hiera trunk + FPN neck, the lowest resolution dropped (scalp 1)
    (reference encoders.py:446)."""

    def __init__(self, trunk: Hiera, neck: FpnNeck, scalp: int = 1):
        super().__init__()
        self.trunk, self.neck, self.scalp = trunk, neck, scalp

    def forward(self, x):
        feats, pos = self.neck(self.trunk(x))
        if self.scalp > 0:
            feats, pos = feats[: -self.scalp], pos[: -self.scalp]
        return {"vision_features": feats[-1], "vision_pos_enc": pos, "backbone_fpn": feats}


class CXBlock(nn.Module):
    """ConvNeXt block (reference blocks.py:114); NCHW."""

    def __init__(self, dim: int, kernel_size: int = 7, padding: int = 3,
                 layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, kernel_size, padding=padding, groups=dim)
        self.norm = LayerNorm2d(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(layer_scale_init_value * torch.ones(dim))

    def forward(self, x):
        y = self.norm(self.dwconv(x)).permute(0, 2, 3, 1)
        y = self.pwconv2(F.gelu(self.pwconv1(y)))
        return x + (self.gamma * y).permute(0, 3, 1, 2)


class Fuser(nn.Module):
    """CXBlocks in sequence (reference blocks.py Fuser)."""

    def __init__(self, dim: int, num_layers: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(CXBlock(dim) for _ in range(num_layers))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class MaskDownSampler(nn.Module):
    """A (B, 1, H, W) mask down by ``total_stride`` with channel expansion:
    [conv, LayerNorm2d, GELU] a stride, then a 1x1 conv (reference blocks.py:54)."""

    def __init__(self, embed_dim: int = 256, kernel_size: int = 3, stride: int = 2,
                 padding: int = 1, total_stride: int = 16):
        super().__init__()
        num_layers = int(math.log2(total_stride) // math.log2(stride))
        layers, c_in = [], 1
        for _ in range(num_layers):
            c_out = c_in * stride**2
            layers += [nn.Conv2d(c_in, c_out, kernel_size, stride, padding), LayerNorm2d(c_out),
                       nn.GELU()]
            c_in = c_out
        layers.append(nn.Conv2d(c_in, embed_dim, 1))
        self.encoder = nn.Sequential(*layers)

    def forward(self, x):
        return self.encoder(x)


class MemoryEncoder(nn.Module):
    """Pixel features fused with a predicted mask into a memory map
    (reference encoders.py:378): (pix_feat (B, in, h, w), masks
    (B, 1, S, S)) -> (features (B, out, h, w), position encoding)."""

    def __init__(self, out_dim: int = 64, in_dim: int = 256):
        super().__init__()
        self.mask_downsampler = MaskDownSampler(embed_dim=in_dim)
        self.pix_feat_proj = nn.Conv2d(in_dim, in_dim, 1)
        self.fuser = Fuser(in_dim, 2)
        self.out_dim = out_dim
        self.out_proj = nn.Conv2d(in_dim, out_dim, 1) if out_dim != in_dim else nn.Identity()

    def forward(self, pix_feat, masks, skip_mask_sigmoid: bool = False):
        if not skip_mask_sigmoid:
            masks = torch.sigmoid(masks)
        x = self.pix_feat_proj(pix_feat) + self.mask_downsampler(masks)
        x = self.out_proj(self.fuser(x))
        pos = position_embedding_sine(x.shape[2], x.shape[3], self.out_dim,
                                      device=x.device).to(x.dtype)
        return x, pos[None].expand(x.shape[0], -1, -1, -1)


class RoPEAttention(Attention):
    """Attention with axial rotary PE over a square query grid (reference
    blocks.py:405); batch-first (B, N, C). RoPE reaches the queries and all
    keys but the ``num_k_exclude_rope`` trailing ones (object pointers);
    with ``rope_k_repeat`` the keys' angles repeat once a memory frame.
    ``k_mask`` (B, M) True = valid; masked logits are set to -1e9."""

    def __init__(self, embedding_dim: int = 256, num_heads: int = 1,
                 kv_in_dim: int | None = None, rope_k_repeat: bool = False,
                 rope_theta: float = 10000.0):
        super().__init__(embedding_dim, num_heads, 1, kv_in_dim)
        self.rope_k_repeat = rope_k_repeat
        self.rope_theta = rope_theta

    def forward(self, q, k, v, num_k_exclude_rope: int = 0, k_mask=None):
        qh, kh, vh = self._heads(self.q_proj(q)), self._heads(self.k_proj(k)), \
            self._heads(self.v_proj(v))
        n_q, hd = qh.shape[2], qh.shape[3]
        side = int(round(math.sqrt(n_q)))
        angles = axial_rope_angles(hd, side, side, self.rope_theta, q.device)
        qh = apply_rotary(qh, angles)
        num_k_rope = kh.shape[2] - num_k_exclude_rope
        if num_k_rope > 0:
            k_angles = angles
            if self.rope_k_repeat and num_k_rope != n_q:
                k_angles = angles.repeat(num_k_rope // n_q, 1)
            kh = torch.cat([apply_rotary(kh[:, :, :num_k_rope], k_angles),
                            kh[:, :, num_k_rope:]], 2)
        attn = (qh @ kh.transpose(-2, -1)) / math.sqrt(hd)
        if k_mask is not None:
            attn = attn.masked_fill(~k_mask[:, None, None, :], -1e9)
        attn = attn.float().softmax(-1).to(vh.dtype)
        out = (attn @ vh).transpose(1, 2).reshape(q.shape[0], n_q, self.internal_dim)
        return self.out_proj(out)


class MemoryAttentionLayer(nn.Module):
    """RoPE self-attention, RoPE cross-attention to the memory, FFN, all
    pre-norm (reference memory_attention.py:12; LayerNorm eps 1e-6)."""

    def __init__(self, d_model: int = 256, dim_feedforward: int = 2048, mem_dim: int = 64):
        super().__init__()
        self.self_attn = RoPEAttention(d_model, 1)
        self.cross_attn_image = RoPEAttention(d_model, 1, kv_in_dim=mem_dim, rope_k_repeat=True)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, tgt, memory, pos, query_pos=None, num_k_exclude_rope: int = 0,
                k_mask=None):
        t2 = self.norm1(tgt)
        tgt = tgt + self.self_attn(t2, t2, t2)
        t2 = self.norm2(tgt)
        tgt = tgt + self.cross_attn_image(t2, memory + pos, memory,
                                          num_k_exclude_rope=num_k_exclude_rope, k_mask=k_mask)
        t2 = self.norm3(tgt)
        return tgt + self.linear2(F.relu(self.linear1(t2)))


class MemoryAttention(nn.Module):
    """A stack of memory attention layers and a final LayerNorm (reference
    memory_attention.py:140). curr (B, N, C), memory (B, M, mem_dim)."""

    def __init__(self, d_model: int = 256, num_layers: int = 4, mem_dim: int = 64):
        super().__init__()
        self.layers = nn.ModuleList(MemoryAttentionLayer(d_model, mem_dim=mem_dim)
                                    for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, curr, memory, curr_pos, memory_pos, num_obj_ptr_tokens: int = 0,
                k_mask=None):
        out = curr + 0.1 * curr_pos
        for layer in self.layers:
            out = layer(out, memory, memory_pos, curr_pos, num_k_exclude_rope=num_obj_ptr_tokens,
                        k_mask=k_mask)
        return self.norm(out)


class SAM2MaskDecoder(nn.Module):
    """MaskDecoder with the object-score token, the high-res skip features
    (``conv_s0`` / ``conv_s1`` sit here, as in the reference, and the net
    applies them when it encodes an image) and the dynamic multimask
    fallback (reference decoders.py:176). ``forward(image_embeddings
    (B, C, H, W), image_pe (1, C, H, W), sparse (B, N, C), dense
    (B, C, H, W), multimask_output, high_res_features [(B, C/8, 4H, 4W),
    (B, C/4, 2H, 2W)])`` -> (masks (B, k, 4H, 4W), iou (B, k), sam_tokens
    (B, k', C), object score logits (B, 1))."""

    def __init__(self, transformer_dim: int = 256, num_multimask_outputs: int = 3,
                 iou_head_depth: int = 3, iou_head_hidden_dim: int = 256,
                 dynamic_multimask_stability_delta: float = 0.05,
                 dynamic_multimask_stability_thresh: float = 0.98):
        super().__init__()
        td = transformer_dim
        self.transformer_dim = td
        self.transformer = TwoWayTransformer(embedding_dim=td)
        self.num_mask_tokens = num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, td)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, td)
        self.obj_score_token = nn.Embedding(1, td)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(td, td // 4, 2, 2), LayerNorm2d(td // 4), nn.GELU(),
            nn.ConvTranspose2d(td // 4, td // 8, 2, 2), nn.GELU())
        self.conv_s0 = nn.Conv2d(td, td // 8, 1)
        self.conv_s1 = nn.Conv2d(td, td // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(td, td, td // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(td, iou_head_hidden_dim, self.num_mask_tokens,
                                       iou_head_depth, sigmoid=True)
        self.pred_obj_score_head = MLP(td, td, 1, 3)
        self.stability_delta = dynamic_multimask_stability_delta
        self.stability_thresh = dynamic_multimask_stability_thresh

    def forward(self, image_embeddings, image_pe, sparse_prompt, dense_prompt,
                multimask_output: bool, high_res_features):
        td, nm = self.transformer_dim, self.num_mask_tokens
        b = sparse_prompt.shape[0]
        out_tokens = torch.cat([self.obj_score_token.weight, self.iou_token.weight,
                                self.mask_tokens.weight], 0)
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse_prompt.float()], 1)
        src = image_embeddings + dense_prompt
        pos = image_pe.expand(b, -1, -1, -1)
        hs, src = self.transformer(src, pos, tokens)
        iou_tok, mask_toks = hs[:, 1], hs[:, 2: 2 + nm]
        h, w = image_embeddings.shape[2:]
        dc1, ln1, act1, dc2, act2 = self.output_upscaling
        up = dc1(src.transpose(1, 2).reshape(b, td, h, w)) + high_res_features[1]
        up = act1(ln1(up))
        up = act2(dc2(up) + high_res_features[0])
        hyper = torch.stack([mlp(mask_toks[:, i])
                             for i, mlp in enumerate(self.output_hypernetworks_mlps)], 1)
        masks = (hyper.float() @ up.float().flatten(2)).view(b, nm, *up.shape[2:])
        iou_pred = self.iou_prediction_head(iou_tok.float())
        obj_logits = self.pred_obj_score_head(hs[:, 0].float())
        if multimask_output:
            out_masks, out_iou = masks[:, 1:], iou_pred[:, 1:]
            sam_tokens = mask_toks[:, 1:]
        else:
            out_masks, out_iou = self._dynamic_multimask(masks, iou_pred)
            sam_tokens = mask_toks[:, 0:1]
        return out_masks, out_iou, sam_tokens, obj_logits

    def _dynamic_multimask(self, masks, ious):
        """Token 0's mask where it is stable (the areas thresholded at
        +/- delta agree to ``stability_thresh``), else the best of the
        multimask outputs (reference decoders.py:456)."""
        single = masks[:, 0:1]
        flat = single.flatten(2)
        area_i = (flat > self.stability_delta).sum(-1).float()
        area_u = (flat > -self.stability_delta).sum(-1).float()
        stability = torch.where(area_u > 0, area_i / area_u.clamp(min=1), torch.ones_like(area_i))
        is_stable = stability >= self.stability_thresh
        multi_iou = ious[:, 1:]
        best = multi_iou.argmax(-1)
        bidx = torch.arange(masks.shape[0], device=masks.device)
        best_masks = masks[:, 1:][bidx, best][:, None]
        best_iou = multi_iou[bidx, best][:, None]
        out_masks = torch.where(is_stable[..., None, None], single, best_masks)
        out_iou = torch.where(is_stable, ious[:, 0:1], best_iou)
        return out_masks, out_iou

