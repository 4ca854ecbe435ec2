"""SAM (Segment Anything) modules of the PyTorch port.

Counterpart of ``yolo_ad_refine_tpu/models/sam/modules.py`` (reference
models/sam/modules/ encoders.py, decoders.py, transformer.py, blocks.py):

- ``ImageEncoderViT``: patch embedding, windowed / global ViT blocks with
  decomposed relative position, and the conv + ``LayerNorm2d`` neck;
- ``PromptEncoder``: the random-frequency positional encoding, point and
  box embeddings (point slots padded with label -1) and the mask prompt's
  downscaling;
- ``TwoWayTransformer`` and ``MaskDecoder``: iou / mask tokens, the
  two-way attention, output upscaling and the per-token hypernetwork MLPs.

Parameter names follow the reference torch SAM (``blocks.0.attn.qkv``,
``mask_decoder.transformer.layers.0.self_attn.q_proj``, ...). Image maps
are NCHW as in the reference; the ViT blocks and the transformers work on
channels-last tokens. Every LayerNorm takes the JAX package's eps, 1e-6
(flax's default, also where the reference's torch norms keep 1e-5), and
every softmax runs in fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW map (eps 1e-6)."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return x * self.weight[:, None, None] + self.bias[:, None, None]


class MLPBlock(nn.Module):
    """Linear -> act -> Linear (reference blocks.py MLPBlock); exact GELU."""

    def __init__(self, embedding_dim: int, mlp_dim: int, act: str = "gelu"):
        super().__init__()
        self.lin1 = nn.Linear(embedding_dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, embedding_dim)
        self.act = act

    def forward(self, x):
        h = self.lin1(x)
        return self.lin2(F.gelu(h) if self.act == "gelu" else F.relu(h))


class MLP(nn.Module):
    """``num_layers`` Linear layers with ``act`` (ReLU, or exact GELU)
    between them, optionally a sigmoid at the end (reference blocks.py MLP)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 sigmoid: bool = False, act: str = "relu"):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(nn.Linear(n, k) for n, k in zip(dims, dims[1:] + [output_dim]))
        self.sigmoid = sigmoid
        self.act = act

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.gelu(x) if self.act == "gelu" else F.relu(x)
        return torch.sigmoid(x) if self.sigmoid else x


def window_partition(x, ws: int):
    """(B, H, W, C) -> (B * nW, ws, ws, C), zero-padded at the bottom and
    right to a multiple of ``ws``; returns the windows and the padded (H, W)."""
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(windows, ws: int, pad_hw, hw):
    """Inverse of ``window_partition``: (B * nW, ws, ws, C) -> (B, H, W, C)."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // ws // ws)
    x = windows.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def _rel_coords(q_size: int, k_size: int, device=None):
    """Index of each (query, key) pair's relative offset into a rel-pos table."""
    qc = torch.arange(q_size, device=device)[:, None] * max(k_size / q_size, 1.0)
    kc = torch.arange(k_size, device=device)[None, :] * max(q_size / k_size, 1.0)
    return (qc - kc + (k_size - 1) * max(q_size / k_size, 1.0)).long()


class REAttention(nn.Module):
    """Multi-head attention with decomposed relative position (reference
    blocks.py REAttention + utils.py add_decomposed_rel_pos); x (B, H, W, C)."""

    def __init__(self, dim: int, num_heads: int, use_rel_pos: bool = True,
                 input_size: tuple[int, int] = (14, 14)):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.use_rel_pos = use_rel_pos
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, self.head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, self.head_dim))

    def forward(self, x):
        b, h, w, dim = x.shape
        nh, hd = self.num_heads, self.head_dim
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * nh, h * w, hd).unbind(0)
        attn = (q * hd**-0.5) @ k.transpose(-2, -1)
        if self.use_rel_pos:
            rh = self.rel_pos_h[_rel_coords(h, h, x.device)]   # (h, h, hd)
            rw = self.rel_pos_w[_rel_coords(w, w, x.device)]   # (w, w, hd)
            rq = q.reshape(b * nh, h, w, hd)
            eh = torch.einsum("bhwc,hkc->bhwk", rq, rh)
            ew = torch.einsum("bhwc,wkc->bhwk", rq, rw)
            attn = attn.view(-1, h, w, h, w) + eh[:, :, :, :, None] + ew[:, :, None, :, :]
            attn = attn.view(-1, h * w, h * w)
        attn = attn.float().softmax(-1).to(v.dtype)
        out = (attn @ v).view(b, nh, h, w, hd).permute(0, 2, 3, 1, 4).reshape(b, h, w, dim)
        return self.proj(out)


class ViTBlock(nn.Module):
    """Windowed (``window_size`` > 0) or global transformer block (reference
    blocks.py Block); x (B, H, W, C)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, window_size: int = 0,
                 input_size: tuple[int, int] = (64, 64)):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        size = (window_size, window_size) if window_size > 0 else input_size
        self.attn = REAttention(dim, num_heads, True, size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))
        self.window_size = window_size

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        hw = x.shape[1:3]
        if self.window_size > 0:
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, hw)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """A strided conv from the image to patch features (reference PatchEmbed)."""

    def __init__(self, kernel_size: int, stride: int, padding: int, in_chans: int,
                 embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, kernel_size, stride, padding)

    def forward(self, x):
        return self.proj(x)


class ImageEncoderViT(nn.Module):
    """Reference encoders.py:23 ImageEncoderViT. Image (B, 3, S, S) ->
    embeddings (B, out_chans, S/16, S/16)."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 out_chans: int = 256, window_size: int = 14,
                 global_attn_indexes: tuple[int, ...] = ()):
        super().__init__()
        g = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, patch_size, 0, 3, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, embed_dim))
        self.blocks = nn.ModuleList(
            ViTBlock(embed_dim, num_heads, mlp_ratio,
                     0 if i in global_attn_indexes else window_size, (g, g))
            for i in range(depth))
        self.neck = nn.Sequential(
            nn.Conv2d(embed_dim, out_chans, 1, bias=False), LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False), LayerNorm2d(out_chans))

    def forward(self, x):
        x = self.patch_embed(x).permute(0, 2, 3, 1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


class PositionEmbeddingRandom(nn.Module):
    """Positional encoding by random spatial frequencies (reference
    blocks.py:813); the (2, num_pos_feats) gaussian is a buffer."""

    def __init__(self, num_pos_feats: int = 128, scale: float = 1.0):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             scale * torch.randn((2, num_pos_feats)))

    def _encode(self, coords):
        coords = 2 * coords - 1
        coords = 2 * math.pi * (coords @ self.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(coords), torch.cos(coords)], -1)

    def forward(self, size: tuple[int, int]):
        """Dense grid PE -> (C, H, W)."""
        h, w = size
        dev = self.positional_encoding_gaussian_matrix.device
        ye = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xe = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack([xe[None, :].expand(h, w), ye[:, None].expand(h, w)], -1)
        return self._encode(grid).permute(2, 0, 1)

    def forward_with_coords(self, coords, image_size: tuple[int, int]):
        """Points (..., 2) in input pixels (x, y) -> (..., C)."""
        c = coords.float().clone()
        c[..., 0] = c[..., 0] / image_size[1]
        c[..., 1] = c[..., 1] / image_size[0]
        return self._encode(c)


class PromptEncoder(nn.Module):
    """Reference encoders.py:165. Points (B, N, 2) px with labels (B, N):
    1 foreground, 0 background, -1 padding; boxes (B, 4) or (B, 2, 2) corner
    px; a mask (B, 1, 4H, 4W). Returns (sparse (B, N', C), dense (B, C, H, W))."""

    def __init__(self, embed_dim: int = 256, image_embedding_size: tuple[int, int] = (64, 64),
                 input_image_size: tuple[int, int] = (1024, 1024), mask_in_chans: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, 2, 2), LayerNorm2d(mask_in_chans // 4), nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, 2), LayerNorm2d(mask_in_chans),
            nn.GELU(), nn.Conv2d(mask_in_chans, embed_dim, 1))
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def get_dense_pe(self):
        """(1, C, H, W) positional encoding of the image embedding's grid."""
        return self.pe_layer(self.image_embedding_size)[None]

    def _embed_points(self, points, labels, pad: bool):
        points = points + 0.5
        if pad:
            points = torch.cat([points, points.new_zeros((points.shape[0], 1, 2))], 1)
            labels = torch.cat([labels, -labels.new_ones((labels.shape[0], 1))], 1)
        pe = self.pe_layer.forward_with_coords(points, self.input_image_size)
        lab = labels[..., None]
        pe = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe)
        for k, emb in enumerate(self.point_embeddings):
            pe = pe + torch.where(lab == k, emb.weight[0], 0.0)
        return pe

    def _embed_boxes(self, boxes):
        ce = self.pe_layer.forward_with_coords(boxes.reshape(-1, 2, 2) + 0.5,
                                               self.input_image_size)
        return torch.stack([ce[:, 0] + self.point_embeddings[2].weight[0],
                            ce[:, 1] + self.point_embeddings[3].weight[0]], 1)

    def forward(self, points=None, boxes=None, masks=None):
        b = (points[0].shape[0] if points is not None
             else boxes.shape[0] if boxes is not None
             else masks.shape[0] if masks is not None else 1)
        dev = self.no_mask_embed.weight.device
        sparse = torch.zeros((b, 0, self.embed_dim), device=dev)
        if points is not None:
            pts, labels = points
            sparse = torch.cat([sparse, self._embed_points(pts, labels, pad=boxes is None)], 1)
        if boxes is not None:
            sparse = torch.cat([sparse, self._embed_boxes(boxes)], 1)
        if masks is not None:
            dense = self.mask_downscaling(masks)
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(b, -1, h, w)
        return sparse, dense


class Attention(nn.Module):
    """Attention with an optional internal downsampling of the embedding
    (reference transformer.py:265); ``kv_in_dim`` for keys / values of
    another width. q (B, Nq, C), k and v (B, Nk, C_kv)."""

    def __init__(self, embedding_dim: int, num_heads: int, downsample_rate: int = 1,
                 kv_in_dim: int | None = None):
        super().__init__()
        self.internal_dim = embedding_dim // downsample_rate
        self.num_heads = num_heads
        kv = kv_in_dim or embedding_dim
        self.q_proj = nn.Linear(embedding_dim, self.internal_dim)
        self.k_proj = nn.Linear(kv, self.internal_dim)
        self.v_proj = nn.Linear(kv, self.internal_dim)
        self.out_proj = nn.Linear(self.internal_dim, embedding_dim)

    def _heads(self, t):
        b, n, c = t.shape
        return t.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def forward(self, q, k, v):
        qh, kh, vh = self._heads(self.q_proj(q)), self._heads(self.k_proj(k)), \
            self._heads(self.v_proj(v))
        attn = (qh @ kh.transpose(-2, -1)) / math.sqrt(qh.shape[-1])
        attn = attn.float().softmax(-1).to(vh.dtype)
        out = (attn @ vh).transpose(1, 2).reshape(q.shape[0], q.shape[1], self.internal_dim)
        return self.out_proj(out)


class TwoWayAttentionBlock(nn.Module):
    """Reference transformer.py:152 (LayerNorm eps 1e-6, as the JAX package)."""

    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        self.self_attn = Attention(embedding_dim, num_heads)
        self.norm1 = nn.LayerNorm(embedding_dim, eps=1e-6)
        self.cross_attn_token_to_image = Attention(embedding_dim, num_heads, 2)
        self.norm2 = nn.LayerNorm(embedding_dim, eps=1e-6)
        self.mlp = MLPBlock(embedding_dim, mlp_dim, act="relu")
        self.norm3 = nn.LayerNorm(embedding_dim, eps=1e-6)
        self.norm4 = nn.LayerNorm(embedding_dim, eps=1e-6)
        self.cross_attn_image_to_token = Attention(embedding_dim, num_heads, 2)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """Reference transformer.py:12. image_embedding and image_pe (B, C, H, W),
    point_embedding (B, N, C) -> (queries (B, N, C), keys (B, H*W, C))."""

    def __init__(self, depth: int = 2, embedding_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim, skip_first_layer_pe=i == 0)
            for i in range(depth))
        self.final_attn_token_to_image = Attention(embedding_dim, num_heads, 2)
        self.norm_final_attn = nn.LayerNorm(embedding_dim, eps=1e-6)

    def forward(self, image_embedding, image_pe, point_embedding):
        keys = image_embedding.flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MaskDecoder(nn.Module):
    """Reference decoders.py:11. ``forward(image_embeddings (1 or B, C, H, W),
    image_pe (1, C, H, W), sparse (B, N, C), dense (B, C, H, W),
    multimask_output)`` -> (masks (B, k, 4H, 4W) logits, iou_pred (B, k))."""

    def __init__(self, transformer_dim: int = 256, num_multimask_outputs: int = 3,
                 iou_head_depth: int = 3, iou_head_hidden_dim: int = 256):
        super().__init__()
        td = transformer_dim
        self.transformer_dim = td
        self.transformer = TwoWayTransformer(embedding_dim=td)
        self.num_mask_tokens = num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, td)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, td)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(td, td // 4, 2, 2), LayerNorm2d(td // 4), nn.GELU(),
            nn.ConvTranspose2d(td // 4, td // 8, 2, 2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(td, td, td // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(td, iou_head_hidden_dim, self.num_mask_tokens,
                                       iou_head_depth)

    def forward(self, image_embeddings, image_pe, sparse_prompt, dense_prompt,
                multimask_output: bool):
        b, nm = sparse_prompt.shape[0], self.num_mask_tokens
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], 0)
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse_prompt.float()], 1)
        src = image_embeddings.expand(b, -1, -1, -1) + dense_prompt
        pos = image_pe.expand(b, -1, -1, -1)
        hs, src = self.transformer(src, pos, tokens)
        iou_tok, mask_toks = hs[:, 0], hs[:, 1: 1 + nm]
        h, w = image_embeddings.shape[2:]
        up = self.output_upscaling(src.transpose(1, 2).reshape(b, self.transformer_dim, h, w))
        hyper = torch.stack([mlp(mask_toks[:, i])
                             for i, mlp in enumerate(self.output_hypernetworks_mlps)], 1)
        masks = (hyper.float() @ up.float().flatten(2)).view(b, nm, *up.shape[2:])
        iou_pred = self.iou_prediction_head(iou_tok.float())
        sl = slice(1, None) if multimask_output else slice(0, 1)
        return masks[:, sl], iou_pred[:, sl]
