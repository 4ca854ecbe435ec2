"""Modulated deformable convolution (DCNv2), 3x3, stride 1, padding 1, in
plain PyTorch: the reference for the program's K1 kernels.

A frozen copy of the exact gather that the port keeps as its CPU path
(``ops/deform.py deform_conv2d_plain``, mmcv's semantics: bilinear samples,
corners outside the map read zero, offsets unbounded), on channels_last
NCHW tensors as the model passes them. The batch runs in chunks of
``CHUNK`` images, each under activation checkpointing when a gradient is
wanted: the gathered corners of one image at the flagship's widest map
take hundreds of MiB in fp32, and a DCN mixes nothing across images.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

K = 3
KK = K * K
CHUNK = 4


def _bilinear_sample(x_flat, coords_y, coords_x, h: int, w: int):
    """Bilinearly sample x_flat (B, H*W, C) at float coords (B, N); corners
    outside the map contribute zero."""
    b, n = coords_y.shape
    c = x_flat.shape[-1]
    xp = torch.nn.functional.pad(x_flat.reshape(b, h, w, c), (0, 0, 1, 1, 1, 1))
    xp = xp.reshape(b, (h + 2) * (w + 2), c)
    y0 = torch.floor(coords_y)
    x0 = torch.floor(coords_x)
    ly = coords_y - y0
    lx = coords_x - x0
    iy = (y0.long() + 1).clamp(0, h)
    ix = (x0.long() + 1).clamp(0, w)
    rows = torch.stack([iy, iy, iy + 1, iy + 1], dim=-1)
    cols = torch.stack([ix, ix + 1, ix, ix + 1], dim=-1)
    flat = (rows * (w + 2) + cols).reshape(b, n * 4, 1).expand(b, n * 4, c)
    blocks = torch.gather(xp, 1, flat).reshape(b, n, 2, 2, c)
    in_y = ((y0 >= -1) & (y0 <= h - 1)).to(ly.dtype)
    in_x = ((x0 >= -1) & (x0 <= w - 1)).to(lx.dtype)
    wy = torch.stack([1.0 - ly, ly], dim=-1) * in_y[..., None]
    wx = torch.stack([1.0 - lx, lx], dim=-1) * in_x[..., None]
    weights = (wy[:, :, :, None] * wx[:, :, None, :]).to(x_flat.dtype)
    return torch.einsum("bnyx,bnyxc->bnc", weights, blocks)


def deform_conv2d_nhwc(x, offset, mask, weight):
    """x (B,H,W,C), offset (B,H,W,18) as (dy, dx) a tap, mask (B,H,W,9),
    weight (3,3,C,Cout) HWIO. Returns (B,H,W,Cout), accumulated in fp32 (in
    fp64 for fp64 inputs) and cast to x.dtype."""
    b, h, w, c = x.shape
    cout = weight.shape[-1]
    dev = x.device
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    gy = torch.arange(h, dtype=acc, device=dev)[:, None]
    gx = torch.arange(w, dtype=acc, device=dev)[None, :]
    base_y = torch.broadcast_to(gy, (h, w)).reshape(1, h * w, 1)
    base_x = torch.broadcast_to(gx, (h, w)).reshape(1, h * w, 1)
    tap_dy = torch.tensor([t // K - 1 for t in range(KK)], dtype=acc, device=dev)
    tap_dx = torch.tensor([t % K - 1 for t in range(KK)], dtype=acc, device=dev)
    offset = offset.to(acc).reshape(b, h * w, KK, 2)
    cy = (base_y + tap_dy[None, None, :] + offset[..., 0]).reshape(b, h * w * KK)
    cx = (base_x + tap_dx[None, None, :] + offset[..., 1]).reshape(b, h * w * KK)
    sampled = _bilinear_sample(x.reshape(b, h * w, c), cy, cx, h, w)
    sampled = sampled * mask.reshape(b, h * w * KK, 1).to(sampled.dtype)
    out = torch.matmul(sampled.reshape(b, h * w, KK * c).to(acc),
                       weight.reshape(KK * c, cout).to(acc))
    return out.reshape(b, h, w, cout).to(x.dtype)


def _chunk(x, offset, mask, weight):
    return deform_conv2d_nhwc(x.permute(0, 2, 3, 1), offset.permute(0, 2, 3, 1),
                              mask.permute(0, 2, 3, 1), weight.permute(2, 3, 1, 0))


def modulated_deform_conv2d(x, offset, mask, weight, radius=None):
    """The DCN the flagship's head calls: x (B,C,H,W), offset (B,18,H,W),
    mask (B,9,H,W), weight (Cout,C,3,3) cast to x.dtype. Returns
    (B,Cout,H,W) channels_last. ``radius`` must be None (unbounded), the
    program's default."""
    if radius is not None:
        raise ValueError("the reference DCN samples unbounded only")
    weight = weight.to(x.dtype)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (x, offset, mask, weight))
    outs = []
    for i in range(0, x.shape[0], CHUNK):
        args = (x[i:i + CHUNK], offset[i:i + CHUNK], mask[i:i + CHUNK], weight)
        outs.append(checkpoint(_chunk, *args, use_reentrant=False) if grad else _chunk(*args))
    y = torch.cat(outs).permute(0, 3, 1, 2)
    return y.contiguous(memory_format=torch.channels_last)
