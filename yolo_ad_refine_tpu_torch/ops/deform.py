"""Modulated deformable convolution (DCNv2), 3x3 / stride 1 / pad 1.

Counterpart of ``yolo_ad_refine_tpu/ops/deform.py`` (the exact gather, the
reference's mmcv semantics) and of the TPU kernel
``ops/deform_mxu2.py::modulated_deform_conv2d_mxu2``:

- ``deform_conv2d_plain`` is a line-by-line PyTorch port of the JAX exact
  gather, in its NHWC / HWIO layout. The CPU path and the kernel's checks use
  it.
- ``modulated_deform_conv2d`` is the wrapper the model calls, on
  channels_last NCHW tensors. A CPU tensor takes the plain version; a CUDA
  tensor launches ``csrc/deform_conv.cu`` or raises.

``radius=None`` samples unbounded (mmcv, ``ops/deform.py``); an integer
radius clips the offsets to +-radius first, as the TPU kernel does.
"""

from __future__ import annotations

import ctypes

import torch

from yolo_ad_refine_tpu_torch.utils import kernels

K = 3
KK = K * K


def _bilinear_sample(x_flat, coords_y, coords_x, h: int, w: int):
    """Bilinearly sample x_flat (B, H*W, C) at float coords (B, N).

    Corners outside the map contribute zero (mmcv convention). The map is
    zero-padded by 1 so each sample reads one 2x2 block; coordinates beyond
    the pad ring clip into it and get zero weight.
    """
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

    in_y = ((y0 >= -1) & (y0 <= h - 1)).float()
    in_x = ((x0 >= -1) & (x0 <= w - 1)).float()
    wy = torch.stack([1.0 - ly, ly], dim=-1) * in_y[..., None]  # (B, N, 2)
    wx = torch.stack([1.0 - lx, lx], dim=-1) * in_x[..., None]
    weights = (wy[:, :, :, None] * wx[:, :, None, :]).to(x_flat.dtype)  # (B, N, 2, 2)
    return torch.einsum("bnyx,bnyxc->bnc", weights, blocks)


def deform_conv2d_plain(x, offset, mask, weight, radius: int | None = None):
    """DCNv2 forward in plain PyTorch. x (B,H,W,C), offset (B,H,W,18),
    mask (B,H,W,9), weight (3,3,C,Cout) HWIO. Returns (B,H,W,Cout) in
    x.dtype, accumulated in fp32."""
    b, h, w, c = x.shape
    cout = weight.shape[-1]
    pad = K // 2
    dev = x.device
    x_flat = x.reshape(b, h * w, c)

    gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    base_y = torch.broadcast_to(gy, (h, w)).reshape(1, h * w, 1)
    base_x = torch.broadcast_to(gx, (h, w)).reshape(1, h * w, 1)
    tap_dy = torch.tensor([t // K - pad for t in range(KK)], dtype=torch.float32, device=dev)
    tap_dx = torch.tensor([t % K - pad for t in range(KK)], dtype=torch.float32, device=dev)

    offset = offset.float().reshape(b, h * w, KK, 2)
    if radius is not None:
        offset = offset.clamp(-float(radius), float(radius))
    cy = (base_y + tap_dy[None, None, :] + offset[..., 0]).reshape(b, h * w * KK)
    cx = (base_x + tap_dx[None, None, :] + offset[..., 1]).reshape(b, h * w * KK)

    sampled = _bilinear_sample(x_flat, cy, cx, h, w)  # (B, HW*KK, C)
    sampled = sampled * mask.reshape(b, h * w * KK, 1).to(sampled.dtype)
    sampled = sampled.reshape(b, h * w, KK * c)
    w_mat = weight.reshape(KK * c, cout)
    out = torch.matmul(sampled.float(), w_mat.float())
    return out.reshape(b, h, w, cout).to(x.dtype)


def _nhwc(t: torch.Tensor, name: str) -> torch.Tensor:
    v = t.permute(0, 2, 3, 1)
    if not v.is_contiguous():
        raise ValueError(f"{name} must be a channels_last NCHW tensor (contiguous NHWC view)")
    return v


def modulated_deform_conv2d(x, offset, mask, weight, radius: int | None = None):
    """DCNv2 forward on channels_last NCHW tensors: x (B,C,H,W), offset
    (B,18,H,W) fp32, mask (B,9,H,W) fp32, weight (Cout,C,3,3) in x.dtype.
    Returns (B,Cout,H,W) channels_last in x.dtype.

    A CPU tensor runs ``deform_conv2d_plain``; a CUDA tensor launches the
    kernel of ``csrc/deform_conv.cu``."""
    if x.device.type == "cpu":
        y = deform_conv2d_plain(x.permute(0, 2, 3, 1), offset.permute(0, 2, 3, 1),
                                mask.permute(0, 2, 3, 1), weight.permute(2, 3, 1, 0), radius)
        return y.permute(0, 3, 1, 2)
    if x.device.type != "cuda":
        raise ValueError(f"modulated_deform_conv2d: unsupported device {x.device}")
    b, c, h, w = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, c, K, K):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({cout}, {c}, 3, 3)")
    if tuple(offset.shape) != (b, 2 * KK, h, w) or tuple(mask.shape) != (b, KK, h, w):
        raise ValueError(f"offset {tuple(offset.shape)} / mask {tuple(mask.shape)} do not match "
                         f"x {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or weight.dtype != x.dtype:
        raise TypeError(f"x and weight must both be float32 or bfloat16, got {x.dtype}, {weight.dtype}")
    if offset.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError(f"offset and mask must be float32, got {offset.dtype}, {mask.dtype}")
    if radius is not None and radius < 0:
        raise ValueError(f"radius must be >= 0 or None, got {radius}")
    for t in (offset, mask, weight):
        if t.device != x.device:
            raise ValueError("x, offset, mask and weight must be on one device")
    xv, ov, mv = _nhwc(x, "x"), _nhwc(offset, "offset"), _nhwc(mask, "mask")
    wk = weight.permute(2, 3, 1, 0).reshape(KK, c, cout).contiguous()
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    lib = kernels.load("deform_conv")
    fn = lib.dcn_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                                                  ctypes.c_void_p]
    status = fn(xv.data_ptr(), ov.data_ptr(), mv.data_ptr(), wk.data_ptr(), out.data_ptr(),
                b, h, w, c, cout, -1.0 if radius is None else float(radius),
                0 if x.dtype == torch.float32 else 1,
                torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(lib, status, "dcn_forward")
    modulated_deform_conv2d.launches += 1
    return out


modulated_deform_conv2d.launches = 0
