"""Dynamic Snake Convolution (DSCN) sampling in plain PyTorch.

Counterpart of ``yolo_ad_refine_tpu/ops/dscn.py`` (reference
ultralytics/nn/modules/ops_dscn/, the InternImage-derived
``dscn_im2col_cuda.cuh``: im2col body :243-310, linear interpolation
:28-96). The kernel is one-dimensional: K taps along x (DSCNX) or y
(DSCNY), each with one learned fractional offset along that same axis,
``loc = p0 + (i * dilation + offset[g, i]) * scale``, sampled by linear
interpolation along the axis (zero outside the border), a sample dropped
whole when its location is outside (-1, size), and the taps summed
unweighted per (group, channel). No TPU kernel lies behind the JAX op; the
reference runs it only on a dead path (dsan.py through tasks1.py), so
this stays plain PyTorch until a user path needs a kernel.
"""

from __future__ import annotations

import torch


def dscn_sample(x, offset, kernel_size: int, axis: str, stride: int = 1,
                pad: int | None = None, dilation: int = 1, group: int = 1,
                offset_scale: float = 1.0, remove_center: bool = False):
    """Snake-sampled tap sum. x (B, H, W, C) NHWC, offset (B, Ho, Wo,
    group * K) in tap-major order; returns (B, Ho, Wo, C) in x's type,
    summed in fp32 (fp64 for fp64 inputs). ``axis`` is "x" (taps and offsets
    along the width) or "y"."""
    if pad is None:
        pad = (dilation * (kernel_size - 1)) // 2
    b, h, w, c = x.shape
    cg = c // group
    ktotal = kernel_size - int(remove_center)
    center = kernel_size // 2
    along_w = axis == "x"
    size = w if along_w else h
    acc = torch.promote_types(x.dtype, torch.float32)
    off = offset.reshape(*offset.shape[:3], group, ktotal).to(acc)  # (B, Ho, Wo, G, K)
    ho, wo = off.shape[1], off.shape[2]
    half = (dilation * (kernel_size - 1)) // 2
    coord = (torch.arange(wo if along_w else ho, dtype=acc, device=x.device) * stride
             + half - pad - half * offset_scale)
    base = coord[None, None, :, None] if along_w else coord[None, :, None, None]
    # the sampled axis last: (B, fixed, G, Cg, size)
    x5 = x.reshape(b, h, w, group, cg).to(acc)
    xs = x5.permute(0, 1, 3, 4, 2) if along_w else x5.permute(0, 2, 3, 4, 1)

    def fetch(idx):
        ok = ((idx >= 0) & (idx <= size - 1))[..., None]
        idxc = idx.clamp(0, size - 1)
        if along_w:  # idx (B, Ho, Wo, G) -> (B, Ho, G, Cg, Wo) against xs (B, H, G, Cg, W)
            ind = idxc.permute(0, 1, 3, 2)[:, :, :, None, :].expand(b, ho, group, cg, wo)
            v = torch.gather(xs, -1, ind).permute(0, 1, 4, 2, 3)
        else:
            ind = idxc.permute(0, 2, 3, 1)[:, :, :, None, :].expand(b, wo, group, cg, ho)
            v = torch.gather(xs, -1, ind).permute(0, 4, 1, 2, 3)
        return v * ok                                                # (B, Ho, Wo, G, Cg)

    out = torch.zeros(b, ho, wo, group, cg, dtype=acc, device=x.device)
    ki = 0
    for i in range(kernel_size):
        if remove_center and i == center:
            continue
        loc = base + (i * dilation + off[..., ki]) * offset_scale     # (B, Ho, Wo, G)
        ki += 1
        lo = torch.floor(loc)
        frac = (loc - lo)[..., None]
        valid = ((loc > -1.0) & (loc < size))[..., None]
        lo_i = lo.long()
        tap = fetch(lo_i) * (1.0 - frac) + fetch(lo_i + 1) * frac
        out = out + tap * valid
    return out.reshape(b, ho, wo, c).to(x.dtype)
