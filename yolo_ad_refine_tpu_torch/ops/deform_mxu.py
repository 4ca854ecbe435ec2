"""Separable modulated deformable convolution (K2).

Counterpart of ``yolo_ad_refine_tpu/ops/deform_mxu.py`` (the TPU kernel
``modulated_deform_conv2d_mxu``, its ``_fwd_kernel`` :91 and ``_bwd_kernel``
:161). No Pallas is involved: the CUDA kernels ``dcn_separable_forward`` /
``dcn_separable_backward`` in ``csrc/deform_window.cu`` take its place, and
the plain PyTorch versions repeat its arithmetic.

It computes K3's function (``ops/deform_pallas.py``, whose helpers it
shares), in the separable order: per tap an x pass over the window rows,
then the y combine. Only its rounding differs:

- coordinates: x is ((offset + tx + s) + x) - j over the padded columns j
  (:118), y is ((offset + y % 8) + r + 1) - d over the rows d of an 8-row
  chunk (:122);
- bf16 forward: the x weights are rounded to bf16 (:128), the x pass and
  the y combine run in fp32, the modulated sample stays fp32 and is
  contracted with the bf16 weight in fp32 (:143, :304);
- backward: all fp32 (:343-394), d offset_x as the sum over columns of
  dWx times the hat's derivative (:231-243).

d offset is 0 along an axis where the sample coordinate is integral and
where |offset| >= radius (:389-391).
"""

from __future__ import annotations

import functools

from yolo_ad_refine_tpu_torch.ops.deform import register_dcn_ops
from yolo_ad_refine_tpu_torch.ops.deform_pallas import (
    _backward, _forward, window_forward_plain, window_grads_plain)


def deform_conv2d_mxu_plain(x, offset, mask, weight, radius: int):
    """K2's plain forward, NHWC / HWIO as ``deform_conv2d_plain``: clip to
    +-radius, sample with the hat weights (zero outside the map), output in
    x's type."""
    return window_forward_plain(x, offset, mask, weight, radius, separable=True)


def deform_conv2d_mxu_grads_plain(x, offset, mask, weight, g, radius: int):
    """K2's plain backward: (dx, doffset, dmask, dweight) for g (B,H,W,Cout),
    all in fp32 from the hat and its derivative."""
    return window_grads_plain(x, offset, mask, weight, g, radius, separable=True)


def dcn_separable_forward(x, offset, mask, weight, radius: int):
    """K2 fwd on CUDA tensors (channels_last NCHW, as
    ``modulated_deform_conv2d_mxu``): launches ``csrc/deform_window.cu`` or
    raises."""
    out = _forward("dcn_separable_forward", x, offset, mask, weight, radius)
    dcn_separable_forward.launches += 1
    return out


def dcn_separable_backward(x, offset, mask, weight, g, radius: int):
    """K2 bwd on CUDA tensors: (dx, doffset, dmask, dweight) for g
    (B,Cout,H,W), all four summed in fp64 (as K3 bwd's) and rounded once
    here. Launches ``csrc/deform_window.cu`` or raises."""
    grads = _backward("dcn_separable_backward", x, offset, mask, weight, g, radius)
    dcn_separable_backward.launches += 1
    return grads


dcn_separable_forward_op, dcn_separable_backward_op = register_dcn_ops(
    "dcn_separable_forward", functools.partial(window_forward_plain, separable=True),
    dcn_separable_forward, functools.partial(window_grads_plain, separable=True),
    dcn_separable_backward)


def modulated_deform_conv2d_mxu(x, offset, mask, weight, radius: int = 3):
    """K2 on channels_last NCHW tensors: x (B,C,H,W), offset (B,18,H,W)
    fp32, mask (B,9,H,W) fp32, weight (Cout,C,3,3) cast to x's type here;
    the offsets are clipped to +-radius. Returns (B,Cout,H,W) in x's type,
    differentiable in all four inputs, through the dispatcher op
    ``yat_ad::dcn_separable_forward`` (backward
    ``yat_ad::dcn_separable_backward``): a CPU tensor runs the plain
    versions; a CUDA tensor launches ``dcn_separable_forward`` (and
    ``dcn_separable_backward``) or raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"modulated_deform_conv2d_mxu: unsupported device {x.device}")
    return dcn_separable_forward_op(x, offset, mask, weight.to(x.dtype), int(radius))


dcn_separable_forward.launches = 0
dcn_separable_backward.launches = 0
