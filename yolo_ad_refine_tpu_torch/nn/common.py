"""Core convolution / normalization modules (NCHW, channels_last).

Counterpart of ``yolo_ad_refine_tpu/nn/common.py`` (reference
ultralytics/nn/modules/conv.py Conv/DWConv/Concat, head.py:607 Conv_GN,
block.py:63 DFL). BatchNorm uses the reference's eps=1e-3 /
momentum=0.03 (its ``initialize_weights`` overrides every BatchNorm2d) and
updates its running variance with the biased batch variance, as the JAX
package's flax BatchNorm does; GroupNorm uses eps=1e-5.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from yolo_ad_refine_tpu_torch.nn.registry import register
from yolo_ad_refine_tpu_torch.parallel import all_reduce_sum, in_global_batch


def autopad(k: int, p: int | None = None, d: int = 1) -> int:
    """'same'-shape padding for odd kernels (reference conv.py:20)."""
    if d > 1:
        k = d * (k - 1) + 1
    if p is None:
        p = k // 2
    return p


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round channels up to the nearest multiple (reference utils/ops.py)."""
    return math.ceil(x / divisor) * divisor


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the global batch of a process group.

    The forward sums the count and the sum, then the squared deviations
    from the global mean (two passes, as flax's variance), over the ranks.
    The backward is the one-process batch norm's over the global batch,
    dx = w·invstd·(g − mean(g) − x̂·mean(g·x̂)) with both means summed over
    the ranks, and dw, db this rank's own sums (the data-parallel wrapper
    averages them); it keeps the fused form, whose sums cancel as the
    one-process kernel's do. Returns y and the (mean, biased variance) for
    the running statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        xf = x.double() if x.dtype == torch.float64 else x.float()
        c, dims, shape = x.shape[1], (0, 2, 3), (1, x.shape[1], 1, 1)
        count = torch.full((1,), x.numel() // c, dtype=xf.dtype, device=x.device)
        stats = all_reduce_sum(torch.cat([count, xf.sum(dim=dims)]))
        n = stats[0]
        mean = stats[1:] / n
        var = all_reduce_sum((xf - mean.view(shape)).square().sum(dim=dims)) / n
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - mean.view(shape)) * invstd.view(shape)
        ctx.save_for_backward(xhat, weight, invstd, n)
        ctx.mark_non_differentiable(mean, var)
        ctx.x_dtype = x.dtype
        y = xhat * weight.view(shape) + bias.view(shape)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        xhat, weight, invstd, n = ctx.saved_tensors
        c, dims, shape = xhat.shape[1], (0, 2, 3), (1, xhat.shape[1], 1, 1)
        g = gy.to(xhat.dtype)
        local = torch.cat([g.sum(dim=dims), (g * xhat).sum(dim=dims)])
        glob = all_reduce_sum(local) / n
        dx = (g - glob[:c].view(shape) - xhat * glob[c:].view(shape)) * \
            (weight * invstd).view(shape)
        return (dx.to(ctx.x_dtype), local[c:].to(weight.dtype), local[:c].to(weight.dtype),
                None)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode update of ``running_var`` uses
    the biased (two-pass, fp32) batch variance, as flax's BatchNorm with
    ``use_fast_variance=False`` does (``yolo_ad_refine_tpu/nn/common.py``);
    torch's own update uses the unbiased one. Normalisation, eval and the
    parameter and buffer names are torch's.

    In train mode within a data-parallel step (``parallel.global_batch``,
    under a process group of more than one rank), the mean and the biased variance are the
    global batch's, as under the JAX package's mesh (``_GlobalBatchNorm``,
    its sums over the ranks in fp32)."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if in_global_batch():
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
            with torch.no_grad():
                self._update_running(mean.float(), var.float())
            return y
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
            self._update_running(mean, var)
        return y

    def _update_running(self, mean, var):
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean * m)
        self.running_var.mul_(1.0 - m).add_(var * m)
        self.num_batches_tracked.add_(1)


def batch_norm(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-3, momentum=0.03)


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map, as flax's ``nn.LayerNorm``
    normalises the last axis of an NHWC one. The statistics run in fp32
    at least (fp64 kept), as flax computes them, and the output keeps the
    input's type."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__(c, eps=eps)

    def forward(self, x):
        acc = torch.promote_types(x.dtype, torch.float32)
        with autocast_off(x):
            y = F.layer_norm(x.permute(0, 2, 3, 1).to(acc), self.normalized_shape,
                             self.weight.to(acc), self.bias.to(acc), self.eps)
        return y.permute(0, 3, 1, 2).to(x.dtype)


def _act(act) -> nn.Module:
    if act is True:
        return nn.SiLU()
    if act in (False, None):
        return nn.Identity()
    return act


@register
class Conv(nn.Module):
    """Conv2d(bias=False) + BatchNorm + SiLU (reference conv.py:27-56)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, d: int = 1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), groups=g, dilation=d, bias=False)
        self.bn = batch_norm(c2)
        self.act = _act(act)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


@register
class DWConv(nn.Module):
    """Depth-wise Conv + BN + SiLU (reference conv.py:57): one Conv ``dw``
    with gcd(c1, c2) groups, as the JAX module names it."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, d: int = 1, act=True):
        super().__init__()
        self.dw = Conv(c1, c2, k, s, g=math.gcd(c1, c2), d=d, act=act)

    def forward(self, x):
        return self.dw(x)


class ConvGN(nn.Module):
    """Conv2d(bias=False) + GroupNorm(16) + SiLU (reference head.py:607-624)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, d: int = 1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), groups=g, dilation=d, bias=False)
        self.gn = nn.GroupNorm(16, c2, eps=1e-5)
        self.act = _act(act)

    def forward(self, x):
        return self.act(self.gn(self.conv(x)))


@register(name="nn.Conv2d")
def plain_conv2d(c1: int, c2: int, k: int = 1, s: int = 1) -> nn.Conv2d:
    """Bare torch nn.Conv2d yaml row (bias=True, p=0)."""
    return nn.Conv2d(c1, c2, k, s, 0, bias=True)


@register(name="nn.ConvTranspose2d")
def plain_conv_transpose2d(c1: int, c2: int, k: int = 3, s: int = 2, p: int = 1,
                           op: int = 1) -> nn.ConvTranspose2d:
    """Bare torch nn.ConvTranspose2d yaml row; output size (H-1)*s - 2p + k + op."""
    return nn.ConvTranspose2d(c1, c2, k, s, p, output_padding=op, bias=True)


register(nn.Upsample, name="nn.Upsample")


@register
class Concat(nn.Module):
    """Concatenate a list of tensors along channels."""

    def __init__(self, dim: int = 1):
        super().__init__()
        self.d = dim

    def forward(self, xs):
        return torch.cat(xs, dim=self.d)


def autocast_off(x: torch.Tensor):
    """Autocast off on ``x``'s device, for what the JAX package computes in
    fp32 whatever the model's type (YOLO-World's text attention and scores)."""
    return torch.autocast(x.device.type, enabled=False)


def max_pool_same(x, k: int, s: int = 1):
    """MaxPool2d(k, stride, padding=k//2) with -inf padding."""
    return F.max_pool2d(x, k, s, k // 2)


def dfl_decode(x, reg_max: int = 16):
    """Distribution Focal Loss decode: (..., 4*reg_max) logits -> (..., 4)
    expected distances (softmax expectation over the reg_max bins)."""
    shape = x.shape[:-1]
    x = x.reshape(*shape, 4, reg_max)
    x = torch.softmax(x.float(), dim=-1)
    proj = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return torch.einsum("...r,r->...", x, proj)
