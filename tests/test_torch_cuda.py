"""The port's CUDA kernels on the card: each against its plain version.

Every test here needs an NVIDIA GPU and nvcc and skips without them (a CUDA
kernel has no CPU mode). The file imports neither JAX nor the JAX package,
so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from yolo_ad_refine_tpu_torch.ops.deform import (
    dcn_backward, deform_conv2d_grads_plain, deform_conv2d_plain, modulated_deform_conv2d)
from yolo_ad_refine_tpu_torch.ops.deform_mxu import (
    dcn_separable_backward, dcn_separable_forward, deform_conv2d_mxu_grads_plain,
    deform_conv2d_mxu_plain, modulated_deform_conv2d_mxu)
from yolo_ad_refine_tpu_torch.ops.deform_pallas import (
    dcn_window_backward, dcn_window_forward, deform_conv2d_pallas_grads_plain,
    deform_conv2d_pallas_plain, modulated_deform_conv2d_pallas)
from yolo_ad_refine_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from yolo_ad_refine_tpu_torch.ops.lap import linear_sum_assignment, linear_sum_assignment_plain
from yolo_ad_refine_tpu_torch.ops.nms import (
    NMS_SMEM_DEFAULT, nms_launch, rotated_rounding_ties, suppress, suppress_plain,
    suppress_rotated, suppress_rotated_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dcn(dev, dtype, b=2, h=40, w=40, c=64, cout=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=g).to(dev, dtype)
    off = (torch.randn(b, h, w, 18, generator=g) * 5.0).to(dev)
    mask = torch.rand(b, h, w, 9, generator=g).to(dev)
    wt = (torch.randn(3, 3, c, cout, generator=g) / math.sqrt(9 * c)).to(dev, dtype)
    return x, off, mask, wt


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("radius", [None, 3])
@pytest.mark.parametrize("shape", [(2, 40, 40, 64, 64), (3, 13, 29, 48, 80)])
def test_dcn_kernel_matches_plain(dev, dtype, tol, radius, shape):
    """fp32 to 1e-4 (sums in another order, products by 3xTF32); bf16 to
    5e-2 (both round the modulated sample to bf16 before a bf16 x bf16
    contraction with fp32 sums, at slightly different points: the plain
    version also rounds the bilinear weights and the sum of the corners).
    The second shape has channel counts that are not multiples of the
    kernel's mma tiles and a ragged pixel tile."""
    dt = getattr(torch, dtype)
    b, h, w, c, cout = shape
    x, off, mask, wt = _dcn(dev, dt, b, h, w, c, cout)
    launches = modulated_deform_conv2d.launches
    got = modulated_deform_conv2d(x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2),
                                  mask.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1),
                                  radius=radius)
    torch.cuda.synchronize()
    assert modulated_deform_conv2d.launches == launches + 1
    assert got.dtype == dt and got.shape == (b, cout, h, w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = deform_conv2d_plain(x, off, mask, wt, radius).float()
    torch.testing.assert_close(got.permute(0, 2, 3, 1).float(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("radius", [None, 3])
@pytest.mark.parametrize("shape,sigma", [((2, 40, 40, 64, 64), 4.0), ((3, 13, 29, 48, 80), 5.0),
                                         ((2, 20, 20, 64, 64), 0.0)])
def test_dcn_backward_kernel_matches_plain(dev, dtype, tol, radius, shape, sigma):
    """Each of the four gradients within ``tol`` of max |plain|: sums in
    another order (dx and dweight in fp64, with atomics in an order that
    changes from run to run); bf16 as the forward. sigma 0 puts every sample on an integer
    coordinate, where the one-sided derivative is taken unbounded and the hat
    derivative, 0, at radius 3: a gradient that is 0 in the plain version
    must be 0 in the kernel."""
    dt = getattr(torch, dtype)
    b, h, w, c, cout = shape
    x, off, mask, wt = _dcn(dev, dt, b, h, w, c, cout)
    off = off / 5.0 * sigma
    g = torch.randn(b, h, w, cout, generator=torch.Generator().manual_seed(1)).to(dev, dt)
    launches = dcn_backward.launches
    got = dcn_backward(x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2),
                       wt.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2), radius)
    torch.cuda.synchronize()
    assert dcn_backward.launches == launches + 1
    want = deform_conv2d_grads_plain(x, off, mask, wt, g, radius)
    got = [got[0].permute(0, 2, 3, 1), got[1].permute(0, 2, 3, 1), got[2].permute(0, 2, 3, 1),
           got[3].permute(2, 3, 1, 0)]
    _assert_grads_close(got, want, tol)


# multi_scale at imgsz 640 draws 320 to 960 px: the flagship's three DCN
# levels (strides 8, 16, 32; C = Cout = 64) at the two extremes
MULTI_SCALE_LEVELS = [(s // stride, s) for s in (320, 960) for stride in (8, 16, 32)]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("hw,imgsz", MULTI_SCALE_LEVELS)
def test_dcn_at_the_multi_scale_extremes(dev, dtype, tol, hw, imgsz):
    """K1 fwd and bwd at the levels multi_scale trains at, 40² to 120² at
    batch 2, each against its plain version at the limits above."""
    dt = getattr(torch, dtype)
    x, off, mask, wt = _dcn(dev, dt, 2, hw, hw, 64, 64, seed=imgsz + hw)
    g = torch.randn(2, hw, hw, 64, generator=torch.Generator().manual_seed(hw)).to(dev, dt)
    nchw = [t.permute(0, 3, 1, 2) for t in (x, off, mask)]
    fwd, bwd = modulated_deform_conv2d.launches, dcn_backward.launches
    got = modulated_deform_conv2d(*nchw, wt.permute(3, 2, 0, 1), radius=None)
    grads = dcn_backward(*nchw, wt.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2), None)
    torch.cuda.synchronize()
    assert (modulated_deform_conv2d.launches, dcn_backward.launches) == (fwd + 1, bwd + 1)
    want = deform_conv2d_plain(x, off, mask, wt, None).float()
    torch.testing.assert_close(got.permute(0, 2, 3, 1).float(), want, atol=tol, rtol=tol)
    got = [grads[0].permute(0, 2, 3, 1), grads[1].permute(0, 2, 3, 1),
           grads[2].permute(0, 2, 3, 1), grads[3].permute(2, 3, 1, 0)]
    _assert_grads_close(got, deform_conv2d_grads_plain(x, off, mask, wt, g, None), tol)


K1_SHAPES = [(2, 9, 11, 20, 36), (1, 12, 10, 128, 128), (2, 1, 1, 64, 64), (3, 3, 5, 48, 80),
             (1, 6, 7, 64, 200), (1, 12, 10, 256, 256), (1, 6, 7, 384, 384)]


def _k1_case(dev, dtype, shape, far):
    dt = getattr(torch, dtype)
    b, h, w, c, cout = shape
    x, off, mask, wt = _dcn(dev, dt, b, h, w, c, cout, seed=c + cout)
    if far:  # every corner of every tap outside the map
        off = torch.full_like(off, 1000.0)
        off[..., 1::4] = -1000.0
    return x, off, mask, wt


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("radius", [None, 3])
@pytest.mark.parametrize("shape", K1_SHAPES)
@pytest.mark.parametrize("far", [False, True])
def test_dcn_kernel_shapes(dev, dtype, tol, radius, shape, far):
    """K1 fwd at channel counts off the mma tiles (C = 20, Cout = 36), at
    C = Cout = 128, beyond one block's 128 output channels (Cout = 200), at
    the flagship's widths of scales m / l and x (C = Cout = 256, 384), on
    1 x 1 and 3 x 5 maps, and with offsets that put every corner outside
    the map (radius None; at radius 3 the clip keeps some inside)."""
    x, off, mask, wt = _k1_case(dev, dtype, shape, far)
    got = modulated_deform_conv2d(x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2),
                                  mask.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1),
                                  radius=radius)
    torch.cuda.synchronize()
    want = deform_conv2d_plain(x, off, mask, wt, radius).float()
    if far and radius is None:
        assert not want.any()
    torch.testing.assert_close(got.permute(0, 2, 3, 1).float(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("radius", [None, 3])
@pytest.mark.parametrize("shape", K1_SHAPES)
@pytest.mark.parametrize("far", [False, True])
def test_dcn_backward_kernel_shapes(dev, dtype, tol, radius, shape, far):
    """K1 bwd at the shapes of ``test_dcn_kernel_shapes``, those past 128
    channels (Cout = 200; C = Cout = 256, 384) through the wide path's
    chunk pairs: each gradient within ``tol`` of max |plain|, and exactly 0
    where the plain gradient is."""
    x, off, mask, wt = _k1_case(dev, dtype, shape, far)
    b, h, w, c, cout = shape
    g = torch.randn(b, h, w, cout, generator=torch.Generator().manual_seed(2)).to(dev, x.dtype)
    got = dcn_backward(x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2),
                       wt.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2), radius)
    torch.cuda.synchronize()
    want = deform_conv2d_grads_plain(x, off, mask, wt, g, radius)
    _assert_grads_close([got[0].permute(0, 2, 3, 1), got[1].permute(0, 2, 3, 1),
                         got[2].permute(0, 2, 3, 1), got[3].permute(2, 3, 1, 0)], want, tol)


@pytest.mark.parametrize("c", [64, 384])
def test_dcn_backward_repeats_bit_for_bit(dev, c):
    """dx and dW are summed in fp64 (atomics, in an order that changes from
    run to run) and rounded once: two fp32 backwards give the same bits. At
    C = Cout = 384 (the wide path) doffset and dmask are fp64 sums of the
    chunk pairs' partials, rounded once, and repeat too."""
    b = 4 if c == 64 else 1
    x, off, mask, wt = _dcn(dev, torch.float32, b, 40, 40, c, c)
    g = torch.randn(b, 40, 40, c, generator=torch.Generator().manual_seed(3)).to(dev)
    args = (x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2),
            wt.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2))
    first = dcn_backward(*args)
    second = dcn_backward(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,c,cout", [(k, c, co) for k in (0, 1, 2) for c, co in (
    (64, 64), (20, 36), (128, 128), (48, 80), (64, 200), (256, 64), (64, 129), (256, 256),
    (384, 384))] + [(2, 3, 64), (2, 40, 80), (2, 72, 136)])
def test_dcn_smem_bytes_match_python(dev, kernel, dtype, c, cout):
    """The kernel's own shared-memory arithmetic is the wrapper's, and so is
    its choice of the backward's wide path (C or Cout above 128). Kernel 2:
    K2 / K3 fwd (``csrc/deform_window.cu``) against ``window_fwd_launch``'s
    plan at radius 1, 3, 13, 24, 31 and 60 (the last two in the global
    mode), both forms, and against ``window_fwd_smem`` at every chunk
    width, both block widths and both modes."""
    import ctypes

    from yolo_ad_refine_tpu_torch.ops.deform import k1_launch
    from yolo_ad_refine_tpu_torch.ops.deform_pallas import window_fwd_launch, window_fwd_smem
    from yolo_ad_refine_tpu_torch.utils import kernels

    if kernel == 2:
        lib = kernels.load("deform_window")
        fn = lib.dcn_window_fwd_smem_bytes
        fn.restype = ctypes.c_size_t
        fn.argtypes = [ctypes.c_int] * 6
        dt = getattr(torch, dtype)
        bf = int(dtype == "bfloat16")
        widths = (32, 16, 8, 4) if dtype == "float32" else (64, 32, 16, 8)
        for radius in (1, 3, 13, 24, 31, 60):
            for sep in (False, True):
                plan = window_fwd_launch(radius, c, cout, dt, separable=sep)
                assert plan["global"] == (radius > 30)
                assert fn(radius, plan["cc"], plan["nb"], bf, int(sep), int(plan["global"])) == \
                    plan["smem"]
                for cc in widths:
                    for nb in (64, 128):
                        for gl in (False, True):
                            assert fn(radius, cc, nb, bf, int(sep), int(gl)) == \
                                window_fwd_smem(radius, cc, nb, dt, sep, gl)
        return
    lib = kernels.load("deform_conv")
    lib.dcn_smem_bytes.restype = ctypes.c_size_t
    lib.dcn_smem_bytes.argtypes = [ctypes.c_int] * 4
    plan = k1_launch(("fwd", "bwd")[kernel], c, cout, getattr(torch, dtype))
    assert lib.dcn_smem_bytes(kernel, c, cout, int(dtype == "bfloat16")) == plan["smem"]
    if kernel == 1:
        lib.dcn_backward_wide.argtypes = [ctypes.c_int] * 2
        assert lib.dcn_backward_wide(c, cout) == int(plan["wide"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dcn_window_bwd_smem_and_shape_match_python(dev, dtype):
    """K2 / K3 bwd: the kernel's shared-memory arithmetic is
    ``window_bwd_smem``'s in both modes at radius 0 to 60 and 200, its
    block shape is ``window_bwd_launch``'s, and the plan's mode is the
    window mode exactly where that block fits."""
    import ctypes

    from yolo_ad_refine_tpu_torch.ops.deform import SMEM_PER_BLOCK
    from yolo_ad_refine_tpu_torch.ops.deform_pallas import (
        WIN_FWD_THREADS, WIN_FWD_TILE, window_bwd_launch, window_bwd_smem)
    from yolo_ad_refine_tpu_torch.utils import kernels

    lib = kernels.load("deform_window")
    fn = lib.dcn_window_bwd_smem_bytes
    fn.restype = ctypes.c_size_t
    fn.argtypes = [ctypes.c_int] * 3
    dt = getattr(torch, dtype)
    for radius in (*range(61), 200):
        for gl in (False, True):
            assert fn(radius, int(dtype == "bfloat16"), int(gl)) == \
                window_bwd_smem(radius, dt, gl), (radius, gl)
        plan = window_bwd_launch(radius, 64, 64, dt)
        assert plan["global"] == (fn(radius, int(dtype == "bfloat16"), 0) > SMEM_PER_BLOCK)
        assert plan["smem"] <= SMEM_PER_BLOCK
    plan = window_bwd_launch(3, 64, 64, dt)
    assert [lib.dcn_window_bwd_shape(i) for i in range(6)] == [
        plan["cc"], plan["no"], WIN_FWD_THREADS, *WIN_FWD_TILE, -1]


def _assert_grads_close(got, want, tol):
    for name, a, e in zip(("dx", "doffset", "dmask", "dweight"), got, want):
        assert a.shape == e.shape, name
        scale = e.float().abs().max().item()
        if scale == 0:
            assert not a.float().any(), f"{name}: the plain gradient is 0, the kernel's is not"
            continue
        err = (a.float() - e.float()).abs().max().item() / scale
        assert err <= tol, f"{name}: max |kernel - plain| / max |plain| = {err:.2e}"


def test_dcn_backward_integer_radius_takes_the_hat_derivative(dev):
    """At radius 3, integral y-offsets give d offset_y = 0 in the kernel as in
    the plain version (deform_mxu2's hat derivative); x-offsets 0.3 off the
    integers keep d offset_x."""
    x, off, mask, wt = _dcn(dev, torch.float32, 2, 20, 20, 64, 64)
    off = off.reshape(2, 20, 20, 9, 2)
    off[..., 0] = off[..., 0].round().clamp(-2, 2)
    off[..., 1] = off[..., 1].round().clamp(-2, 2) + 0.3
    off = off.reshape(2, 20, 20, 18).contiguous()
    g = torch.randn(2, 20, 20, 64, generator=torch.Generator().manual_seed(1)).to(dev)
    got = dcn_backward(x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2),
                       wt.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2), 3)
    torch.cuda.synchronize()
    doff = got[1].permute(0, 2, 3, 1)
    assert not doff[..., 0::2].any() and doff[..., 1::2].abs().max() > 0.1
    want = deform_conv2d_grads_plain(x, off, mask, wt, g, 3)
    _assert_grads_close([got[0].permute(0, 2, 3, 1), doff, got[2].permute(0, 2, 3, 1),
                         got[3].permute(2, 3, 1, 0)], want, 1e-4)


BOUNDED = {  # kind: (forward wrapper, backward wrapper, plain forward, plain backward, function)
    "mxu": (dcn_separable_forward, dcn_separable_backward, deform_conv2d_mxu_plain,
            deform_conv2d_mxu_grads_plain, modulated_deform_conv2d_mxu),
    "pallas": (dcn_window_forward, dcn_window_backward, deform_conv2d_pallas_plain,
               deform_conv2d_pallas_grads_plain, modulated_deform_conv2d_pallas),
}


def _assert_bwd_close(kind, x, off, mask, wt, g, radius, got):
    """K2 / K3 bwd's limit, 1e-4 of max |plain| per gradient in fp32 and in
    bf16 (the backward is all fp32): in fp32 the wrapper's outputs ``got``
    (NHWC / HWIO); with bf16 inputs the kernel's fp64 sums, before the
    wrapper rounds dx and dweight to bf16, against the plain version on the
    bf16 values in fp32."""
    from yolo_ad_refine_tpu_torch.ops.deform_pallas import _backward

    grads_plain = BOUNDED[kind][3]
    if x.dtype == torch.float32:
        _assert_grads_close(got, grads_plain(x, off, mask, wt, g, radius), 1e-4)
        return
    entry = "dcn_separable_backward" if kind == "mxu" else "dcn_window_backward"
    sums = _backward(entry, x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2),
                     mask.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2),
                     radius, rounded=False)
    sums = [sums[0].permute(0, 2, 3, 1), sums[1].permute(0, 2, 3, 1), sums[2].permute(0, 2, 3, 1),
            sums[3].permute(2, 3, 1, 0)]
    want = grads_plain(x.float(), off, mask, wt.float(), g.float(), radius)
    _assert_grads_close([s.float() for s in sums], want, 1e-4)


def _bounded_inputs(dev, dt, shape, radius, seed=0):
    """Offsets N(0, radius): a share beyond the radius, and one axis of
    every other tap integral."""
    b, h, w, c, cout = shape
    x, off, mask, wt = _dcn(dev, dt, b, h, w, c, cout, seed)
    off = (off / 5.0 * radius).reshape(b, h, w, 9, 2)
    off[:, :, :, 0::2, 0] = off[:, :, :, 0::2, 0].round()
    return x, off.reshape(b, h, w, 18).contiguous(), mask, wt


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("shape,radius", [((2, 40, 40, 64, 64), 3), ((3, 13, 29, 48, 80), 3),
                                          ((1, 24, 30, 64, 64), 20), ((2, 11, 9, 8, 8), 2)])
def test_bounded_dcn_forward_kernel_matches_plain(dev, kind, dtype, tol, shape, radius):
    """K2 / K3 forward against its plain version: fp32 to 1e-4 (sums in
    another order), bf16 to 5e-2 (an fp32 ulp in a sample can move a bf16
    rounding). Radius 20 takes the narrow channel chunks; C = 8 the
    staging without 16-byte copies in bf16."""
    fwd, _, plain, _, fn = BOUNDED[kind]
    dt = getattr(torch, dtype)
    b, h, w, c, cout = shape
    x, off, mask, wt = _bounded_inputs(dev, dt, shape, radius)
    launches = fwd.launches
    got = fn(x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2),
             wt.permute(3, 2, 0, 1), radius)
    torch.cuda.synchronize()
    assert fwd.launches == launches + 1
    assert got.dtype == dt and got.shape == (b, cout, h, w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = plain(x, off, mask, wt, radius).float()
    torch.testing.assert_close(got.permute(0, 2, 3, 1).float(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-4)])
@pytest.mark.parametrize("shape,radius", [((2, 40, 40, 64, 64), 3), ((3, 13, 29, 48, 80), 3),
                                          ((1, 24, 30, 64, 64), 20), ((2, 11, 9, 8, 8), 2),
                                          ((1, 13, 21, 3, 40), 3)])
def test_bounded_dcn_backward_kernel_matches_plain(dev, kind, dtype, tol, shape, radius):
    """K2 / K3 backward against its plain version, each gradient within
    ``tol`` of max |plain|: both backwards are all fp32, also for bf16
    inputs (the sample is never rounded to bf16), so bf16 is held at the
    fp32 limit on the function's values (``_assert_bwd_close``). d offset
    is 0 on the integral axis and beyond the radius in both. Radius 20 takes
    the global mode, C = 8 a single, partial channel chunk, C = 3 the loads
    without 16-byte copies, Cout = 80 a second, partial block of output
    channels."""
    fwd, bwd, _, _, fn = BOUNDED[kind]
    dt = getattr(torch, dtype)
    b, h, w, c, cout = shape
    x, off, mask, wt = _bounded_inputs(dev, dt, shape, radius)
    g = torch.randn(b, h, w, cout, generator=torch.Generator().manual_seed(1)).to(dev, dt)
    launches = bwd.launches
    got = bwd(x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2),
              wt.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2), radius)
    torch.cuda.synchronize()
    assert bwd.launches == launches + 1
    got = [got[0].permute(0, 2, 3, 1), got[1].permute(0, 2, 3, 1), got[2].permute(0, 2, 3, 1),
           got[3].permute(2, 3, 1, 0)]
    doff = got[1].reshape(b, h, w, 9, 2)
    assert not doff[:, :, :, 0::2, 0].any()
    assert not doff[off.reshape(b, h, w, 9, 2).abs() >= radius].any()
    assert tol == 1e-4
    _assert_bwd_close(kind, x, off, mask, wt, g, radius, got)


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("radius", [3, 31])
def test_bounded_dcn_at_scale_x_width(dev, kind, dtype, tol, radius):
    """K2 / K3 forward and backward at the flagship's scale-x DCN width, C =
    Cout = 384, at radius 3 (the backward's window mode) and 31 (both global
    modes): the backward takes 24 channel chunks x 6 output-channel chunks,
    each adding its parts of dx, doffset and dmask in fp64; the forward
    within ``tol``, each gradient within 1e-4 of max |plain| (fp32 and
    bf16: the backward is all fp32)."""
    from yolo_ad_refine_tpu_torch.ops.deform_pallas import window_bwd_launch

    fwd, bwd, plain, _, fn = BOUNDED[kind]
    dt = getattr(torch, dtype)
    shape = (1, 11, 13, 384, 384)
    assert window_bwd_launch(radius, 384, 384, dt)["global"] == (radius == 31)
    x, off, mask, wt = _bounded_inputs(dev, dt, shape, radius)
    got = fn(x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2),
             wt.permute(3, 2, 0, 1), radius)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.permute(0, 2, 3, 1).float(),
                               plain(x, off, mask, wt, radius).float(), atol=tol, rtol=tol)
    g = torch.randn(*shape[:3], 384, generator=torch.Generator().manual_seed(1)).to(dev, dt)
    got = bwd(x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2),
              wt.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2), radius)
    torch.cuda.synchronize()
    got = [got[0].permute(0, 2, 3, 1), got[1].permute(0, 2, 3, 1), got[2].permute(0, 2, 3, 1),
           got[3].permute(2, 3, 1, 0)]
    assert not got[1].reshape(*shape[:3], 9, 2)[:, :, :, 0::2, 0].any()
    _assert_bwd_close(kind, x, off, mask, wt, g, radius, got)


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("radius", [3, 13, 31, 200])
def test_bounded_dcn_backward_across_radii(dev, kind, dtype, radius):
    """K2 / K3 backward through its wrapper at radius 3 (the window mode),
    13, 31 and 200 (the global mode: the window fits no block), on a 40 x 70
    map with offsets N(0, (radius / 5)²) past the radius: each gradient
    within 1e-4 of max |plain|, d offset 0 on the integral axis and beyond
    the radius, one launch a call."""
    from yolo_ad_refine_tpu_torch.ops.deform_pallas import window_bwd_launch

    _, bwd, _, _, _ = BOUNDED[kind]
    dt = getattr(torch, dtype)
    b, h, w = 2, 40, 70
    assert window_bwd_launch(radius, 64, 64, dt, b=b, h=h, w=w)["global"] == (radius > 3)
    x, off, mask, wt = _bounded_inputs(dev, dt, (b, h, w, 64, 64), radius)
    assert (off.abs() > radius).any()
    g = torch.randn(b, h, w, 64, generator=torch.Generator().manual_seed(1)).to(dev, dt)
    launches = bwd.launches
    got = bwd(x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2),
              wt.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2), radius)
    torch.cuda.synchronize()
    assert bwd.launches == launches + 1
    got = [got[0].permute(0, 2, 3, 1), got[1].permute(0, 2, 3, 1), got[2].permute(0, 2, 3, 1),
           got[3].permute(2, 3, 1, 0)]
    doff = got[1].reshape(b, h, w, 9, 2)
    assert not doff[:, :, :, 0::2, 0].any()
    assert not doff[off.reshape(b, h, w, 9, 2).abs() >= radius].any()
    _assert_bwd_close(kind, x, off, mask, wt, g, radius, got)


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
@pytest.mark.parametrize("shape,radius", [((4, 40, 40, 64, 64), 3), ((2, 40, 70, 64, 64), 13),
                                          ((1, 11, 13, 384, 384), 3)])
def test_bounded_dcn_backward_repeats_bit_for_bit(dev, kind, shape, radius):
    """Each gradient is summed in fp32 in a fixed order within a block and
    added into fp64 by atomics (dx first in the block's window), then
    rounded once: two fp32 backwards give the same bits, in the window mode
    (radius 3), the global mode (13) and with 24 x 6 chunks (C = Cout =
    384). The offsets are N(0, 4²) around radius 3, so many coordinates sit
    near a rounding boundary of the hat."""
    _, bwd, _, _, _ = BOUNDED[kind]
    b, h, w, c, cout = shape
    x, off, mask, wt = _bounded_inputs(dev, torch.float32, shape, radius)
    g = torch.randn(b, h, w, cout, generator=torch.Generator().manual_seed(3)).to(dev)
    args = (x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2),
            wt.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2), radius)
    first, second = bwd(*args), bwd(*args)
    torch.cuda.synchronize()
    for a, e in zip(first, second):
        assert torch.equal(a, e)


def _backward_in_mode(kind, x, off, mask, wt, g, radius, global_):
    """The backward's C entry with ``window_bwd_launch``'s plan in the window
    or the global mode: its fp64 sums (dx, doffset, dmask, dweight), NHWC."""
    from yolo_ad_refine_tpu_torch.ops.deform_pallas import window_bwd_launch
    from yolo_ad_refine_tpu_torch.utils import kernels

    b, h, w, c = x.shape
    cout = wt.shape[-1]
    entry = "dcn_separable_backward" if kind == "mxu" else "dcn_window_backward"
    plan = window_bwd_launch(radius, c, cout, x.dtype, b=b, h=h, w=w)
    wk = wt.reshape(9, c, cout).contiguous()
    f64 = dict(dtype=torch.float64, device=x.device)
    outs = (torch.zeros((b, h, w, c), **f64), torch.zeros((b, h, w, 18), **f64),
            torch.zeros((b, h, w, 9), **f64), torch.zeros((9, c, cout), **f64))
    lib = kernels.load("deform_window")
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    status = fn(x.data_ptr(), off.data_ptr(), mask.data_ptr(), wk.data_ptr(), g.data_ptr(),
                *(o.data_ptr() for o in outs), b, h, w, c, cout, radius, plan["groups"],
                int(plan["vec16"]), int(global_), 0 if x.dtype == torch.float32 else 1,
                torch.cuda.current_stream().cuda_stream)
    kernels.check(lib, status, entry)
    return outs


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,cout", [(3, 64), (64, 64), (40, 136)])
def test_bounded_dcn_backward_global_mode_equals_window_mode(dev, kind, dtype, c, cout):
    """The global mode (corners from global memory, dx added there) and the
    window mode (dx summed in the block's fp64 window first) add the same
    fp32 terms: their fp64 sums agree to within fp64 rounding (1e-12 of max
    |sum|), at radius 3 on a 13 x 21 map whose samples leave it."""
    dt = getattr(torch, dtype)
    x, off, mask, wt = _bounded_inputs(dev, dt, (2, 13, 21, c, cout), 3)
    g = torch.randn(2, 13, 21, cout, generator=torch.Generator().manual_seed(2)).to(dev, dt)
    window = _backward_in_mode(kind, x, off, mask, wt, g, 3, False)
    glob = _backward_in_mode(kind, x, off, mask, wt, g, 3, True)
    torch.cuda.synchronize()
    for name, a, e in zip(("dx", "doffset", "dmask", "dweight"), window, glob):
        assert (a - e).abs().max() <= 1e-12 * e.abs().max(), name


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("c,cout", [(3, 64), (40, 80), (72, 136)])
@pytest.mark.parametrize("radius", [1, 3, 13])
def test_bounded_dcn_forward_breaks_the_tiling(dev, kind, dtype, tol, c, cout, radius):
    """K2 / K3 forward (the tensor-core kernels) where the tiles do not fit:
    B = 1, a 13 x 21 map (no multiple of 8), C = 3 (no 16-byte copies, a
    chunk padded past C), 40 (a chunk half past C) and 72, Cout past a
    block's 64 or 128 channels (the last block's n-tiles cut short), offsets
    N(0, radius²) past the radius with one axis of every other tap on the
    integers; the limits above, and a second run equal bit for bit."""
    fwd, _, plain, _, _ = BOUNDED[kind]
    dt = getattr(torch, dtype)
    shape = (1, 13, 21, c, cout)
    x, off, mask, wt = _bounded_inputs(dev, dt, shape, radius)
    assert (off.abs() > radius).any()
    args = (x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2),
            wt.permute(3, 2, 0, 1), radius)
    got, again = fwd(*args), fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.permute(0, 2, 3, 1).float(),
                               plain(x, off, mask, wt, radius).float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bounded_dcn_forward_block_widths_agree(dev, kind, dtype):
    """At Cout = 384 the forward takes 128-channel blocks, at Cout = 64
    64-channel blocks; at one chunk width the two sum every output in the
    same order, so each 64 output channels of the wide layer equal the
    narrow layer of their weights bit for bit. (Another chunk width orders
    the k-blocks otherwise, and rounds otherwise: in fp32 the wider weight
    tiles of a 128-channel block narrow the chunk from 32 to 16 channels at
    C = 384, so fp32 is held at C = 16, where both take 16.)"""
    from yolo_ad_refine_tpu_torch.ops.deform_pallas import window_fwd_launch

    fwd = BOUNDED[kind][0]
    dt = getattr(torch, dtype)
    sep = kind == "mxu"
    c = 16 if dtype == "float32" else 384
    wide_plan, narrow_plan = (window_fwd_launch(3, c, co, dt, separable=sep) for co in (384, 64))
    assert (wide_plan["nb"], narrow_plan["nb"]) == (128, 64)
    assert wide_plan["cc"] == narrow_plan["cc"]
    x, off, mask, wt = _bounded_inputs(dev, dt, (2, 11, 13, c, 384), 3)
    args = (x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2))
    wide = fwd(*args, wt.permute(3, 2, 0, 1), 3)
    for o in range(0, 384, 64):
        narrow = fwd(*args, wt[..., o:o + 64].permute(3, 2, 0, 1), 3)
        torch.cuda.synchronize()
        assert torch.equal(wide[:, o:o + 64], narrow), o


def _forward_in_mode(kind, x, off, mask, wt, radius, global_):
    """The forward's C entry at ``window_fwd_launch``'s chunk width with
    64-channel blocks, in the window mode or the global mode (NHWC in and
    out)."""
    from yolo_ad_refine_tpu_torch.ops.deform import k1_fwd_weight
    from yolo_ad_refine_tpu_torch.ops.deform_pallas import window_fwd_launch
    from yolo_ad_refine_tpu_torch.utils import kernels

    b, h, w, c = x.shape
    cout = wt.shape[-1]
    entry = "dcn_separable_forward" if kind == "mxu" else "dcn_window_forward"
    plan = window_fwd_launch(radius, c, cout, x.dtype, separable=kind == "mxu")
    wk = k1_fwd_weight(wt.permute(3, 2, 0, 1), plan["cpad"])
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    lib = kernels.load("deform_window")
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    status = fn(x.data_ptr(), off.data_ptr(), mask.data_ptr(), wk.data_ptr(), out.data_ptr(),
                b, h, w, c, cout, plan["cpad"], radius, plan["cc"], 64, int(plan["vec16"]),
                int(global_), 0 if x.dtype == torch.float32 else 1,
                torch.cuda.current_stream().cuda_stream)
    kernels.check(lib, status, entry)
    return out


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,cout", [(3, 64), (64, 64), (40, 136)])
def test_bounded_dcn_forward_global_mode_equals_window_mode(dev, kind, dtype, c, cout):
    """The global mode (corners from global memory) and the window mode at
    one chunk width and block width differ only in where the corners are
    read: their outputs are equal bit for bit, at radius 3 on a 13 x 21 map
    whose samples leave it."""
    dt = getattr(torch, dtype)
    x, off, mask, wt = _bounded_inputs(dev, dt, (2, 13, 21, c, cout), 3)
    window = _forward_in_mode(kind, x, off, mask, wt, 3, False)
    glob = _forward_in_mode(kind, x, off, mask, wt, 3, True)
    torch.cuda.synchronize()
    assert torch.equal(window, glob)


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("c,cout", [(3, 64), (64, 136)])
@pytest.mark.parametrize("radius", [31, 60])
def test_bounded_dcn_forward_past_the_window(dev, kind, dtype, tol, c, cout, radius):
    """Past the radius whose window fits a block the plan takes the global
    mode: the forward runs through its wrapper, held against its plain
    version with the limits above, on a 40 x 70 map with offsets
    N(0, (radius / 5)²) past the radius; a second run is equal bit for bit."""
    from yolo_ad_refine_tpu_torch.ops.deform_pallas import window_fwd_launch

    fwd, _, plain, _, _ = BOUNDED[kind]
    dt = getattr(torch, dtype)
    assert window_fwd_launch(radius, c, cout, dt, separable=kind == "mxu")["global"]
    x, off, mask, wt = _bounded_inputs(dev, dt, (2, 40, 70, c, cout), radius)
    assert (off.abs() > radius).any()
    args = (x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2),
            wt.permute(3, 2, 0, 1), radius)
    launches = fwd.launches
    got, again = fwd(*args), fwd(*args)
    torch.cuda.synchronize()
    assert fwd.launches == launches + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.permute(0, 2, 3, 1).float(),
                               plain(x, off, mask, wt, radius).float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
def test_bounded_dcn_on_cuda_runs_both_kernels(dev, kind):
    fwd, bwd, _, _, fn = BOUNDED[kind]
    x, off, mask, wt = _dcn(dev, torch.float32, 2, 16, 16, 64, 64)
    args = [t.permute(0, 3, 1, 2).requires_grad_() for t in (x, off, mask)]
    weight = wt.permute(3, 2, 0, 1).detach().requires_grad_()
    launches = fwd.launches, bwd.launches, modulated_deform_conv2d.launches
    y = fn(*args, weight, 3)
    y.square().sum().backward()
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches, modulated_deform_conv2d.launches) == (
        launches[0] + 1, launches[1] + 1, launches[2])
    for t in (*args, weight):
        assert t.grad is not None and torch.isfinite(t.grad).all() and t.grad.abs().sum() > 0


def test_bounded_dcn_backward_at_radius_200(dev):
    """Where no window fits a block the backward takes its global mode (as
    the forward does) and matches its plain version: K3 at radius 200, fp32,
    offsets N(0, 40²), each gradient within 1e-4 of max |plain|."""
    x, off, mask, wt = _bounded_inputs(dev, torch.float32, (1, 8, 8, 64, 64), 200)
    g = torch.randn(1, 8, 8, 64, generator=torch.Generator().manual_seed(1)).to(dev)
    got = dcn_window_backward(x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2),
                              mask.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1),
                              g.permute(0, 3, 1, 2), 200)
    torch.cuda.synchronize()
    _assert_grads_close([got[0].permute(0, 2, 3, 1), got[1].permute(0, 2, 3, 1),
                         got[2].permute(0, 2, 3, 1), got[3].permute(2, 3, 1, 0)],
                        deform_conv2d_pallas_grads_plain(x, off, mask, wt, g, 200), 1e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_dcn_bias_on_the_card_runs_k1(dev, dtype, tol):
    """The JAX signature's bias on a CUDA tensor: K1 fwd launches once and
    the sum is the plain version's, which adds the bias in fp32 before its
    cast (K1's bf16 output is rounded before the bias: within its limit)."""
    dt = getattr(torch, dtype)
    x, off, mask, wt = _dcn(dev, dt, 2, 24, 20, 64, 48, seed=11)
    bias = torch.randn(48, generator=torch.Generator().manual_seed(12)).to(dev)
    launches = modulated_deform_conv2d.launches
    got = modulated_deform_conv2d(x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2),
                                  mask.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), bias)
    torch.cuda.synchronize()
    assert modulated_deform_conv2d.launches == launches + 1
    assert got.dtype == dt and got.is_contiguous(memory_format=torch.channels_last)
    want = deform_conv2d_plain(x, off, mask, wt, None, bias).float()
    torch.testing.assert_close(got.permute(0, 2, 3, 1).float(), want, atol=tol, rtol=tol)


def test_dcn_k5_on_the_card_runs_the_plain_path(dev):
    """k = 5 has no kernel (the JAX function is plain JAX): on the card it
    runs the plain version, launching no K1, and equals the same call on
    the CPU, which tests/test_torch_signatures.py holds to JAX's."""
    g = torch.Generator().manual_seed(13)
    x = torch.randn(2, 9, 11, 16, generator=g)
    off = torch.randn(2, 9, 11, 50, generator=g) * 1.5
    mask = torch.rand(2, 9, 11, 25, generator=g)
    wt = torch.randn(48, 16, 5, 5, generator=g) * 0.05
    bias = torch.randn(48, generator=g)
    args = [t.permute(0, 3, 1, 2) for t in (x, off, mask)] + [wt, bias, 5]
    want = modulated_deform_conv2d(*args)
    launches = modulated_deform_conv2d.launches
    got = modulated_deform_conv2d(*[a.to(dev) if torch.is_tensor(a) else a for a in args])
    torch.cuda.synchronize()
    assert modulated_deform_conv2d.launches == launches
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)


def test_dcn_on_cuda_has_grad_fn_and_launches_backward(dev):
    x, off, mask, wt = _dcn(dev, torch.float32, 2, 16, 16, 64, 64)
    args = [t.permute(0, 3, 1, 2).requires_grad_() for t in (x, off, mask)]
    weight = wt.permute(3, 2, 0, 1).detach().requires_grad_()
    y = modulated_deform_conv2d(*args, weight)
    assert y.grad_fn is not None
    launches = dcn_backward.launches
    y.square().sum().backward()
    torch.cuda.synchronize()
    assert dcn_backward.launches == launches + 1
    for t in (*args, weight):
        assert t.grad is not None and torch.isfinite(t.grad).all() and t.grad.abs().sum() > 0


def test_dcn_wrapper_rejects_bad_inputs(dev):
    x, off, mask, wt = _dcn(dev, torch.float32, 1, 8, 8, 16, 16)
    args = [x.permute(0, 3, 1, 2), off.permute(0, 3, 1, 2), mask.permute(0, 3, 1, 2),
            wt.permute(3, 2, 0, 1)]
    with pytest.raises(ValueError, match="channels_last"):
        modulated_deform_conv2d(x.permute(0, 3, 1, 2).contiguous(), *args[1:])
    with pytest.raises(TypeError):
        modulated_deform_conv2d(args[0], args[1].half(), *args[2:])
    with pytest.raises(ValueError):
        modulated_deform_conv2d(*args[:3], args[3][:, :8])


@pytest.mark.parametrize("b,k", [(32, 2048), (2, 1000), (1, 64), (4, 65)])
def test_nms_kernel_keep_mask_equals_plain(dev, b, k):
    g = torch.Generator().manual_seed(k)
    cxy = torch.rand(b, k, 2, generator=g) * 300
    wh = torch.rand(b, k, 2, generator=g) * 80 + 4
    boxes = torch.cat([cxy - wh / 2, cxy + wh / 2], -1).to(dev)
    scores = ((torch.rand(b, k, generator=g) * 16).round() / 16).sort(
        dim=1, descending=True, stable=True).values.to(dev)
    launches = suppress.launches
    got = suppress(boxes, scores, 0.5, 0.1)
    torch.cuda.synchronize()
    assert suppress.launches == launches + 1
    want = suppress_plain(boxes, scores, 0.5, 0.1)
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < b * k


def test_flagship_predict_launches_both_kernels(dev):
    from yolo_ad_refine_tpu_torch import YOLO

    model = YOLO("yolo11-701-YOLO-AD-Refine.yaml", device=dev, imgsz=128)
    r = np.random.default_rng(0)
    imgs = [r.integers(0, 256, (100, 140, 3), dtype=np.uint8),
            r.integers(0, 256, (150, 90, 3), dtype=np.uint8)]
    modulated_deform_conv2d.launches = suppress.launches = 0
    results = model.predict(imgs, imgsz=128, conf=0.001, batch=2)
    assert modulated_deform_conv2d.launches == 3 and suppress.launches == 1
    assert all(len(res) > 0 and np.isfinite(res.boxes.data).all() for res in results)


@pytest.mark.parametrize("b,k", [(16, 2048), (3, 1000), (1, 64), (4, 65)])
def test_rotated_nms_kernel_keep_mask_equals_plain(dev, b, k):
    """K5 against its plain version on the card: equal keep masks, but for
    rounding ties (a probiou within 1e-5 of the threshold, each difference
    checked against a replay of the plain walk, ``rotated_rounding_ties``)."""
    g = torch.Generator().manual_seed(k)
    xy = torch.rand(b, k, 2, generator=g) * 400
    wh = torch.rand(b, k, 2, generator=g) * 80 + 8
    ang = torch.rand(b, k, 1, generator=g) * math.pi - math.pi / 4
    cls = torch.randint(0, 15, (b, k, 1), generator=g).float() * 7680.0
    rb = torch.cat([xy + cls, wh, ang], -1).to(dev)
    scores = ((torch.rand(b, k, generator=g) * 16).round() / 16).sort(
        dim=1, descending=True, stable=True).values.to(dev)
    launches = suppress_rotated.launches
    got = suppress_rotated(rb, scores, 0.5, 0.1)
    torch.cuda.synchronize()
    assert suppress_rotated.launches == launches + 1
    want = suppress_rotated_plain(rb, scores, 0.5, 0.1)
    rotated_rounding_ties(got, want, rb, scores, 0.5, 0.1)  # raises on any other difference
    assert 0 < int(got.sum()) < int((scores > 0.1).sum())


def test_rotated_nms_wrapper_rejects_bad_inputs(dev):
    rb = torch.rand(2, 70, 5, device=dev)
    scores = torch.rand(2, 70, device=dev)
    with pytest.raises(ValueError):
        suppress_rotated(rb[..., :4].contiguous(), scores, 0.5, 0.1)
    with pytest.raises(TypeError):
        suppress_rotated(rb.double(), scores, 0.5, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        suppress_rotated(rb.transpose(0, 1).contiguous().transpose(0, 1), scores, 0.5, 0.1)


def test_obb_predict_and_val_launch_k5(dev, tmp_path):
    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.data.synthetic import make_dota_dataset

    model = YOLO("yolo11n-obb.yaml", task="obb", device=dev, imgsz=128)
    r = np.random.default_rng(0)
    imgs = [r.integers(0, 256, (128, 128, 3), dtype=np.uint8) for _ in range(3)]
    suppress_rotated.launches = suppress.launches = 0
    results = model.predict(imgs, imgsz=128, conf=1e-6, batch=2)
    assert suppress_rotated.launches == 2 and suppress.launches == 0
    assert all(len(res) > 0 and np.isfinite(res.obb.data).all() for res in results)
    data = make_dota_dataset(tmp_path / "dota", n_val=4, imgsz=128)
    suppress_rotated.launches = 0
    metrics = model.val(data=data, imgsz=128, batch=2)
    assert suppress_rotated.launches == 2
    assert all(math.isfinite(v) for v in metrics.values())


# conf of each score pattern; "unsorted, interleaved" also permutes the
# scores along K, so that valid and invalid rows alternate out of order
NMS_PATTERNS = {"conf 0.1": 0.1, "no valid row": 1.0, "every row valid": -1.0,
                "unsorted, interleaved": 0.5}


def _nms_case(dev, kernel, b, k, pattern):
    """K4 boxes (B, K, 4) xyxy or K5 rboxes (B, K, 5) xywhr with class
    offsets, scores (B, K) on a 1/16 grid (ties), and the pattern's conf."""
    g = torch.Generator().manual_seed(b * 10007 + k)
    xy = torch.rand(b, k, 2, generator=g) * 300
    wh = torch.rand(b, k, 2, generator=g) * 80 + 4
    cls = torch.randint(0, 4, (b, k, 1), generator=g).float() * 7680.0
    if kernel == "K4":
        data = torch.cat([xy - wh / 2, xy + wh / 2], -1) + cls
    else:
        ang = torch.rand(b, k, 1, generator=g) * math.pi - math.pi / 4
        data = torch.cat([xy + cls, wh, ang], -1)
    scores = ((torch.rand(b, k, generator=g) * 16).round() / 16).sort(
        dim=1, descending=True, stable=True).values
    if pattern == "unsorted, interleaved":
        scores = scores[:, torch.randperm(k, generator=g)]
    return data.to(dev).contiguous(), scores.to(dev).contiguous(), NMS_PATTERNS[pattern]


@pytest.mark.parametrize("pattern", list(NMS_PATTERNS))
@pytest.mark.parametrize("b,k", [(32, 2048), (16, 2048), (1, 1), (2, 4096), (3, 4100),
                                 (64, 2048)])
@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_nms_kernels_match_plain_at_any_shape_and_score_order(dev, kernel, b, k, pattern):
    """K4 bit-equal to its plain version, K5 but for rounding ties, at
    the serving and OBB batches, one candidate, max_nms 4096, a ragged last
    word past 64 words and a batch of 64; with no valid row, every row valid
    and unsorted scores. One launch a call."""
    data, scores, conf = _nms_case(dev, kernel, b, k, pattern)
    fn, plain = ((suppress, suppress_plain) if kernel == "K4"
                 else (suppress_rotated, suppress_rotated_plain))
    launches = fn.launches
    got = fn(data, scores, 0.5, conf)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    want = plain(data, scores, 0.5, conf)
    if kernel == "K4":
        assert torch.equal(got, want)
    else:
        rotated_rounding_ties(got, want, data, scores, 0.5, conf)  # raises on any other difference
    assert not (got & ~(scores > conf)).any()
    if pattern == "no valid row":
        assert not got.any()
    elif pattern == "every row valid":
        assert got[:, 0].all()


@pytest.mark.parametrize("b,k", [(2, 2048), (1, 4100)])
def test_nms_kernel_on_a_chain_of_kills(dev, b, k):
    """K4 where each box kills the next one alone (30 px boxes 7 px apart):
    the walk's longest chain within a word, every other candidate kept."""
    x = torch.arange(k, dtype=torch.float32) * 7.0
    boxes = torch.stack([x, torch.zeros(k), x + 30.0, torch.full((k,), 30.0)], -1)
    boxes = boxes.expand(b, k, 4).contiguous().to(dev)
    scores = torch.linspace(1.0, 0.2, k).expand(b, k).contiguous().to(dev)
    got = suppress(boxes, scores, 0.5, 0.1)
    assert torch.equal(got, suppress_plain(boxes, scores, 0.5, 0.1))
    assert got[:, ::2].all() and not got[:, 1::2].any()


@pytest.mark.parametrize("conf", [0.001, 0.25])
def test_nms_kernel_on_flagship_predict_candidates(dev, conf):
    """K4 on the candidates of a flagship predict batch (seeded weights,
    8 images at 640: K = 2048) at predict's conf 0.001 and default 0.25."""
    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.engine.profile_nms import predict_candidates
    from yolo_ad_refine_tpu_torch.engine.profile_predict import SHAPES

    model = YOLO("yolo11-701-YOLO-AD-Refine.yaml", device=dev, imgsz=640, seed=0)
    r = np.random.default_rng(0)
    imgs = [r.integers(0, 256, (*SHAPES[i], 3), dtype=np.uint8) for i in range(8)]
    boxes, scores = predict_candidates(model, imgs, 640, (conf,))[conf]
    assert scores.shape == (8, 2048)
    launches = suppress.launches
    got = suppress(boxes, scores, 0.7, conf)
    assert suppress.launches == launches + 1
    assert torch.equal(got, suppress_plain(boxes, scores, 0.7, conf))


def test_nms_kernel_on_tracked_frames(dev, tmp_path):
    """K4 at B = 1: ``YOLO.track`` launches it once a frame, and on one
    frame's candidates (the flagship at 640, K = 2048) it equals its plain
    version."""
    import cv2

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.engine.profile_nms import predict_candidates

    model = YOLO("yolo11-701-YOLO-AD-Refine.yaml", device=dev, imgsz=640, seed=0)
    vid = tmp_path / "v.avi"
    w = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"MJPG"), 10, (320, 180))
    r = np.random.default_rng(0)
    frames = [r.integers(0, 256, (180, 320, 3), dtype=np.uint8) for _ in range(4)]
    for f in frames:
        w.write(f)
    w.release()
    suppress.launches = 0
    results = model.track(str(vid), imgsz=640, conf=0.001)
    assert len(results) == 4 and suppress.launches == 4
    for conf in (0.001, 0.25):
        boxes, scores = predict_candidates(model, frames[:1], 640, (conf,))[conf]
        assert scores.shape == (1, 2048)
        got = suppress(boxes, scores, 0.7, conf)
        assert torch.equal(got, suppress_plain(boxes, scores, 0.7, conf))


@pytest.mark.parametrize("b,k", [(1, 1), (1, 2048), (32, 2048), (2, 4096), (3, 4100), (70, 65)])
def test_nms_launch_plan_matches_nms_launch(dev, b, k):
    """The C side's launch arithmetic (``nms_launch_plan``) is ops/nms.py's,
    and it refuses what ``nms_launch`` refuses."""
    from yolo_ad_refine_tpu_torch.utils import kernels

    lib = kernels.load("nms")
    lib.nms_launch_plan.restype = ctypes.c_int
    lib.nms_launch_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_longlong * 7)()
    assert lib.nms_launch_plan(b, k, out) == 0
    plan = nms_launch(b, k)
    assert list(out) == [plan[n] for n in ("nwords", "tiles", "mask_blocks", "mask_threads",
                                           "walk_blocks", "walk_threads", "walk_smem")]
    k_max = 64 * ((NMS_SMEM_DEFAULT - 144) // 8)
    assert lib.nms_launch_plan(b, k_max, out) == 0
    assert lib.nms_launch_plan(b, k_max + 1, out) != 0
    assert lib.nms_launch_plan(65536, k, out) != 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,c", [(2, 400, 64), (3, 37, 5), (1, 1, 8), (2, 6400, 64)])
def test_gather_kernel_equals_plain(dev, dtype, b, n, c):
    """The probe's row gather, bit for bit, with indices in range, from -N
    to -1 (wrapped), below -N and at N and above (rows of zeros), at row
    lengths of 16-byte pieces and of odd element counts (2- or 4-byte
    pieces)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(b, n, c, generator=gen).to(dev, dt)
    idx = torch.randint(-2 * n - 3, 2 * n + 3, (b, 9 * n), generator=gen, dtype=torch.int32)
    idx[:, :4] = torch.tensor([-1, -n, -n - 1, n], dtype=torch.int32)
    idx = idx.to(dev)
    launches = gather_rows.launches
    got = gather_rows(x, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == launches + 1
    want = gather_rows_plain(x, idx)
    assert got.dtype == dt and got.shape == (b, 9 * n, c)
    assert torch.equal(got, want)
    assert not got[:, 2:4].any() and torch.equal(got[:, 0], x[:, -1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_kernel_equals_torch_gather_in_range(dev, dtype):
    """For in-range indices the kernel computes what torch.gather does (the
    library call the probe's profile times beside it)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(4, 1600, 64, generator=gen).to(dev, dt)
    idx = torch.randint(0, 1600, (4, 9 * 1600), generator=gen, dtype=torch.int32).to(dev)
    want = torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, 64))
    assert torch.equal(gather_rows(x, idx), want)


def test_gather_wrapper_rejects_bad_inputs(dev):
    x = torch.randn(2, 10, 8, device=dev)
    idx = torch.zeros(2, 5, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        gather_rows(x, idx.long())
    with pytest.raises(TypeError):
        gather_rows(x.half(), idx)
    with pytest.raises(ValueError):
        gather_rows(x.transpose(1, 2), idx)
    with pytest.raises(ValueError):
        gather_rows(x, idx[:1])


@pytest.mark.parametrize("fmt", ["torch_export", "torchscript"])
def test_loaded_program_launches_k1_and_matches_the_eager_model(dev, fmt, tmp_path):
    """A flagship program exported on the card and loaded by AutoBackend
    runs K1 fwd once a level (its yat_ad::dcn_forward op's CUDA
    implementation) and gives the eager model's output within the serving
    limits (boxes 5e-2 px, scores 1e-3)."""
    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.engine.exporter import AutoBackend, ExportedForward

    model = YOLO("yolo11-701-YOLO-AD-Refine.yaml", device=dev, imgsz=128)
    img = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 128, 128, 3), dtype=np.uint8)).to(dev)
    path = model.export(format=fmt, imgsz=128, batch=2, half=False, path=tmp_path / "m")
    backend = AutoBackend(path, device=dev)
    modulated_deform_conv2d.launches = 0
    y = backend(img)
    torch.cuda.synchronize()
    assert modulated_deform_conv2d.launches == 3
    with torch.inference_mode():
        want = ExportedForward(model.model, torch.float32)(img.float())
    assert (y[..., :4] - want[..., :4]).abs().max().item() <= 5e-2
    assert (y[..., 4:] - want[..., 4:]).abs().max().item() <= 1e-3


@pytest.mark.parametrize("conf,multi_label", [(0.25, False), (0.001, True)])
def test_nms_kernel_on_world_vocabulary_candidates(dev, conf, multi_label):
    """K4 on yolov8s-worldv2's candidates after set_classes with 3 names,
    selected over the vocabulary's columns as the predictor (single-label)
    and the validator (multi-label) select them: the keep mask equals the
    plain version's, and predict launches K4 once a batch."""
    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.engine.profile_nms import predict_candidates

    model = YOLO("yolov8s-worldv2.yaml", device=dev, imgsz=320, seed=0)
    model.set_classes(["person", "car", "dog"])
    with torch.no_grad():
        for contrast in model.model.model[model.model.head_idx].cv4:
            contrast.bias.fill_(-1.0)
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (320, 320, 3), dtype=np.uint8) for _ in range(4)]
    boxes, scores = predict_candidates(model, imgs, 320, (conf,), multi_label=multi_label)[conf]
    assert int((scores > conf).sum()) > 0
    assert torch.equal(suppress(boxes, scores, 0.7, conf), suppress_plain(boxes, scores, 0.7, conf))
    suppress.launches = 0
    results = model.predict(imgs, conf=conf, batch=4)
    assert suppress.launches == 1
    assert all(set(r.boxes.cls.tolist()) <= {0.0, 1.0, 2.0} for r in results)


def test_v10_and_classify_run_without_k4_and_match_the_cpu(dev):
    """yolov10n's NMS-free serving launches no K4; its one-to-one maps (what
    its selection reads) and yolo11n-cls's softmax agree with the same
    models on the CPU, to 1e-4 of their largest value."""
    import copy

    from yolo_ad_refine_tpu_torch import YOLO

    x = torch.rand(2, 3, 320, 320, generator=torch.Generator().manual_seed(0))
    for cfg in ("yolov10n.yaml", "yolo11n-cls.yaml"):
        net = YOLO(cfg, device=dev, imgsz=320, seed=0).model.eval()
        with torch.no_grad():
            pairs = [(net(x.to(dev)), copy.deepcopy(net).cpu()(x))]
        if cfg.startswith("yolov10"):
            pairs = list(zip(pairs[0][0][1]["one2one"], pairs[0][1][1]["one2one"]))
        for got, want in pairs:
            assert (got.float().cpu() - want).abs().max() <= 1e-4 * want.abs().max()
    suppress.launches = 0
    YOLO("yolov10n.yaml", device=dev, imgsz=320).predict(
        [np.zeros((320, 320, 3), np.uint8)] * 2, conf=0.001, batch=2)
    assert suppress.launches == 0


def _lap_cost(b, m, n, seed, ints=False):
    g = torch.Generator().manual_seed(seed)
    if ints:  # many exact ties
        return torch.randint(0, 3, (b, m, n), generator=g).float()
    return torch.randn(b, m, n, generator=g) * 5.0


@pytest.mark.parametrize("b,m,n,ints,masked", [
    (3, 12, 40, False, False), (7, 128, 300, False, True), (5, 10, 30, True, False),
    (4, 16, 300, True, True), (2, 1, 1, False, False), (1, 300, 300, False, False)])
def test_lap_kernel_equals_plain(dev, b, m, n, ints, masked):
    """The kernel and its plain version run the same fp32 operations in the
    same order: the assignments and the scan counts are equal exactly,
    with ties, padded rows, one element and a square matrix."""
    cost = _lap_cost(b, m, n, seed=m + n, ints=ints)
    cost[0, 0, 0] = float("nan")  # non-finite costs count as 0
    mask = None
    if masked:
        mask = (torch.rand(b, m, generator=torch.Generator().manual_seed(1)) < 0.5).float()
        mask[0] = 0.0  # a matrix with no valid row
    want, want_scans = linear_sum_assignment_plain(cost, mask, return_scans=True)
    got, scans = linear_sum_assignment(cost.to(dev), None if mask is None else mask.to(dev),
                                       return_scans=True)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(scans.cpu(), want_scans)
    for i in range(b):
        assert len(set(got[i].tolist())) == m  # distinct columns


def test_lap_wrapper_counts_and_rejects(dev):
    before = linear_sum_assignment.launches
    linear_sum_assignment(torch.zeros(1, 2, 3, device=dev))
    assert linear_sum_assignment.launches == before + 1
    with pytest.raises(ValueError, match="M <= N"):
        linear_sum_assignment(torch.zeros(1, 4, 3, device=dev))


LIBRARY_ROWS = ["EMA", "SimAM", "TripletAttention", "LSKBlock", "SEAttention",
                "EfficientChannelAttention", "SpatialGroupEnhance", "EffectiveSEModule", "ELA",
                "CAA", "MPCA", "AFGCAttention", "BAMBlock", "LSKBlockSA", "LSKA",
                "SegNext_Attention", "CPCA", "deformable_LKA", "DAttention",
                "FocusedLinearAttention", "CascadedGroupAttention", "LocalWindowAttention",
                "DualDomainSelectionMechanism", "EfficientAttention", "BiLevelRoutingAttention",
                "DSAN", "DSA", "C2TSSA_DYT_Mona_EDFFN", "C2SFA", "C2PSA_EDFFN",
                "C2AdaptiveTSSA_Enhanced", "C2ProgressiveTSSA_Fusion1", "GSConv"]


@pytest.mark.parametrize("name", LIBRARY_ROWS)
def test_module_library_row_card_matches_cpu(dev, name):
    """Each module of the library's rows in eval mode, fp32, on the card
    against the same module on the CPU, within 1e-4 of max |CPU|
    (CascadedGroupAttention on the 7 x 7 map of its resolution)."""
    import copy

    import yolo_ad_refine_tpu_torch.models.parser  # noqa: F401 (fills the registry)
    from yolo_ad_refine_tpu_torch.nn.registry import MODULE_REGISTRY

    torch.manual_seed(0)
    side = 7 if name == "CascadedGroupAttention" else 20
    cls = MODULE_REGISTRY[name]
    m = (cls(64, 128, 1) if name.startswith("C2") else cls(64, 64) if name == "GSConv"
         else cls(64)).eval()
    x = torch.randn(2, 64, side, side)
    with torch.no_grad():
        want = m(x)
        got = copy.deepcopy(m).to(dev)(x.to(dev)).cpu()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_dscn_sample_card_matches_cpu(dev):
    from yolo_ad_refine_tpu_torch.ops.dscn import dscn_sample

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 20, 24, 16, generator=g)
    off = torch.rand(2, 20, 24, 4 * 7, generator=g) * 8 - 4
    outs = []
    for d in ("cpu", dev):
        xt, ot = x.to(d).requires_grad_(True), off.to(d).requires_grad_(True)
        y = dscn_sample(xt, ot, 7, "y", pad=3, group=4)
        y.square().sum().backward()
        outs.append([t.detach().cpu() for t in (y, xt.grad, ot.grad)])
    for want, got in zip(*outs):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_697_serving_launches_k1_and_k4(dev):
    """The 697 model (the flagship yaml with C2TSSA_DYT_Mona_EDFFN at layer
    10) served on the card: K1 fwd once a level and K4 once a batch."""
    import copy

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.models.parser import load_model_cfg

    cfg = copy.deepcopy(load_model_cfg("yolo11-701-YOLO-AD-Refine.yaml"))
    cfg["backbone"][10] = [-1, 2, "C2TSSA_DYT_Mona_EDFFN", [1024]]
    model = YOLO(cfg, device=dev, imgsz=320)
    assert model.model.num_params() == 3_667_813
    modulated_deform_conv2d.launches = suppress.launches = 0
    model.predict([np.zeros((320, 320, 3), np.uint8)] * 2, conf=0.001, batch=2)
    assert (modulated_deform_conv2d.launches, suppress.launches) == (3, 1)


def _sam_scene(h=120, w=160):
    rng = np.random.default_rng(0)
    img = rng.integers(150, 240, (h, w, 3), dtype=np.uint8)
    img[30:90, 30:90] = 10
    return img


@pytest.mark.parametrize("variant", ["sam_test", "mobile_sam"])
def test_sam_card_matches_cpu(dev, variant):
    """SAM at 128 px, the same seeded weights on both sides: embeddings
    within 1e-3 of max |CPU|, IoU within 1e-3, masks flipped on at most
    2e-3 of the pixels, for a point and a box."""
    from yolo_ad_refine_tpu_torch.models.sam import SAM

    cpu, card = SAM(variant, 128, device="cpu"), SAM(variant, 128, device=dev)
    img = _sam_scene()
    cpu.set_image(img)
    card.set_image(img)
    e, ce = card._embeddings.cpu(), cpu._embeddings
    assert (e - ce).abs().max() <= 1e-3 * ce.abs().max()
    for kw in (dict(points=[[60, 60]]), dict(box=[30, 30, 90, 90], multimask_output=False)):
        gm, gi = card.predict(**kw)
        wm, wi = cpu.predict(**kw)
        assert np.abs(gi - wi).max() <= 1e-3
        assert (gm != wm).mean() <= 2e-3


def test_sam2_card_matches_cpu(dev):
    """SAM2Predictor and 3 frames of SAM2VideoPredictor (sam2_test, 128)
    card vs CPU: IoU and object logits within 1e-3, masks flipped on at
    most 2e-3 of the pixels."""
    from yolo_ad_refine_tpu_torch.models.sam.sam2 import SAM2Predictor, SAM2VideoPredictor

    img = _sam_scene(96, 120)
    out = [SAM2Predictor("sam2_test", device=d).set_image(img).predict([[60, 48]])
           for d in ("cpu", dev)]
    assert np.abs(out[0][1] - out[1][1]).max() <= 1e-3
    assert (out[0][0] != out[1][0]).mean() <= 2e-3
    frames = [np.roll(_sam_scene(128, 128), 6 * i, axis=1) for i in range(3)]
    runs = []
    for d in ("cpu", dev):
        vp = SAM2VideoPredictor("sam2_test", device=d)
        masks = [vp.add_points(frames[0], 0, [[60, 60]])]
        logits = []
        for i in (1, 2):
            m, lg = vp.track(frames[i], i)
            masks.append(m)
            logits.append(lg)
        runs.append((masks, logits))
    (cm, cl), (gm, gl) = runs
    assert np.abs(np.asarray(cl) - np.asarray(gl)).max() <= 1e-3 * max(1.0, np.abs(cl).max())
    for a, b in zip(cm, gm):
        assert (a != b).mean() <= 2e-3


def test_fastsam_and_nas_launch_k4(dev):
    """FastSAM's everything mode launches K4 once a batch; nas_postprocess
    once a call, with the CPU's counts and rows."""
    from yolo_ad_refine_tpu_torch import FastSAM
    from yolo_ad_refine_tpu_torch.models.nas import nas_postprocess

    fs = FastSAM("yolov8-seg.yaml", device=dev, imgsz=320)
    suppress.launches = 0
    fs.predict([_sam_scene()] * 3, batch=2)
    assert suppress.launches == 2
    r = np.random.default_rng(3)
    xy = r.uniform(0, 600, (4, 2000, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + r.uniform(5, 80, (4, 2000, 2)).astype(np.float32)], -1)
    scores = r.uniform(0, 0.6, (4, 2000, 9)).astype(np.float32)
    suppress.launches = 0
    got = nas_postprocess(boxes, scores, device=dev)
    assert suppress.launches == 1
    want = nas_postprocess(boxes, scores, device="cpu")
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)


def _jpegs(root, shapes=((97, 143), (200, 100), (64, 64), (720, 1280))):
    import cv2

    r = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate(shapes):
        img = cv2.GaussianBlur(r.integers(0, 255, (h, w, 3), np.uint8), (7, 7), 3)
        paths.append(root / f"im{i}.jpg")
        cv2.imwrite(str(paths[-1]), img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    return paths


def test_native_loader_on_the_card_machine_matches_cv2(dev, tmp_path):
    """The native loader as this machine builds it (libjpeg, or nvJPEG
    where libjpeg is missing) against cv2.imread and the port's letterbox:
    mean |diff| < 2 and p99 <= 12 grey levels, ratio and pads within 1e-6
    (the JAX test's limits); an unreadable file is skipped."""
    import cv2

    from yolo_ad_refine_tpu_torch.data.augment import letterbox_np
    from yolo_ad_refine_tpu_torch.ops import native

    paths = _jpegs(tmp_path)
    (tmp_path / "bad.jpg").write_bytes(b"broken")
    files = [paths[0], tmp_path / "bad.jpg", *paths[1:]]
    loader = native.NativeBatchLoader(files, imgsz=96, batch=3, threads=3)
    batches = list(loader)
    loader.close()
    imgs = np.concatenate([b[0] for b in batches])
    meta = np.concatenate([b[1] for b in batches])
    assert len(imgs) == len(paths) and native.loader_decoder() in ("libjpeg", "nvJPEG")
    for p, img, m in zip(paths, imgs, meta):
        ref = cv2.imread(str(p))
        want, (r, _), (dw, dh) = letterbox_np(ref, (96, 96))
        assert m[:2].tolist() == list(ref.shape[:2])
        assert abs(m[2] - r) < 1e-6 and abs(m[3] - dw) < 1e-6 and abs(m[4] - dh) < 1e-6
        diff = np.abs(img.astype(int) - want.astype(int))
        assert diff.mean() < 2.0 and np.percentile(diff, 99) <= 12, (p.name, diff.mean())


def test_explorer_card_matches_cpu(dev, tmp_path):
    """Explorer embeddings of 6 images at batch 4 (the last batch padded)
    from a model with a C3k2_MLCA row, card vs CPU: within 1e-4 of max |CPU|,
    and the same get_similar order (up to swaps of similarities within 1e-5)."""
    import copy

    from yolo_ad_refine_tpu_torch.data.explorer import Explorer
    from yolo_ad_refine_tpu_torch.models.model import build_detection_model

    tiny = {"nc": 2, "backbone": [[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                                  [-1, 1, "C3k2_MLCA", [16, False]], [-1, 1, "Conv", [32, 3, 2]],
                                  [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [32, 3, 2]]],
            "head": [[[3, 4, 5], 1, "Detect", ["nc"]]]}
    (tmp_path / "images").mkdir()
    _jpegs(tmp_path / "images", [(64, 64), (80, 60), (64, 96), (50, 70), (64, 64), (90, 40)])
    cpu = build_detection_model(tiny, device="cpu", imgsz=64)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # weights that tell the images apart: N(0, 1/fan_in), biases N(0, 0.2)
        for p in cpu.parameters():
            std = 1 / math.sqrt(p[0].numel()) if p.ndim > 1 else 0.2
            p.copy_(torch.randn(p.shape, generator=g) * std)
    card = copy.deepcopy(cpu).to(dev)
    embs, sims = [], []
    for m in (cpu, card):
        ex = Explorer(img_path=tmp_path / "images", model=m, imgsz=64, batch=4)
        embs.append(ex.create_embeddings_table())
        sims.append(ex.get_similar(0, limit=6))
    assert np.abs(embs[1] - embs[0]).max() <= 1e-4 * np.abs(embs[0]).max()
    want = {r["idx"]: r["similarity"] for r in sims[0]}
    assert [r["idx"] for r in sims[1]] == [r["idx"] for r in sims[0]] or all(
        want[a["idx"]] >= want[b["idx"]] - 1e-5 for a, b in zip(sims[1], sims[1][1:]))
