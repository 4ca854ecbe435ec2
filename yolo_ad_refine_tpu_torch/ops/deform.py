"""Modulated deformable convolution (DCNv2), 3x3 / stride 1 / pad 1.

Counterpart of ``yolo_ad_refine_tpu/ops/deform.py`` (the exact gather, the
reference's mmcv semantics) and of the TPU kernel
``ops/deform_mxu2.py::modulated_deform_conv2d_mxu2``:

- ``deform_conv2d_plain`` is a line-by-line PyTorch port of the JAX exact
  gather, in its NHWC / HWIO layout. The CPU path and the kernel's checks use
  it.
- ``modulated_deform_conv2d`` is what the model calls, on channels_last
  NCHW tensors, through the dispatcher op ``yat_ad::dcn_forward`` and its
  backward op ``yat_ad::dcn_backward`` (``register_dcn_ops``, which K2 and
  K3 use too). A CPU tensor takes the plain version; a CUDA tensor
  launches K1 fwd (``dcn_forward``) and, in the backward, K1 bwd
  (``dcn_backward``), the port of ``deform_mxu2.py::_bwd_kernel``, or
  raises. There is no fallback. Being ops, the kernels stay in a
  ``torch.export`` or ``torch.jit.trace`` program (``engine/exporter.py``).
- ``deform_conv2d_grads_plain`` is K1 bwd's plain version (autograd of the
  plain forward): the CPU implementation of ``yat_ad::dcn_backward``.

``radius=None`` samples unbounded (mmcv, ``ops/deform.py``), and its
positional derivative at an integral sample coordinate is autodiff's
one-sided one. An integer radius clips the offsets to +-radius first and
takes the TPU kernel's hat derivative, which is 0 along an axis where the
sample coordinate is integral (``deform_mxu2.py:71-76``).

``dcn_impl`` picks the implementation ``DyDCNv2`` runs, from the JAX
package's ``YAT_DCN_IMPL`` and ``YAT_DCN_RADIUS`` (``nn/head.py:517-523``):
K1 unbounded (``auto``, ``exact``), K1 at the radius (``mxu2``), K2
(``mxu``, ``ops/deform_mxu.py``) or K3 (``pallas``, ``ops/deform_pallas.py``).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os

import torch

from yolo_ad_refine_tpu_torch.utils import kernels

K = 3
KK = K * K
SMEM_PER_BLOCK = 232_448  # bytes of shared memory a Hopper block may use
DCN_IMPLS = ("auto", "mxu2", "mxu", "pallas", "exact")  # YAT_DCN_IMPL's values
# csrc/deform_conv.cu's tiles: pixels a block tile, input channels a forward
# step, output channels a forward block, stages of the forward's weight
# ring, the C / Cout a backward block takes (wider shapes take chunk pairs)
K1_TILE_PIXELS, K1_FWD_KC, K1_FWD_NMAX, K1_FWD_STAGES, K1_BWD_CMAX = 64, 32, 64, 3, 128


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def k1_launch(kernel: str, c: int, cout: int, dtype: torch.dtype) -> dict:
    """The launch arithmetic of K1 (``csrc/deform_conv.cu``) for ``kernel``
    "fwd" or "bwd" at C input and Cout output channels in ``dtype``: the
    padded mma dimensions and the shared memory of one block, in bytes (the
    kernel computes the same; ``dcn_smem_bytes`` reports it). Raises
    ValueError, naming the bound, for a shape that cannot launch.

    Forward: a block takes 64 pixels x up to 64 output channels (``np``,
    padded to 16) and walks (tap, 32-channel) steps with a 3-stage ring of
    weight chunks, two sample buffers (rows of 32 channels + 4 words) and
    the corner tables; the weight is passed as ``k1_fwd_weight`` lays it
    out, C zero-padded to ``cpad``. Backward: a block takes at most 128
    channels and 128 output channels, because its dW_t sits in mma
    accumulators; C and Cout pad to 16 (``cpn``, ``cok``, of the first
    chunk), and the tap's weight, two g tiles (with the tap's offsets and
    mask), gs (fp32) and m * sampled sit in shared memory. Past 128 the
    kernel runs ``wide``: ``pairs`` blocks, one a (C-chunk, Cout-chunk)
    pair, share each tile, and doffset and dmask become fp64 sums."""
    isz = 2 if dtype == torch.bfloat16 else 4
    tp = K1_TILE_PIXELS
    if kernel == "fwd":
        np_ = _round_up(min(cout, K1_FWD_NMAX), 16)
        rw = K1_FWD_KC * isz // 4 + 4
        smem = 4 * (K1_FWD_STAGES * np_ * rw + 2 * tp * rw + KK * tp * 4 * 2)
        out = {"np": np_, "cpad": _round_up(c, K1_FWD_KC), "smem": smem}
    elif kernel == "bwd":
        if c < 1 or cout < 1:
            raise ValueError(f"dcn_backward: C={c}, Cout={cout} must both be at least 1")
        cpn, cok = _round_up(min(c, K1_BWD_CMAX), 16), _round_up(min(cout, K1_BWD_CMAX), 16)
        rw_o, rw_c, rw_s = cok * isz // 4 + 4, cpn * isz // 4 + 4, cpn + 4
        smem = 4 * (cpn * rw_o + 2 * tp * rw_o + tp * rw_s + tp * rw_c + 2 * tp * 4)
        pairs = -(-c // K1_BWD_CMAX) * -(-cout // K1_BWD_CMAX)
        out = {"cpn": cpn, "cok": cok, "smem": smem, "wide": c > K1_BWD_CMAX or cout > K1_BWD_CMAX,
               "pairs": pairs}
    else:
        raise ValueError(f"kernel must be 'fwd' or 'bwd', got {kernel!r}")
    if out["smem"] > SMEM_PER_BLOCK:
        raise ValueError(f"dcn_{'forward' if kernel == 'fwd' else 'backward'}: C={c}, Cout={cout} "
                         f"need {out['smem']} bytes of shared memory per block, more than the "
                         f"{SMEM_PER_BLOCK} a block may use")
    return out


def dcn_impl(radius: float = 3.0):
    """(function, radius) that ``DyDCNv2`` calls, read from the environment
    at each call as the JAX ``DyDCNv2`` reads it at each trace
    (``nn/head.py:517-523``). ``YAT_DCN_IMPL``: ``auto`` and ``exact`` give
    K1 unbounded (the JAX package's choice off the TPU, so ``auto`` keeps
    the earlier slices' semantics), ``mxu2`` K1 at the radius, ``mxu`` K2,
    ``pallas`` K3. ``YAT_DCN_RADIUS`` overrides ``radius``; both are cut to
    an integer. An unknown value raises, where the JAX package silently
    takes ``exact`` (ROADMAP Queue 3): a typo must not hide the kernel."""
    impl = os.environ.get("YAT_DCN_IMPL", "auto")
    if impl not in DCN_IMPLS:
        raise ValueError(f"YAT_DCN_IMPL={impl!r} is none of {', '.join(DCN_IMPLS)}")
    r_env = os.environ.get("YAT_DCN_RADIUS")
    r = int(float(r_env)) if r_env else int(radius)
    if impl in ("auto", "exact"):
        return modulated_deform_conv2d, None
    if impl == "mxu2":
        return modulated_deform_conv2d, r
    if impl == "mxu":
        from yolo_ad_refine_tpu_torch.ops.deform_mxu import modulated_deform_conv2d_mxu

        return modulated_deform_conv2d_mxu, r
    from yolo_ad_refine_tpu_torch.ops.deform_pallas import modulated_deform_conv2d_pallas

    return modulated_deform_conv2d_pallas, r


def _bilinear_sample(x_flat, coords_y, coords_x, h: int, w: int, hat: bool = False):
    """Bilinearly sample x_flat (B, H*W, C) at float coords (B, N).

    Corners outside the map contribute zero (mmcv convention). The map is
    zero-padded by 1 so each sample reads one 2x2 block; coordinates beyond
    the pad ring clip into it and get zero weight. With ``hat`` the
    derivative along an axis is 0 where that coordinate is integral.
    """
    b, n = coords_y.shape
    c = x_flat.shape[-1]
    xp = torch.nn.functional.pad(x_flat.reshape(b, h, w, c), (0, 0, 1, 1, 1, 1))
    xp = xp.reshape(b, (h + 2) * (w + 2), c)

    y0 = torch.floor(coords_y)
    x0 = torch.floor(coords_x)
    ly = coords_y - y0
    lx = coords_x - x0
    if hat:
        ly = torch.where(ly == 0, ly.detach(), ly)
        lx = torch.where(lx == 0, lx.detach(), lx)
    iy = (y0.long() + 1).clamp(0, h)
    ix = (x0.long() + 1).clamp(0, w)
    rows = torch.stack([iy, iy, iy + 1, iy + 1], dim=-1)
    cols = torch.stack([ix, ix + 1, ix, ix + 1], dim=-1)
    flat = (rows * (w + 2) + cols).reshape(b, n * 4, 1).expand(b, n * 4, c)
    blocks = torch.gather(xp, 1, flat).reshape(b, n, 2, 2, c)

    in_y = ((y0 >= -1) & (y0 <= h - 1)).to(ly.dtype)
    in_x = ((x0 >= -1) & (x0 <= w - 1)).to(lx.dtype)
    wy = torch.stack([1.0 - ly, ly], dim=-1) * in_y[..., None]  # (B, N, 2)
    wx = torch.stack([1.0 - lx, lx], dim=-1) * in_x[..., None]
    weights = (wy[:, :, :, None] * wx[:, :, None, :]).to(x_flat.dtype)  # (B, N, 2, 2)
    return torch.einsum("bnyx,bnyxc->bnc", weights, blocks)


def deform_conv2d_plain(x, offset, mask, weight, radius: int | None = None, bias=None):
    """DCNv2 forward in plain PyTorch. x (B,H,W,C), offset (B,H,W,2k²),
    mask (B,H,W,k²), weight (k,k,C,Cout) HWIO, k odd (3 for K1), stride 1,
    padding k // 2; ``bias`` (Cout,) is added to the sums before the cast,
    as the JAX function adds it. Returns (B,H,W,Cout) in x.dtype,
    accumulated in fp32 (fp64 for fp64 inputs, for gradcheck).

    With an integer ``radius`` the offsets are clipped to +-radius and pass
    gradient only where |offset| < radius, as the TPU kernel's VJP does
    (``deform_mxu2.py:483``), and the derivative along an axis is 0 where
    the sample coordinate is integral (its ``_dhat``)."""
    b, h, w, c = x.shape
    k = weight.shape[0]
    kk = k * k
    cout = weight.shape[-1]
    pad = k // 2
    dev = x.device
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    x_flat = x.reshape(b, h * w, c)

    gy = torch.arange(h, dtype=acc, device=dev)[:, None]
    gx = torch.arange(w, dtype=acc, device=dev)[None, :]
    base_y = torch.broadcast_to(gy, (h, w)).reshape(1, h * w, 1)
    base_x = torch.broadcast_to(gx, (h, w)).reshape(1, h * w, 1)
    tap_dy = torch.tensor([t // k - pad for t in range(kk)], dtype=acc, device=dev)
    tap_dx = torch.tensor([t % k - pad for t in range(kk)], dtype=acc, device=dev)

    offset = offset.to(acc).reshape(b, h * w, kk, 2)
    if radius is not None:
        r = float(radius)
        offset = torch.where(offset.abs() < r, offset, offset.clamp(-r, r).detach())
    cy = (base_y + tap_dy[None, None, :] + offset[..., 0]).reshape(b, h * w * kk)
    cx = (base_x + tap_dx[None, None, :] + offset[..., 1]).reshape(b, h * w * kk)

    sampled = _bilinear_sample(x_flat, cy, cx, h, w, hat=radius is not None)  # (B, HW*kk, C)
    sampled = sampled * mask.reshape(b, h * w * kk, 1).to(sampled.dtype)
    sampled = sampled.reshape(b, h * w, kk * c)
    w_mat = weight.reshape(kk * c, cout)
    out = torch.matmul(sampled.to(acc), w_mat.to(acc))
    if bias is not None:
        out = out + bias.to(acc)
    return out.reshape(b, h, w, cout).to(x.dtype)


def deform_conv2d_grads_plain(x, offset, mask, weight, g, radius: int | None = None):
    """The plain version of K1 bwd: (dx, doffset, dmask, dweight) of
    ``deform_conv2d_plain`` for the incoming gradient g (B,H,W,Cout), by
    autograd, in the layouts of ``deform_conv2d_plain``. The tests and the
    card's smoke run hold the kernel against it."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, offset, mask, weight)]
        y = deform_conv2d_plain(*ins, radius=radius)
        return torch.autograd.grad(y, ins, g.to(y.dtype))


def _nhwc(t: torch.Tensor, name: str) -> torch.Tensor:
    v = t.permute(0, 2, 3, 1)
    if not v.is_contiguous():
        raise ValueError(f"{name} must be a channels_last NCHW tensor (contiguous NHWC view)")
    return v


def _check(x, offset, mask, weight, radius):
    """Device, type and shape checks of the CUDA wrappers (the kernels take
    nothing else)."""
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
    return b, c, h, w, cout


def k1_fwd_weight(weight: torch.Tensor, cpad: int) -> torch.Tensor:
    """K1 fwd's weight operand: (Cout, C, 3, 3) as (9, Cout, cpad), each
    tap's slice transposed (rows are output channels, as the mma's B
    operand is read) and C zero-padded to ``cpad``."""
    cout, c = weight.shape[:2]
    return torch.nn.functional.pad(weight.permute(2, 3, 0, 1).reshape(KK, cout, c),
                                   (0, cpad - c)).contiguous()


def dcn_forward(x, offset, mask, weight, radius: int | None = None):
    """K1 fwd on CUDA tensors (channels_last NCHW, see
    ``modulated_deform_conv2d``): launches ``csrc/deform_conv.cu`` or raises."""
    b, c, h, w, cout = _check(x, offset, mask, weight, radius)
    cpad = k1_launch("fwd", c, cout, x.dtype)["cpad"]
    xv, ov, mv = _nhwc(x, "x"), _nhwc(offset, "offset"), _nhwc(mask, "mask")
    wt = k1_fwd_weight(weight, cpad)
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    lib = kernels.load("deform_conv")
    fn = lib.dcn_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                                                  ctypes.c_void_p]
    status = fn(xv.data_ptr(), ov.data_ptr(), mv.data_ptr(), wt.data_ptr(), out.data_ptr(),
                b, h, w, c, cout, cpad, -1.0 if radius is None else float(radius),
                0 if x.dtype == torch.float32 else 1,
                torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(lib, status, "dcn_forward")
    modulated_deform_conv2d.launches += 1
    return out


def dcn_backward(x, offset, mask, weight, g, radius: int | None = None):
    """K1 bwd on CUDA tensors: (dx, doffset, dmask, dweight) of
    ``modulated_deform_conv2d`` for the incoming gradient g (B,Cout,H,W),
    which is taken in x.dtype and made channels_last here. dx and dweight
    are summed in fp64 by the kernel (with atomics, whose order changes from
    run to run) and rounded to x.dtype / weight.dtype here; doffset and
    dmask are fp32, written once, or past 128 channels (``k1_launch``'s
    ``wide``) fp64 sums of the chunk pairs' partials rounded here. Launches
    ``csrc/deform_conv.cu`` or raises."""
    wide = k1_launch("bwd", x.shape[1], weight.shape[0], x.dtype)["wide"]
    b, c, h, w, cout = _check(x, offset, mask, weight, radius)
    if tuple(g.shape) != (b, cout, h, w) or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} on {g.device} does not match the output "
                         f"({b}, {cout}, {h}, {w}) on {x.device}")
    g = g.to(x.dtype).contiguous(memory_format=torch.channels_last)
    xv, ov, mv, gv = _nhwc(x, "x"), _nhwc(offset, "offset"), _nhwc(mask, "mask"), _nhwc(g, "g")
    wk = weight.permute(2, 3, 1, 0).reshape(KK, c, cout).contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    f64 = dict(dtype=torch.float64, device=x.device)
    dx = torch.zeros((b, h, w, c), **f64)           # the kernel adds into dx and dw
    if wide:  # the kernel adds the chunk pairs' doff and dmask
        doff, dmask = torch.zeros((b, h, w, 2 * KK), **f64), torch.zeros((b, h, w, KK), **f64)
    else:     # the kernel writes all of doff and dmask
        doff, dmask = torch.empty((b, h, w, 2 * KK), **f32), torch.empty((b, h, w, KK), **f32)
    dw = torch.zeros((KK, c, cout), **f64)
    if b * h * w > 0:
        lib = kernels.load("deform_conv")
        fn = lib.dcn_backward
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                                                      ctypes.c_void_p]
        status = fn(xv.data_ptr(), ov.data_ptr(), mv.data_ptr(), wk.data_ptr(), gv.data_ptr(),
                    dx.data_ptr(), doff.data_ptr(), dmask.data_ptr(), dw.data_ptr(),
                    b, h, w, c, cout, -1.0 if radius is None else float(radius),
                    0 if x.dtype == torch.float32 else 1,
                    torch.cuda.current_stream(x.device).cuda_stream)
        kernels.check(lib, status, "dcn_backward")
        dcn_backward.launches += 1
    dweight = dw.reshape(K, K, c, cout).permute(3, 2, 0, 1).to(weight.dtype)
    return (dx.permute(0, 3, 1, 2).to(x.dtype), doff.permute(0, 3, 1, 2).float(),
            dmask.permute(0, 3, 1, 2).float(), dweight)


DCN_NAMESPACE = "yat_ad"  # the port's dispatcher ops: torch.ops.yat_ad.<kernel wrapper's name>
_FWD_SCHEMA = "(Tensor x, Tensor offset, Tensor mask, Tensor weight, {r} radius) -> Tensor"
_BWD_SCHEMA = ("(Tensor x, Tensor offset, Tensor mask, Tensor weight, Tensor g, {r} radius) -> "
               "(Tensor, Tensor, Tensor, Tensor)")


def register_dcn_ops(name: str, plain_fwd, kernel_fwd, plain_bwd, kernel_bwd,
                     radius_type: str = "int"):
    """Register one DCN variant as two dispatcher ops, ``yat_ad::<name>`` and
    ``yat_ad::<bwd name>`` (the CUDA wrappers' names), and return them.

    Each op takes channels_last NCHW tensors (x, offset, mask, weight as
    ``modulated_deform_conv2d`` takes them, and g for the backward) and a
    radius of ``radius_type`` ("float?" for K1, whose None samples
    unbounded; "int" for K2 / K3). Its CUDA implementation launches the
    kernel through ``kernel_fwd`` / ``kernel_bwd`` (which count their
    launches); its CPU implementation runs ``plain_fwd`` / ``plain_bwd``
    in the NHWC / HWIO layouts; its fake implementation gives the shapes,
    types and layouts (outputs and dx, doffset, dmask channels_last,
    dweight contiguous), so ``torch.export`` and ``torch.jit.trace`` record
    the op itself; the forward's autograd calls the backward op. One route
    for every caller: eager training and serving, and an exported program."""
    cl = torch.channels_last
    bwd_name = kernel_bwd.__name__

    def nhwc_args(x, offset, mask, weight):
        return (*(t.permute(0, 2, 3, 1) for t in (x, offset, mask)), weight.permute(2, 3, 1, 0))

    def grads_nchw(dx, doff, dmask, dw):
        return (*(t.contiguous(memory_format=cl) for t in (dx, doff, dmask)), dw.contiguous())

    def cpu_fwd(x, offset, mask, weight, radius):
        y = plain_fwd(*nhwc_args(x, offset, mask, weight), radius)
        return y.permute(0, 3, 1, 2).contiguous(memory_format=cl)

    def cpu_bwd(x, offset, mask, weight, g, radius):
        dx, doff, dmask, dw = plain_bwd(*nhwc_args(x, offset, mask, weight),
                                        g.permute(0, 2, 3, 1), radius)
        return grads_nchw(dx.permute(0, 3, 1, 2), doff.permute(0, 3, 1, 2),
                          dmask.permute(0, 3, 1, 2), dw.permute(3, 2, 0, 1))

    fwd = torch.library.custom_op(f"{DCN_NAMESPACE}::{name}", cpu_fwd, mutates_args=(),
                                  device_types="cpu", schema=_FWD_SCHEMA.format(r=radius_type))
    bwd = torch.library.custom_op(f"{DCN_NAMESPACE}::{bwd_name}", cpu_bwd, mutates_args=(),
                                  device_types="cpu", schema=_BWD_SCHEMA.format(r=radius_type))

    # the kernel wrappers check the inputs (channels_last among them) and raise
    fwd.register_kernel("cuda")(kernel_fwd)

    @bwd.register_kernel("cuda")
    def _(x, offset, mask, weight, g, radius):
        return grads_nchw(*kernel_bwd(x, offset, mask, weight, g, radius))

    @fwd.register_fake
    def _(x, offset, mask, weight, radius):
        b, _, h, w = x.shape
        return torch.empty((b, weight.shape[0], h, w), dtype=x.dtype, device=x.device,
                           memory_format=cl)

    @bwd.register_fake
    def _(x, offset, mask, weight, g, radius):
        return (torch.empty_like(x, memory_format=cl), torch.empty_like(offset, memory_format=cl),
                torch.empty_like(mask, memory_format=cl),
                torch.empty_like(weight, memory_format=torch.contiguous_format))

    def setup_context(ctx, inputs, output):
        x, offset, mask, weight, radius = inputs
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.radius = radius

    def backward(ctx, g):
        return (*bwd(*ctx.saved_tensors, g, ctx.radius), None)

    fwd.register_autograd(backward, setup_context=setup_context)
    return fwd, bwd


def _grads_plain_on_a_fresh_thread(x, offset, mask, weight, g, radius):
    """``deform_conv2d_grads_plain`` for the CPU implementation of
    ``yat_ad::dcn_backward``. It differentiates the plain forward with
    autograd, which the dispatcher has switched off on the thread that
    runs an op's kernel (its autograd keys are excluded there); a new
    thread starts from the dispatcher's default state."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(deform_conv2d_grads_plain, x, offset, mask, weight, g, radius).result()


dcn_forward_op, dcn_backward_op = register_dcn_ops(
    "dcn_forward", deform_conv2d_plain, dcn_forward, _grads_plain_on_a_fresh_thread, dcn_backward,
    radius_type="float?")


def modulated_deform_conv2d(x, offset, mask, weight, bias=None, k: int = 3, *,
                            radius: int | None = None):
    """DCNv2 on channels_last NCHW tensors, with the JAX function's
    parameters (``ops/deform.py:133``): x (B,C,H,W), offset (B,2k²,H,W)
    fp32, mask (B,k²,H,W) fp32, weight (Cout,C,k,k), cast to x.dtype here
    as the JAX DyDCNv2 does (its gradient flows back through the cast),
    ``bias`` (Cout,) or None, stride 1 and padding k // 2. Returns
    (B,Cout,H,W) channels_last in x.dtype, differentiable in every input.

    ``k`` picks the route, never a failure: k = 3 calls the dispatcher op
    ``yat_ad::dcn_forward`` (its backward ``yat_ad::dcn_backward``), whose
    CPU implementation runs ``deform_conv2d_plain`` (and the autograd of
    it) and whose CUDA one launches the kernels of ``csrc/deform_conv.cu``
    (K1 fwd, and K1 bwd in the backward) or raises. Any other odd k runs
    ``deform_conv2d_plain`` on the tensor's device, CPU or card: the JAX
    function is plain JAX there, with no Pallas kernel behind it. An even
    k raises. The bias is added in fp32 and the sum cast to x.dtype, as in
    JAX; for k = 3 it is added to K1's output, which in bf16 has been
    rounded once already. ``radius`` (keyword only, the port's): clip the
    offsets at +-radius and take the hat derivative (module docstring)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"modulated_deform_conv2d: unsupported device {x.device}")
    if k < 1 or k % 2 == 0:
        raise ValueError(f"modulated_deform_conv2d: k={k}; the kernel size must be odd")
    if tuple(weight.shape[-2:]) != (k, k):
        raise ValueError(f"modulated_deform_conv2d: weight {tuple(weight.shape)} is not "
                         f"(Cout, C, {k}, {k}) for k={k}")
    weight = weight.to(x.dtype)
    if k != K:
        y = deform_conv2d_plain(x.permute(0, 2, 3, 1), offset.permute(0, 2, 3, 1),
                                mask.permute(0, 2, 3, 1), weight.permute(2, 3, 1, 0), radius,
                                bias)
        return y.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    y = dcn_forward_op(x, offset, mask, weight, None if radius is None else float(radius))
    if bias is None:
        return y
    return (y.float() + bias.float()[:, None, None]).to(x.dtype)


modulated_deform_conv2d.launches = 0
dcn_backward.launches = 0
