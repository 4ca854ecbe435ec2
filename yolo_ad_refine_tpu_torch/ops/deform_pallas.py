"""Bounded-window modulated deformable convolution (K3).

Counterpart of ``yolo_ad_refine_tpu/ops/deform_pallas.py`` (the TPU kernel
``modulated_deform_conv2d_pallas``, its ``_fwd_kernel`` :67 and
``_bwd_kernel`` :122). No Pallas is involved: the CUDA kernels
``dcn_window_forward`` / ``dcn_window_backward`` in ``csrc/deform_window.cu``
take its place, and the plain PyTorch versions here repeat its arithmetic.

The function is 3x3 DCNv2 (``ops/deform.py``) with the offsets clipped to
+-radius, sampled with the hat weights hat(u) = max(0, 1 - |u|) at the two
window positions floor(u) and floor(u) + 1 of each axis, where an axis's
coordinate is offset - k for the integer window shift k
(``deform_pallas.py:90,98``). Its derivative is the hat's, -sign(u) on
|u| < 1, so d offset is 0 along an axis where the sample coordinate is
integral, and 0 where |offset| >= radius (the clip's VJP, :338).

Rounding, as the TPU kernel: in bf16 the samples are taken in fp32, the
modulated sample is rounded to bf16 and contracted bf16 x bf16 with fp32
sums (:104, :256); the backward is all fp32 (:294-342).

``ops/deform_mxu.py`` (K2) computes the same function in the separable
form and shares the helpers here: ``window_taps`` (with ``separable`` for
K2's coordinates), ``window_forward_plain`` and ``window_grads_plain``,
and the CUDA wrappers ``_forward`` / ``_backward``. The forward kernel's
launch plan (channel chunk, shared memory, grid, and the global mode for a
radius whose window fits no block) is ``window_fwd_launch``; its products
run on the tensor cores (3xTF32 in fp32, bf16 for K3's bf16, 2xTF32 for
K2's). The backward kernel's plan is ``window_bwd_launch`` (16 channels x
64 output channels a block, tile groups, the global mode past radius 3 in
fp32 and 7 in bf16); its products run on the tensor cores too (3xTF32 in
fp32; with bf16 inputs one TF32 product for g . W_t^T and 2xTF32 for the
fp32 sample against g). ``tests/test_torch_dcn_window_mma.py`` models both
kernels' products on the CPU.

Layouts: the plain versions take NHWC x (B,H,W,C), offset (B,H,W,18) as
(dy, dx) pairs, mask (B,H,W,9) and an HWIO weight (3,3,C,Cout);
``modulated_deform_conv2d_pallas`` takes channels_last NCHW tensors as
``ops/deform.py::modulated_deform_conv2d`` does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yolo_ad_refine_tpu_torch.ops.deform import KK, SMEM_PER_BLOCK, _check, _nhwc, k1_fwd_weight
from yolo_ad_refine_tpu_torch.utils import kernels

MXU_CH = 8  # output rows per chunk of deform_mxu.py (its CH): K2's y coordinate is chunk-local
# csrc/deform_window.cu's forward: a block tiles 8 x 16 output pixels with
# 512 threads (one block an SM by its registers) and takes 64 or 128 output
# channels; a chunk's row (a window position, a weight row) holds 16 to 128
# bytes; each of the 9 x 128 geometry entries takes 6 words (7 in the
# global mode)
WIN_FWD_TILE, WIN_FWD_THREADS, WIN_ROW_BYTES = (8, 16), 512, 128
# its backward: the same tiles and threads, 16 channels and 64 output
# channels a block (two mma n-tiles of channels; g and weight rows padded by
# 8 words, sample rows by 8), one block an SM; H100_SMS sizes the tile
# groups when the card is not asked (the CPU tests)
WIN_BWD_CC, WIN_BWD_NO, H100_SMS = 16, 64, 132


def window_fwd_smem(radius: int, cc: int, nb: int, dtype: torch.dtype, separable: bool,
                    global_: bool) -> int:
    """Shared bytes of one K2 / K3 fwd block (``csrc/deform_window.cu``'s
    ``dcn_window_fwd_smem_bytes`` computes the same): two window chunks of
    (8 + 2(r + 2)) x (16 + 2(r + 2)) positions x ``cc`` (none in the global
    mode), two sample tiles and two weight tiles of ``nb`` rows, each row ks
    + 4 words (fp32 weights as hi and lo planes; K2's bf16 tiles are fp32),
    and the geometry of 9 x 128 samples."""
    bf = dtype == torch.bfloat16
    isz = 2 if bf else 4
    f32 = not bf or separable          # TF32 products on fp32 tiles
    mk = 8 if f32 else 16              # k of one mma
    th, tw = WIN_FWD_TILE
    npos = (th + 2 * (radius + 2)) * (tw + 2 * (radius + 2))
    rw = max(cc, mk) * (4 if f32 else 2) // 4 + 4
    window = 0 if global_ else 2 * npos * cc * isz // 4
    return 4 * (window + 2 * th * tw * rw + 2 * (1 if bf else 2) * nb * rw
                + KK * th * tw * (7 if global_ else 6))


def window_fwd_launch(radius: int, c: int, cout: int, dtype: torch.dtype, aligned: bool = True, *,
                      separable: bool = False, b: int = 1, h: int = 1, w: int = 1) -> dict:
    """The launch plan of K2 / K3 fwd (``csrc/deform_window.cu``) at
    ``radius``, C input and Cout output channels in ``dtype``; ``aligned``:
    x's pointer is 16-byte aligned; ``separable``: K2. Returns the channel
    chunk ``cc``, the k of a step ``ks`` (cc, or one mma's k when cc is
    narrower), output channels a block ``nb``, 16-byte window copies
    ``vec16``, the mode ``global``, the weight's padded C ``cpad``, shared
    bytes ``smem`` (``window_fwd_smem``), ``grid`` for a (b, h, w) map and
    ``block``.

    The launch rule: ``nb`` is 128 past 64 output channels where 16-byte
    copies are allowed, else 64. ``cc`` is the widest power of two up to
    128 bytes a row, no wider than C needs, whose block fits. Where not even
    16 bytes a row fit (from radius 29 or 30 in fp32, 30 or 31 in bf16, by
    the widths), the global mode takes over: no window is staged, the
    samples read their corners from global memory, the block takes 64
    channels and ``cc`` is the widest allowed. Raises ValueError for a negative radius or an empty width."""
    if radius < 0 or c < 1 or cout < 1:
        raise ValueError(f"window forward: radius={radius}, C={c}, Cout={cout}: the radius must be "
                         ">= 0 and the widths >= 1")
    isz = 2 if dtype == torch.bfloat16 else 4
    mk = 16 if dtype == torch.bfloat16 and not separable else 8
    vec16 = bool(aligned) and (c * isz) % 16 == 0
    nb = 128 if cout > 64 and vec16 else 64
    widths = [WIN_ROW_BYTES // isz >> i for i in range(4)]  # 128 down to 16 bytes
    cap = max(widths[-1], 1 << (c - 1).bit_length())  # no chunk wider than C needs
    cands = [k for k in widths if k <= cap]
    fit = [k for k in cands if window_fwd_smem(radius, k, nb, dtype, separable, False)
           <= SMEM_PER_BLOCK]
    global_ = not fit
    if global_:
        nb, fit = 64, cands
    cc = max(fit)
    th, tw = WIN_FWD_TILE
    tiles = b * -(-h // th) * -(-w // tw)
    return {"cc": cc, "ks": max(cc, mk), "nb": nb, "vec16": vec16, "global": global_,
            "cpad": -(-c // cc) * cc, "smem": window_fwd_smem(radius, cc, nb, dtype, separable,
                                                              global_),
            "grid": (tiles, -(-cout // nb)), "block": WIN_FWD_THREADS}


def window_bwd_smem(radius: int, dtype: torch.dtype, global_: bool) -> int:
    """Shared bytes of one K2 / K3 bwd block (``csrc/deform_window.cu``'s
    ``dcn_window_bwd_smem_bytes`` computes the same). The window mode's
    own: the x window chunk of (8 + 2(r + 2)) x (16 + 2(r + 2)) positions x
    16 channels, m * gs of the 9 x 128 samples x 16 channels in fp32, and
    each position's list of the samples that reach it (a start and a count
    a position, a 16-bit entry a (tap, pixel, corner)). Both modes: two
    weight tiles of 16 rows and the g tile of 128 rows, each row 64 + 8
    words, two sample tiles of 128 rows of 16 + 8 words, two corner-dot
    tiles of 2 x 128 x 4 words, and the geometry of 9 x 128 samples at 7
    words (8 in the global mode)."""
    isz = 2 if dtype == torch.bfloat16 else 4
    th, tw = WIN_FWD_TILE
    tp = th * tw
    npos = (th + 2 * (radius + 2)) * (tw + 2 * (radius + 2))

    def align16(n):
        return -(-n // 16) * 16

    window = 0 if global_ else (align16(npos * WIN_BWD_CC * isz) + 4 * KK * tp * WIN_BWD_CC
                                + align16(4 * (npos + 1)) + align16(4 * npos) + 2 * KK * tp * 4)
    row, mrow = WIN_BWD_NO + 8, WIN_BWD_CC + 8
    return window + 4 * (2 * WIN_BWD_CC * row + tp * row + 2 * tp * mrow + 2 * 2 * tp * 4
                         + KK * tp * (8 if global_ else 7))


@functools.lru_cache(maxsize=256)
def _bwd_groups(tiles: int, chunks: int, sms: int) -> int:
    """Tile groups of the backward: the fewest that minimise the waves of
    ``groups * chunks`` one-block-an-SM blocks times the tiles a block walks
    plus one (a block's set-up and its dW sums cost about a tile)."""
    return min(range(1, min(tiles, 4 * sms) + 1),
               key=lambda n: (-(-n * chunks // sms) * (-(-tiles // n) + 1), n))


def window_bwd_launch(radius: int, c: int, cout: int, dtype: torch.dtype, aligned: bool = True,
                      *, b: int = 1, h: int = 1, w: int = 1, sms: int = H100_SMS) -> dict:
    """The launch plan of K2 / K3 bwd (``csrc/deform_window.cu``) at
    ``radius``, C input and Cout output channels in ``dtype``; ``aligned``:
    x's and g's pointers are 16-byte aligned; ``sms``: the card's SMs.
    Returns the channels ``cc`` and output channels ``no`` a block takes,
    16-byte loads ``vec16``, the mode ``global``, shared bytes ``smem``
    (``window_bwd_smem``), the tile groups ``groups``, ``grid`` for a
    (b, h, w) map and ``block``.

    The launch rule: a block takes 16 channels and 64 output channels and
    walks a group of 8 x 16 tiles; the window mode wherever its block fits
    (to radius 3 in fp32, 7 in bf16), the global mode (corners from global
    memory, dx added there) from the next radius on. ``groups`` minimises
    the waves of one-block-an-SM blocks times the tiles a block walks (plus
    one for its set-up), the fewest groups among equals. Raises ValueError
    for a negative radius or an empty width."""
    if radius < 0 or c < 1 or cout < 1:
        raise ValueError(f"window backward: radius={radius}, C={c}, Cout={cout}: the radius must "
                         "be >= 0 and the widths >= 1")
    isz = 2 if dtype == torch.bfloat16 else 4
    vec16 = bool(aligned) and (c * isz) % 16 == 0 and (cout * isz) % 16 == 0
    global_ = window_bwd_smem(radius, dtype, False) > SMEM_PER_BLOCK
    th, tw = WIN_FWD_TILE
    tiles = b * -(-h // th) * -(-w // tw)
    groups = _bwd_groups(tiles, -(-c // WIN_BWD_CC) * -(-cout // WIN_BWD_NO), sms)
    return {"cc": WIN_BWD_CC, "no": WIN_BWD_NO, "vec16": vec16, "global": global_,
            "smem": window_bwd_smem(radius, dtype, global_), "groups": groups,
            "grid": (groups, -(-c // WIN_BWD_CC), -(-cout // WIN_BWD_NO)),
            "block": WIN_FWD_THREADS}


def _hat(u):
    return (1.0 - u.abs()).clamp(min=0.0)


def _dhat(u):
    return torch.where(u.abs() < 1.0, -torch.sign(u), torch.zeros_like(u))


def window_taps(offset, radius: int, separable: bool):
    """Sampling geometry of every (pixel, tap) for clipped offsets
    (B,H,W,18): (index, wy, wx, dwy, dwx). ``index`` (B, H*W*9, 2, 2)
    indexes the map zero-padded by s = radius + 2 on each side (flattened),
    for rows floor and floor + 1 and columns floor and floor + 1; the hat
    weights and their derivatives are (B, H*W*9, 2) per axis, in the
    offset's type. ``separable``: K2's coordinates (``deform_mxu.py:118,
    122``), else K3's."""
    b, h, w, _ = offset.shape
    r, s = int(radius), int(radius) + 2
    wp = w + 2 * s
    dev, dt = offset.device, offset.dtype
    off = offset.reshape(b, h, w, KK, 2)
    oy, ox = off[..., 0], off[..., 1]
    taps = torch.arange(KK, device=dev)
    ty, tx = (taps // 3 - 1).to(dt), (taps % 3 - 1).to(dt)
    yy = torch.arange(h, device=dev, dtype=dt)[:, None, None]
    xx = torch.arange(w, device=dev, dtype=dt)[None, :, None]
    two = torch.arange(2, device=dev, dtype=dt)
    if separable:
        yl = torch.remainder(yy, MXU_CH)
        ay = (oy + yl) + float(r + 1)                  # window row d of the 8-row chunk
        ax = (ox + (tx + s)) + xx                      # padded column j
        ky = torch.floor(ay)[..., None] + two
        kx = torch.floor(ax)[..., None] + two
        uy, ux = ay[..., None] - ky, ax[..., None] - kx
        rows = (yy - yl + ty + 1)[..., None] + ky      # padded row
        cols = kx
    else:
        ky = torch.floor(oy)[..., None] + two          # window shift k, rows y + ty + k
        kx = torch.floor(ox)[..., None] + two
        uy, ux = oy[..., None] - ky, ox[..., None] - kx
        rows = (yy + ty)[..., None] + ky + s
        cols = (xx + tx)[..., None] + kx + s
    index = rows.long()[..., :, None] * wp + cols.long()[..., None, :]
    n = h * w * KK
    return (index.reshape(b, n, 2, 2), _hat(uy).reshape(b, n, 2), _hat(ux).reshape(b, n, 2),
            _dhat(uy).reshape(b, n, 2), _dhat(ux).reshape(b, n, 2))


def _corners(x, index, radius: int):
    """x (B,H,W,C) zero-padded by radius + 2 and gathered at ``index``:
    (B, N, 2, 2, C) in x's type."""
    b, h, w, c = x.shape
    s = int(radius) + 2
    xp = torch.nn.functional.pad(x, (0, 0, s, s, s, s)).reshape(b, -1, c)
    n = index.shape[1]
    flat = index.reshape(b, n * 4, 1).expand(b, n * 4, c)
    return torch.gather(xp, 1, flat).reshape(b, n, 2, 2, c)


def _acc_type(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _clip(offset, radius: int, acc):
    return offset.to(acc).clamp(-float(radius), float(radius))


def _sample(blocks, wy, wx):
    """The bilinear sample (B, N, C): the x pass over the two rows, then the
    y combine, in the TPU kernels' order."""
    rows = wx[..., 0, None, None] * blocks[:, :, :, 0] + wx[..., 1, None, None] * blocks[:, :, :, 1]
    return wy[..., 0, None] * rows[:, :, 0] + wy[..., 1, None] * rows[:, :, 1]


def window_forward_plain(x, offset, mask, weight, radius: int, separable: bool = False):
    """The plain forward of K3 (``separable=False``) or K2 (``True``):
    (B,H,W,Cout) in x's type, sums in fp32 (fp64 for fp64 inputs). In fp32
    the two are one function; in bf16 K3 rounds the modulated sample to
    bf16 and K2 the x weights (``deform_mxu.py:128``), with an fp32
    contraction."""
    b, h, w, c = x.shape
    cout = weight.shape[-1]
    acc = _acc_type(x)
    index, wy, wx, _, _ = window_taps(_clip(offset, radius, acc), radius, separable)
    if separable:
        wx = wx.to(x.dtype).to(acc)
    ms = _sample(_corners(x, index, radius).to(acc), wy, wx) * mask.to(acc).reshape(b, -1, 1)
    if not separable:
        ms = ms.to(x.dtype).to(acc)
    out = ms.reshape(b, h * w, KK * c) @ weight.reshape(KK * c, cout).to(acc)
    return out.reshape(b, h, w, cout).to(x.dtype)


def window_grads_plain(x, offset, mask, weight, g, radius: int, separable: bool = False):
    """The plain backward of K3 or K2: (dx, doffset, dmask, dweight) for
    the incoming gradient g (B,H,W,Cout), all in fp32 (fp64 for fp64
    inputs) from the hat and its derivative, written out rather than left
    to autograd's rules at |u| = 1. dx and dweight come back in the types
    of x and weight, doffset and dmask in those of offset and mask."""
    b, h, w, c = x.shape
    cout = weight.shape[-1]
    acc = _acc_type(x)
    s = int(radius) + 2
    off = _clip(offset, radius, acc)
    index, wy, wx, dwy, dwx = window_taps(off, radius, separable)
    blocks = _corners(x.to(acc), index, radius)                     # (B, N, 2, 2, C)
    g2 = g.to(acc).reshape(b, h * w, cout)
    w3 = weight.to(acc).reshape(KK, c, cout)
    gs = torch.einsum("bpo,tco->bptc", g2, w3).reshape(b, -1, c)   # g . W_t^T
    m = mask.to(acc).reshape(b, -1, 1)
    gsm = gs * m
    samp = _sample(blocks, wy, wx)
    dmask = (gs * samp).sum(-1)
    cg = torch.einsum("bnyxc,bnc->bnyx", blocks, gsm)               # gsm . x_corner
    if separable:  # deform_mxu.py:221-243: over the x-passed rows, dWx per column
        doy = (dwy * (wx[:, :, None, :] * cg).sum(-1)).sum(-1)
        dox = (dwx * (wy[:, :, :, None] * cg).sum(-2)).sum(-1)
    else:          # deform_pallas.py:169-171: over the four window terms
        doy = (dwy[:, :, :, None] * wx[:, :, None, :] * cg).sum((-2, -1))
        dox = (wy[:, :, :, None] * dwx[:, :, None, :] * cg).sum((-2, -1))
    doff = torch.stack([doy, dox], -1).reshape(b, h, w, 2 * KK)
    doff = doff * (off.abs() < float(radius)).to(acc)
    wk = wy[:, :, :, None] * wx[:, :, None, :]                     # (B, N, 2, 2)
    contrib = (wk[..., None] * gsm[:, :, None, None, :]).reshape(-1, c)
    hp, wp = h + 2 * s, w + 2 * s
    flat = (index + torch.arange(b, device=x.device)[:, None, None, None] * (hp * wp)).reshape(-1)
    dxp = torch.zeros(b * hp * wp, c, dtype=acc, device=x.device).index_add_(0, flat, contrib)
    dx = dxp.reshape(b, hp, wp, c)[:, s:s + h, s:s + w]
    dw = torch.einsum("bptc,bpo->tco", (samp * m).reshape(b, h * w, KK, c), g2)
    return (dx.to(x.dtype), doff.to(offset.dtype), dmask.reshape(b, h, w, KK).to(mask.dtype),
            dw.reshape(3, 3, c, cout).to(weight.dtype))


def deform_conv2d_pallas_plain(x, offset, mask, weight, radius: int):
    """K3's plain forward, NHWC / HWIO as ``deform_conv2d_plain``: clip to
    +-radius, sample with the hat weights (zero outside the map), output in
    x's type."""
    return window_forward_plain(x, offset, mask, weight, radius, separable=False)


def deform_conv2d_pallas_grads_plain(x, offset, mask, weight, g, radius: int):
    """K3's plain backward: (dx, doffset, dmask, dweight) for g (B,H,W,Cout),
    all in fp32 from the hat and its derivative."""
    return window_grads_plain(x, offset, mask, weight, g, radius, separable=False)


def _forward(entry: str, x, offset, mask, weight, radius):
    """K2 or K3 fwd (``entry``) on CUDA tensors with ``window_fwd_launch``'s
    plan, the weight as ``k1_fwd_weight`` lays it out."""
    if radius is None:
        raise ValueError("the bounded DCN kernels need an integer radius, got None")
    b, c, h, w, cout = _check(x, offset, mask, weight, radius)
    xv, ov, mv = _nhwc(x, "x"), _nhwc(offset, "offset"), _nhwc(mask, "mask")
    plan = window_fwd_launch(int(radius), c, cout, x.dtype, xv.data_ptr() % 16 == 0,
                             separable=entry == "dcn_separable_forward", b=b, h=h, w=w)
    wt = k1_fwd_weight(weight, plan["cpad"])
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    lib = kernels.load("deform_window")
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    status = fn(xv.data_ptr(), ov.data_ptr(), mv.data_ptr(), wt.data_ptr(), out.data_ptr(),
                b, h, w, c, cout, plan["cpad"], int(radius), plan["cc"], plan["nb"],
                int(plan["vec16"]), int(plan["global"]), 0 if x.dtype == torch.float32 else 1,
                torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(lib, status, entry)
    return out


def _backward(entry: str, x, offset, mask, weight, g, radius, rounded: bool = True):
    """K2 or K3 bwd (``entry``) on CUDA tensors with ``window_bwd_launch``'s
    plan: (dx, doffset, dmask, dweight), summed in fp64 by the kernel and
    rounded once here to the types of x, offset, mask and weight; with
    ``rounded=False`` the fp64 sums themselves (the function's values, which
    a bf16 x or weight would round)."""
    if radius is None:
        raise ValueError("the bounded DCN kernels need an integer radius, got None")
    b, c, h, w, cout = _check(x, offset, mask, weight, radius)
    if tuple(g.shape) != (b, cout, h, w) or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} on {g.device} does not match the output "
                         f"({b}, {cout}, {h}, {w}) on {x.device}")
    xv, ov, mv = _nhwc(x, "x"), _nhwc(offset, "offset"), _nhwc(mask, "mask")
    gv = _nhwc(g.to(x.dtype).contiguous(memory_format=torch.channels_last), "g")
    wk = weight.permute(2, 3, 1, 0).reshape(KK, c, cout).contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = window_bwd_launch(int(radius), c, cout, x.dtype,
                             xv.data_ptr() % 16 == 0 and gv.data_ptr() % 16 == 0,
                             b=b, h=h, w=w, sms=sms)
    f64 = dict(dtype=torch.float64, device=x.device)
    # the kernel adds into all four
    dx, dw = torch.zeros((b, h, w, c), **f64), torch.zeros((KK, c, cout), **f64)
    doff, dmask = torch.zeros((b, h, w, 2 * KK), **f64), torch.zeros((b, h, w, KK), **f64)
    lib = kernels.load("deform_window")
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    status = fn(xv.data_ptr(), ov.data_ptr(), mv.data_ptr(), wk.data_ptr(), gv.data_ptr(),
                dx.data_ptr(), doff.data_ptr(), dmask.data_ptr(), dw.data_ptr(),
                b, h, w, c, cout, int(radius), plan["groups"], int(plan["vec16"]),
                int(plan["global"]), 0 if x.dtype == torch.float32 else 1,
                torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(lib, status, entry)
    dx, doff, dmask = (t.permute(0, 3, 1, 2) for t in (dx, doff, dmask))
    dweight = dw.reshape(3, 3, c, cout).permute(3, 2, 0, 1)
    if not rounded:
        return dx, doff, dmask, dweight
    return dx.to(x.dtype), doff.float(), dmask.float(), dweight.to(weight.dtype)


def dcn_window_forward(x, offset, mask, weight, radius: int):
    """K3 fwd on CUDA tensors (channels_last NCHW, as
    ``modulated_deform_conv2d_pallas``): launches ``csrc/deform_window.cu``
    or raises."""
    out = _forward("dcn_window_forward", x, offset, mask, weight, radius)
    dcn_window_forward.launches += 1
    return out


def dcn_window_backward(x, offset, mask, weight, g, radius: int):
    """K3 bwd on CUDA tensors: (dx, doffset, dmask, dweight) for the
    incoming gradient g (B,Cout,H,W), taken in x's type. All four are
    summed in fp32 in a fixed order within a block and added into fp64 sums
    by atomics (an order that changes from run to run), and rounded once
    here. Launches ``csrc/deform_window.cu`` at any radius (the global mode
    past the window) or raises."""
    grads = _backward("dcn_window_backward", x, offset, mask, weight, g, radius)
    dcn_window_backward.launches += 1
    return grads


class WindowConv(torch.autograd.Function):
    """K3 or K2 with its gradient. CUDA: the form's forward and backward
    kernels (``kernels``: the two wrappers). CPU: the plain forward and the
    plain backward. No fallback."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, radius, separable, kernels):
        ctx.save_for_backward(x, offset, mask, weight)
        ctx.radius, ctx.separable, ctx.kernels = radius, separable, kernels
        if x.device.type == "cpu":
            y = window_forward_plain(x.permute(0, 2, 3, 1), offset.permute(0, 2, 3, 1),
                                     mask.permute(0, 2, 3, 1), weight.permute(2, 3, 1, 0),
                                     radius, separable)
            return y.permute(0, 3, 1, 2)
        return kernels[0](x, offset, mask, weight, radius)

    @staticmethod
    def backward(ctx, g):
        x, offset, mask, weight = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, doff, dmask, dw = window_grads_plain(
                *(t.permute(0, 2, 3, 1) for t in (x, offset, mask)), weight.permute(2, 3, 1, 0),
                g.permute(0, 2, 3, 1), ctx.radius, ctx.separable)
            grads = (dx.permute(0, 3, 1, 2), doff.permute(0, 3, 1, 2), dmask.permute(0, 3, 1, 2),
                     dw.permute(3, 2, 0, 1))
        else:
            grads = ctx.kernels[1](x, offset, mask, weight, g, ctx.radius)
        return (*grads, None, None, None)


def modulated_deform_conv2d_pallas(x, offset, mask, weight, radius: int = 3):
    """K3 on channels_last NCHW tensors: x (B,C,H,W), offset (B,18,H,W)
    fp32, mask (B,9,H,W) fp32, weight (Cout,C,3,3) cast to x's type here;
    the offsets are clipped to +-radius. Returns (B,Cout,H,W) in x's type,
    differentiable in all four inputs. A CPU tensor runs the plain
    versions; a CUDA tensor launches ``dcn_window_forward`` (and
    ``dcn_window_backward``) or raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"modulated_deform_conv2d_pallas: unsupported device {x.device}")
    return WindowConv.apply(x, offset, mask, weight.to(x.dtype), int(radius), False,
                            (dcn_window_forward, dcn_window_backward))


dcn_window_forward.launches = 0
dcn_window_backward.launches = 0
