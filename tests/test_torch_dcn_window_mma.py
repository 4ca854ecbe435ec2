"""K2 / K3 forward on the tensor cores, checked on the CPU.

``csrc/deform_window.cu`` runs only on the card, so two things it does are
modelled here:

- its launch arithmetic, ``ops/deform_pallas.py window_fwd_launch`` (the
  wrapper's plan: channel chunk, shared memory, grid, mode), over the radii
  and widths the flagship meets: every plan fits a block's 232,448 bytes,
  and a radius whose window fits no block takes the global mode;
- its products: the samples as the plain versions form them, then per
  (chunk, tap) step and per mma k-block the kernel's operands and sums,
  emulated in torch. fp32: 3xTF32 (a_hi b_hi into one fp32 sum, a_lo b_hi
  then a_hi b_lo into another, added at the end; x_hi = tf32(x), x_lo =
  tf32(x - x_hi), rounded to nearest with ties away from zero, as
  cvt.rna.tf32.f32); K3 bf16: the sample rounded to bf16, bf16 x bf16; K2
  bf16: the fp32 sample against the bf16 weight, which is exact in TF32, by
  2xTF32. Each mma's k-block sum is taken in fp64 and rounded to fp32 once
  before it is added (the tensor cores' internal order is not IEEE
  sequential; this is the model, not a bit-exact copy).

The model is held against the JAX kernels ``deform_mxu`` (K2) and
``deform_pallas`` (K3) in Pallas interpret mode, on seeded numpy inputs,
at radius 3 and 8 with offsets past the radius. Tolerances: fp32 within
1e-5 absolute (the JAX kernels contract in fp32; 3xTF32 keeps about 2^-21
of each product); bf16 within one bf16 ulp of max |y| and bit-equal on at
least 95 % of the outputs. Rounding K2's sample to bf16 (K3's rounding)
must fail that bf16 check, and a single TF32 product must fail the fp32
one: the checks see the difference.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_ad_refine_tpu.ops.deform_mxu as jdm
import yolo_ad_refine_tpu.ops.deform_pallas as jdp
from yolo_ad_refine_tpu_torch.engine import profile_dcn
from yolo_ad_refine_tpu_torch.ops.deform import KK, SMEM_PER_BLOCK
from yolo_ad_refine_tpu_torch.ops.deform_pallas import (
    _clip, _corners, _sample, window_fwd_launch, window_fwd_smem, window_taps)

# ---------------------------------------------------------------------------
# launch plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout", [64, 384])
@pytest.mark.parametrize("c", [3, 40, 64, 256, 384])
@pytest.mark.parametrize("radius", [1, 3, 13, 24])
def test_window_fwd_plan_fits_a_block(radius, c, cout, dtype):
    """Both forms, window mode: the chunk is a power of two of 16 to 128
    bytes a row, no wider than C needs, the widest whose block fits; ks is
    at least one mma's k; the weight pads C to whole chunks; 128-channel
    blocks past 64 output channels where 16-byte copies are allowed; 8 x 16
    tiles of 512 threads; the block fits."""
    isz = 2 if dtype == torch.bfloat16 else 4
    for separable in (False, True):
        plan = window_fwd_launch(radius, c, cout, dtype, separable=separable, b=2, h=20, w=13)
        cc = plan["cc"]
        assert not plan["global"]
        assert plan["smem"] == window_fwd_smem(radius, cc, plan["nb"], dtype, separable, False)
        assert plan["smem"] <= SMEM_PER_BLOCK
        assert cc & (cc - 1) == 0 and 16 <= cc * isz <= 128
        assert cc <= max(16 // isz, 1 << (c - 1).bit_length())
        mk = 16 if dtype == torch.bfloat16 and not separable else 8
        assert plan["ks"] == max(cc, mk)
        assert plan["cpad"] % cc == 0 and c <= plan["cpad"] < c + cc
        assert plan["vec16"] == ((c * isz) % 16 == 0)
        assert plan["nb"] == (128 if cout > 64 and plan["vec16"] else 64)
        assert plan["grid"] == (2 * 3 * 1, -(-cout // plan["nb"])) and plan["block"] == 512
        wider = 2 * cc
        if wider * isz <= 128 and wider <= max(16 // isz, 1 << (c - 1).bit_length()):
            # the next width up does not fit
            assert window_fwd_smem(radius, wider, plan["nb"], dtype, separable,
                                   False) > SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_fwd_plan_bytes(dtype):
    """The bytes at the flagship's shape, as the kernel lays them out: two
    window chunks of the 8 x 16 tile and its halo of 5, two sample tiles of
    128 rows and two weight tiles of 64, ks + 4 words a row (fp32 weights
    in two planes), and 9 x 128 geometry entries of 6 words; in the global
    mode no window and 7 words an entry."""
    bf = dtype == torch.bfloat16
    for separable in (False, True):
        plan = window_fwd_launch(3, 64, 64, dtype, separable=separable)
        f32 = not bf or separable
        rw = plan["ks"] * (4 if f32 else 2) // 4 + 4
        win = 2 * 18 * 26 * plan["cc"] * (2 if bf else 4)
        tiles = 4 * (2 * 128 * rw + 2 * (1 if bf else 2) * 64 * rw)
        assert not plan["global"]
        assert plan["smem"] == win + tiles + 4 * KK * 128 * 6
        assert window_fwd_smem(3, plan["cc"], 64, dtype, separable, True) == \
            tiles + 4 * KK * 128 * 7


@pytest.mark.parametrize("radius", [40, 200])
def test_window_fwd_plan_raises_where_nothing_fits(radius):
    """No window chunk fits a block at these radii, so the plan takes the
    global mode instead of raising: 64-channel blocks, the widest chunk C
    needs, no window in the block's shared memory."""
    for dtype in (torch.float32, torch.bfloat16):
        isz = 2 if dtype == torch.bfloat16 else 4
        for separable in (False, True):
            assert window_fwd_smem(radius, 16 // isz, 64, dtype, separable, False) > \
                SMEM_PER_BLOCK
            plan = window_fwd_launch(radius, 64, 384, dtype, separable=separable)
            assert plan["global"] and plan["nb"] == 64 and plan["cc"] * isz == 128
            assert plan["smem"] == window_fwd_smem(radius, plan["cc"], 64, dtype, separable, True)
            assert plan["smem"] <= SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,cout", [(3, 64), (64, 64), (64, 384), (384, 384)])
def test_window_fwd_plan_takes_the_global_mode_where_no_window_fits(c, cout, dtype):
    """The launch rule: the window mode up to the last radius at which the
    narrowest chunk's window fits a block with the plan's block width, the
    global mode from the next radius on (29 or 30 in fp32, 30 or 31 in
    bf16)."""
    isz = 2 if dtype == torch.bfloat16 else 4
    for separable in (False, True):
        modes = [window_fwd_launch(r, c, cout, dtype, separable=separable)["global"]
                 for r in range(40)]
        first = modes.index(True)
        assert not any(modes[:first]) and all(modes[first:])
        nb = window_fwd_launch(first - 1, c, cout, dtype, separable=separable)["nb"]
        assert window_fwd_smem(first - 1, 16 // isz, nb, dtype, separable, False) <= SMEM_PER_BLOCK
        assert window_fwd_smem(first, 16 // isz, nb, dtype, separable, False) > SMEM_PER_BLOCK
        assert first in ((29, 30) if isz == 4 else (30, 31))


def test_window_fwd_plan_rejects_what_the_kernel_does_not_take():
    """128-channel blocks only with 16-byte copies (C = 3, or x not
    16-byte aligned, takes 64) and never in the global mode; a negative
    radius or an empty width raises."""
    assert window_fwd_launch(3, 3, 384, torch.float32)["nb"] == 64
    assert window_fwd_launch(3, 64, 384, torch.float32, aligned=False)["nb"] == 64
    assert window_fwd_launch(3, 64, 384, torch.float32)["nb"] == 128
    assert window_fwd_launch(60, 64, 384, torch.float32)["nb"] == 64
    with pytest.raises(ValueError):
        window_fwd_launch(-1, 64, 64, torch.float32)
    with pytest.raises(ValueError):
        window_fwd_launch(3, 0, 64, torch.float32)
    with pytest.raises(ValueError):
        window_fwd_launch(3, 64, 0, torch.bfloat16)


@pytest.mark.parametrize("split", sorted(profile_dcn.WINDOW_TREE_SPLITS))
def test_profile_window_cuts_apply_to_the_kernel_source(split, tmp_path):
    """``profile_dcn --kernel separable|window --tree-split`` times cut
    copies of ``csrc/deform_window.cu``: each cut must still find its text
    there, and change the source."""
    src = profile_dcn.kernels.CSRC / "deform_window.cu"
    out = profile_dcn.cut_copy(src, split, profile_dcn.WINDOW_TREE_SPLITS[split], tmp_path)
    assert out.parent == tmp_path and out.read_text() != src.read_text()


# ---------------------------------------------------------------------------
# the products


def rna_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10-bit mantissa) to nearest, ties away from
    zero, as cvt.rna.tf32.f32 rounds a finite value."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def kernel_model(x, off, mask, w, radius: int, separable: bool, *, round_k2_sample=False,
                 one_tf32=False):
    """The kernel's forward on the CPU: x (B,H,W,C), off (B,H,W,18), mask
    (B,H,W,9) fp32, w (3,3,C,Cout) in x's type; (B,H,W,Cout) in x's type.
    ``round_k2_sample``: K2 rounds its sample to bf16 (K3's rounding, wrong
    for K2); ``one_tf32``: fp32 by a single TF32 product (wrong)."""
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    bf = x.dtype == torch.bfloat16
    plan = window_fwd_launch(radius, c, cout, x.dtype, separable=separable)
    cc, ks = plan["cc"], plan["ks"]
    index, wy, wx, _, _ = window_taps(_clip(off, radius, torch.float32), radius, separable)
    if separable and bf:
        wx = wx.to(torch.bfloat16).float()          # K2's x weights in the input type
    ms = _sample(_corners(x, index, radius).float(), wy, wx) * mask.float().reshape(b, -1, 1)
    ms = ms.reshape(b * h * wd, KK, c)               # the fp32 modulated samples
    wf = w.float().reshape(KK, c, cout)
    k3_bf16 = bf and not separable
    if k3_bf16 or (separable and bf and round_k2_sample):
        ms = ms.to(torch.bfloat16).float()           # K3 rounds the sample to bf16
    mk = 16 if k3_bf16 else 8
    acc = torch.zeros(b * h * wd, cout)
    acc2 = torch.zeros(b * h * wd, cout)

    def block_sum(a, bmat):  # one mma's k-block, rounded to fp32 once
        return (a.double() @ bmat.double()).float()

    for c0 in range(0, c, cc):
        for t in range(KK):
            for k0 in range(c0, c0 + ks, mk):
                k1 = min(k0 + mk, c0 + cc, c)
                if k1 <= k0:
                    continue
                a, bw = ms[:, t, k0:k1], wf[t, k0:k1]
                if k3_bf16:                           # bf16 x bf16, exact products
                    acc = acc + block_sum(a, bw)
                    continue
                ah, bh = rna_tf32(a), rna_tf32(bw)
                al, bl = rna_tf32(a - ah), rna_tf32(bw - bh)
                if one_tf32:
                    acc = acc + block_sum(ah, bh)
                    continue
                acc2 = acc2 + block_sum(al, bh)
                if not bf:                            # K2 bf16: the weight is exact in TF32
                    acc2 = acc2 + block_sum(ah, bl)
                acc = acc + block_sum(ah, bh)
    return (acc + acc2).reshape(b, h, wd, cout).to(x.dtype)


def _inputs(seed, b=1, h=10, w=11, c=40, cout=16, sigma=4.0):
    r = np.random.default_rng(seed)
    x = r.normal(0, 1, (b, h, w, c)).astype(np.float32)
    off = r.normal(0, sigma, (b, h, w, 18)).astype(np.float32)
    off[..., 0::4] = np.round(off[..., 0::4])       # offsets on the integers too
    mask = r.random((b, h, w, 9)).astype(np.float32)
    wt = (r.normal(0, 1, (3, 3, c, cout)) / math.sqrt(9 * c)).astype(np.float32)
    return x, off, mask, wt


CASES = [(kind, dtype, radius) for kind in ("mxu", "pallas") for dtype in ("float32", "bfloat16")
         for radius in (3, 8)]


@pytest.fixture(scope="module")
def jax_outputs():
    """Each JAX kernel's forward (interpret mode) on one seeded input per
    radius (offsets N(0, 4²) at radius 3, N(0, 10²) at 8, so that many lie
    past the radius), in fp32 and bf16."""
    saved = jdm._INTERPRET, jdp._INTERPRET
    jdm._INTERPRET = jdp._INTERPRET = True
    try:
        out = {}
        for kind, dtype, radius in CASES:
            x, off, mask, wt = _inputs(radius, sigma=4.0 if radius == 3 else 10.0)
            dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
            fn = jdm.modulated_deform_conv2d_mxu if kind == "mxu" else \
                jdp.modulated_deform_conv2d_pallas
            y = fn(jnp.asarray(x, dt), jnp.asarray(off), jnp.asarray(mask), jnp.asarray(wt, dt),
                   radius)
            out[(kind, dtype, radius)] = ((x, off, mask, wt), np.asarray(y.astype(jnp.float32)))
        return out
    finally:
        jdm._INTERPRET, jdp._INTERPRET = saved


def _model(inputs, kind, dtype, radius, **kw):
    x, off, mask, wt = (torch.from_numpy(a) for a in inputs)
    dt = getattr(torch, dtype)
    return kernel_model(x.to(dt), off, mask, wt.to(dt), radius, kind == "mxu", **kw).float().numpy()


def _bf16_holds(got, want):
    """Within one bf16 ulp of max |want| and bit-equal on >= 95 %."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return bool(np.abs(got - want).max() <= ulp and (got == want).mean() >= 0.95)


@pytest.mark.parametrize("kind,dtype,radius", CASES)
def test_kernel_products_match_the_jax_kernel(jax_outputs, kind, dtype, radius):
    inputs, want = jax_outputs[(kind, dtype, radius)]
    assert np.abs(inputs[1]).max() > radius  # offsets past the radius are clipped
    got = _model(inputs, kind, dtype, radius)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert _bf16_holds(got, want)


@pytest.mark.parametrize("radius", [3, 8])
def test_k2_bf16_check_sees_a_rounded_sample(jax_outputs, radius):
    """K2 contracts its fp32 sample: rounding it to bf16 first, as K3 does,
    fails the bf16 check against the JAX K2."""
    inputs, want = jax_outputs[("mxu", "bfloat16", radius)]
    assert not _bf16_holds(_model(inputs, "mxu", "bfloat16", radius, round_k2_sample=True), want)


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
def test_fp32_check_sees_a_single_tf32_product(jax_outputs, kind):
    inputs, want = jax_outputs[(kind, "float32", 3)]
    got = _model(inputs, kind, "float32", 3, one_tf32=True)
    assert np.abs(got - want).max() > 1e-5


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                                   # TF32 ulp at 1
    vals = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4,
                         1e-30, 0.0], dtype=torch.float32)
    tiny = rna_tf32(torch.tensor([1e-30]))[0]
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, tiny, 0.0])
    torch.testing.assert_close(rna_tf32(vals), want, rtol=0, atol=0)
    x = torch.randn(1000)
    hi = rna_tf32(x)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((x - hi).abs() <= hi.abs() * 2.0 ** -11).all()
