"""K2 / K3 forward and backward on the tensor cores, checked on the CPU.

``csrc/deform_window.cu`` runs only on the card, so two things it does are
modelled here:

- its launch arithmetic, ``ops/deform_pallas.py window_fwd_launch`` and
  ``window_bwd_launch`` (the wrappers' plans: channel chunk, shared memory,
  grid, mode), over the radii and widths the flagship meets: every plan
  fits a block's 232,448 bytes, a radius whose window fits no block takes
  the global mode, and the backward launches wherever the fp32-core
  backward that it replaced did (that kernel's shared-memory rule is
  written out here) and on to radius 200;
- its products: the samples as the plain versions form them, then per
  (chunk, tap) step and per mma k-block the kernel's operands and sums,
  emulated in torch. Forward, fp32: 3xTF32 (a_hi b_hi into one fp32 sum,
  a_lo b_hi then a_hi b_lo into another, added at the end; x_hi = tf32(x),
  x_lo = tf32(x - x_hi), rounded to nearest with ties away from zero, as
  cvt.rna.tf32.f32); K3 bf16: the sample rounded to bf16, bf16 x bf16; K2
  bf16: the fp32 sample against the bf16 weight, which is exact in TF32, by
  2xTF32. Backward, all fp32 also for bf16 inputs: gs = g . W_t^T by 3xTF32
  in fp32 and by one TF32 product of bf16 values (exact) in bf16; dW_t =
  (m sample)^T g by 3xTF32 in fp32 and 2xTF32 (the fp32 sample split, g
  exact) in bf16; dx an fp64 sum of the fp32 terms; the corner dots per
  16-channel chunk in fp32, doffset and dmask of the chunks summed in fp64.
  Each mma's k-block sum is taken in fp64 and rounded to fp32 once before
  it is added (the tensor cores' internal order is not IEEE sequential;
  this is the model, not a bit-exact copy).

The models are held against the JAX kernels ``deform_mxu`` (K2) and
``deform_pallas`` (K3) in Pallas interpret mode, on seeded numpy inputs,
with offsets past the radius. Forward tolerances: fp32 within 1e-5
absolute (the JAX kernels contract in fp32; 3xTF32 keeps about 2^-21 of
each product); bf16 within one bf16 ulp of max |y| and bit-equal on at
least 95 % of the outputs. Rounding K2's sample to bf16 (K3's rounding)
must fail that bf16 check, and a single TF32 product must fail the fp32
one: the checks see the difference. Backward: each gradient within 1e-4 of
max |JAX| in fp32 and in bf16 (the function is fp32; the JAX reference of
the bf16 case is its fp32 backward on the bf16 values, which is what its
bf16 backward computes before rounding its outputs); the model with its
sample rounded to bf16 must fail that limit.
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
    _clip, _corners, _sample, window_bwd_launch, window_bwd_smem, window_fwd_launch,
    window_fwd_smem, window_taps)

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 40, 64, 256, 384])
@pytest.mark.parametrize("radius", [0, 1, 3, 4, 5, 13, 31])
def test_window_bwd_plan_fits_a_block(radius, c, dtype):
    """The backward's plan at the flagship's radii and widths: 16 channels
    and 64 output channels a block, 8 x 16 tiles of 512 threads, a grid of
    (tile groups, channel chunks, output-channel chunks) with at least one
    tile a group, 16-byte loads where C and Cout allow them, and a block
    that fits."""
    isz = 2 if dtype == torch.bfloat16 else 4
    for cout in (64, c, 136):
        plan = window_bwd_launch(radius, c, cout, dtype, b=2, h=20, w=40)
        tiles = 2 * 3 * 3
        assert plan["smem"] == window_bwd_smem(radius, dtype, plan["global"])
        assert plan["smem"] <= SMEM_PER_BLOCK
        assert (plan["cc"], plan["no"], plan["block"]) == (16, 64, 512)
        assert plan["grid"] == (plan["groups"], -(-c // 16), -(-cout // 64))
        assert 1 <= plan["groups"] <= tiles
        assert plan["vec16"] == ((c * isz) % 16 == 0 and (cout * isz) % 16 == 0)
        assert not window_bwd_launch(radius, c, cout, dtype, aligned=False)["vec16"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_bwd_plan_takes_the_global_mode_where_no_window_fits(dtype):
    """The launch rule: the window mode wherever its block fits (the window
    chunk, m * gs of the 9 taps and the positions' lists: to radius 3 in
    fp32, 7 in bf16), the global mode from the next radius on, whose block
    does not grow with the radius."""
    modes = [window_bwd_launch(r, 64, 64, dtype)["global"] for r in range(80)]
    first = modes.index(True)
    assert not any(modes[:first]) and all(modes[first:])
    assert first == (4 if dtype == torch.float32 else 8)
    for r in range(80):
        fits = window_bwd_smem(r, dtype, False) <= SMEM_PER_BLOCK
        assert modes[r] == (not fits)
    assert window_bwd_smem(200, dtype, True) == window_bwd_smem(0, dtype, True) <= SMEM_PER_BLOCK


def fma_backward_launched(radius: int, c: int, cout: int, dtype: torch.dtype) -> bool:
    """Whether the fp32-core backward that the tensor-core one replaced
    launched: its block staged an 8 x 8 tile's window chunk beside a
    (C-chunk, Cout-chunk) pair of at most 128 x 128, and it raised where no
    chunk of a power of two up to 64 channels (at least 16 bytes) fit a
    block (its dcn_window_bwd_smem_bytes, a 56-byte geometry entry)."""
    isz = 2 if dtype == torch.bfloat16 else 4
    step = 16 // isz
    cap = max(step, 1 << (c - 1).bit_length())
    cb, ob = min(c, 128), min(cout, 128)
    s = radius + 2
    for cc in (64, 32, 16, 8, 4, 2, 1):
        if cc % step or cc > cap:
            continue
        window = -(-(8 + 2 * s) ** 2 * cc * isz // 16) * 16
        size = window + 4 * (cb * (ob + 1) + cb * ob + 64 * ob + 2 * 64 * cc + 4 * 64) + 56 * 64
        if size <= SMEM_PER_BLOCK:
            return True
    return False


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 256, 384])
@pytest.mark.parametrize("radius", [3, 13, 31, 46, 60, 200])
def test_window_bwd_launches_wherever_the_fma_backward_did(radius, c, dtype):
    """At every (radius, C = Cout, dtype) the backward has a plan that fits a
    block: where the fp32-core backward launched, and past it (from radius
    47 at 64 channels and 25 at 384 it raised)."""
    launched_before = fma_backward_launched(radius, c, c, dtype)
    plan = window_bwd_launch(radius, c, c, dtype, b=16, h=80, w=80)
    assert plan["smem"] <= SMEM_PER_BLOCK and plan["groups"] >= 1, launched_before
    assert plan["global"] == (radius > (3 if dtype == torch.float32 else 7))


def test_fma_backward_rule_raised_where_recorded():
    """The written-out rule of the replaced backward: at C = Cout = 64 it
    launched to radius 46 and raised from 47, at 384 to 24 and from 25, in
    both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        assert fma_backward_launched(46, 64, 64, dtype)
        assert not fma_backward_launched(47, 64, 64, dtype)
        assert fma_backward_launched(24, 384, 384, dtype)
        assert not fma_backward_launched(25, 384, 384, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_bwd_smem_matches_the_layout(dtype):
    """The bytes at the flagship's radius, as the kernel lays them out: the
    x window chunk of the 8 x 16 tile and its halo of 5 (18 x 26 positions x
    16 channels), m * gs of 9 x 128 samples x 16 channels in fp32, a start
    (one more) and a count a position and a 16-bit entry a (tap, pixel,
    corner), then two weight tiles of 16 rows and the g tile of 128 rows at
    72 words, two sample tiles of 128 rows at 24 words, two corner-dot tiles
    of 2 x 128 x 4 words, and 9 x 128 geometry entries of 7 words; the global
    mode drops the window mode's own and takes 8 words an entry."""
    isz = 2 if dtype == torch.bfloat16 else 4
    fixed = 4 * (2 * 16 * 72 + 128 * 72 + 2 * 128 * 24 + 2 * 2 * 128 * 4)
    npos = 18 * 26
    window = npos * 16 * isz + 4 * 9 * 128 * 16 + 4 * 472 + 4 * npos + 2 * 9 * 128 * 4
    assert window_bwd_smem(3, dtype, False) == window + fixed + 4 * 9 * 128 * 7
    assert window_bwd_smem(3, dtype, True) == fixed + 4 * 9 * 128 * 8
    assert window_bwd_launch(3, 64, 64, dtype)["smem"] == window_bwd_smem(3, dtype, False)


def test_window_bwd_groups_fill_the_card():
    """The tile groups at the training path's shapes (batch 16, C = Cout =
    64, the three AYHead levels): one block an SM for 132 SMs, each group
    at least one tile; a wide layer takes fewer groups for its 144 chunks."""
    for s, groups in ((80, 32), (40, 30), (20, 32)):
        plan = window_bwd_launch(3, 64, 64, torch.float32, b=16, h=s, w=s)
        assert plan["grid"] == (groups, 4, 1)
    assert window_bwd_launch(3, 384, 384, torch.float32, b=16, h=80, w=80)["grid"] == (11, 24, 6)


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


# ---------------------------------------------------------------------------
# the backward's products


def bwd_model(x, off, mask, w, g, radius: int, separable: bool, *, round_sample=False):
    """The backward kernel on the CPU (Cout up to one block's 64): x (B,H,W,C)
    and w (3,3,C,Cout) and g (B,H,W,Cout) in x's type, off and mask fp32;
    returns (dx, doffset, dmask, dweight) in fp32, the values the kernel's
    fp64 sums hold. ``round_sample``: m * sample rounded to bf16 before the
    dW product (K1's and K3's forward rounding, wrong for these backwards)."""
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    assert cout <= 64
    bf = x.dtype == torch.bfloat16
    s, n = radius + 2, h * wd
    offc = _clip(off, radius, torch.float32)
    index, wy, wx, dwy, dwx = window_taps(offc, radius, separable)
    blocks = _corners(x, index, radius).float()                  # (B, N*9, 2, 2, C)
    m = mask.float().reshape(b, n * KK, 1)
    ms = _sample(blocks, wy, wx) * m
    if round_sample:
        ms = ms.to(torch.bfloat16).float()
    gf, wf = g.float().reshape(b * n, cout), w.float().reshape(KK, c, cout)

    def block_sum(a, bmat):  # one mma's k-block, rounded to fp32 once
        return (a.double() @ bmat.double()).float()

    # gs = g . W_t^T, k-blocks of 8 output channels
    gs = torch.empty(b * n, KK, c)
    for t in range(KK):
        acc, acc2 = torch.zeros(b * n, c), torch.zeros(b * n, c)
        for k0 in range(0, cout, 8):
            a, bmat = gf[:, k0:k0 + 8], wf[t, :, k0:k0 + 8].T
            if bf:                                 # bf16 values: one exact TF32 product
                acc = acc + block_sum(a, bmat)
                continue
            ah, bh = rna_tf32(a), rna_tf32(bmat)
            al, bl = rna_tf32(a - ah), rna_tf32(bmat - bh)
            acc2 = acc2 + block_sum(al, bh)
            acc2 = acc2 + block_sum(ah, bl)
            acc = acc + block_sum(ah, bh)
        gs[:, t] = acc + acc2
    gs = gs.reshape(b, n * KK, c)
    gsm = gs * m
    # dx: the fp32 terms w_k * (gs * m) summed in fp64
    wk = wy[:, :, :, None] * wx[:, :, None, :]
    contrib = (wk[..., None] * gsm[:, :, None, None, :]).double().reshape(-1, c)
    hp, wp = h + 2 * s, wd + 2 * s
    flat = (index + torch.arange(b)[:, None, None, None] * (hp * wp)).reshape(-1)
    dxp = torch.zeros(b * hp * wp, c, dtype=torch.float64).index_add_(0, flat, contrib)
    dx = dxp.reshape(b, hp, wp, c)[:, s:s + h, s:s + wd].float()
    # corner dots per 16-channel chunk in fp32, doffset and dmask of the
    # chunks summed in fp64
    dm, doy, dox = (torch.zeros(b, n * KK, dtype=torch.float64) for _ in range(3))
    for c0 in range(0, c, 16):
        cg = torch.einsum("bnyxc,bnc->bnyx", blocks[..., c0:c0 + 16].double(),
                          gs[..., c0:c0 + 16].double()).float()
        if separable:
            u = (wx[:, :, None, :] * cg).sum(-1)
            dm_c, doy_c = (wy * u).sum(-1), (dwy * u).sum(-1)
            dox_c = (dwx * (wy[:, :, :, None] * cg).sum(-2)).sum(-1)
        else:
            dm_c = (wy[:, :, :, None] * wx[:, :, None, :] * cg).sum((-2, -1))
            doy_c = (dwy[:, :, :, None] * wx[:, :, None, :] * cg).sum((-2, -1))
            dox_c = (wy[:, :, :, None] * dwx[:, :, None, :] * cg).sum((-2, -1))
        dm += dm_c.double()
        doy += (m[..., 0] * doy_c).double()
        dox += (m[..., 0] * dox_c).double()
    doff = torch.stack([doy, dox], -1).reshape(b, h, wd, 2 * KK).float()
    doff = doff * (offc.abs() < float(radius)).float()
    # dW_t = (m sample)^T g, k-blocks of 8 pixels: 3xTF32, or 2xTF32 with g exact
    msr = ms.reshape(b * n, KK, c)
    dw = torch.empty(KK, c, cout)
    for t in range(KK):
        acc = torch.zeros(c, cout)
        for p0 in range(0, b * n, 8):
            a, bmat = msr[p0:p0 + 8, t].T, gf[p0:p0 + 8]
            ah = rna_tf32(a)
            al = rna_tf32(a - ah)
            if bf:
                acc = acc + block_sum(al, bmat)
                acc = acc + block_sum(ah, bmat)
                continue
            bh = rna_tf32(bmat)
            bl = rna_tf32(bmat - bh)
            acc = acc + block_sum(al, bh)
            acc = acc + block_sum(ah, bl)
            acc = acc + block_sum(ah, bh)
        dw[t] = acc
    return dx, doff, dm.reshape(b, h, wd, KK).float(), dw.reshape(3, 3, c, cout)


BWD_CASES = [(kind, dtype) for kind in ("mxu", "pallas") for dtype in ("float32", "bfloat16")]


@pytest.fixture(scope="module")
def jax_grads():
    """Each JAX kernel's gradients (interpret mode) at radius 3 on one seeded
    input (B1 H10 W11 C = 40 Cout = 16, offsets N(0, 4²), g seeded): in fp32,
    and for bf16 the fp32 backward on the inputs' bf16 values (the JAX bf16
    backward takes x, g and W to fp32 and rounds only its outputs)."""
    import jax

    saved = jdm._INTERPRET, jdp._INTERPRET
    jdm._INTERPRET = jdp._INTERPRET = True
    try:
        out = {}
        for kind, dtype in BWD_CASES:
            x, off, mask, wt = _inputs(13)
            g = np.random.default_rng(14).normal(0, 1, (1, 10, 11, 16)).astype(np.float32)
            if dtype == "bfloat16":
                x, wt, g = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                            for a in (x, wt, g))
            fn = jdm.modulated_deform_conv2d_mxu if kind == "mxu" else \
                jdp.modulated_deform_conv2d_pallas
            grads = jax.grad(lambda *a: jnp.sum(fn(*a, 3) * g), argnums=(0, 1, 2, 3))(
                *(jnp.asarray(a) for a in (x, off, mask, wt)))
            out[(kind, dtype)] = ((x, off, mask, wt, g), [np.asarray(e) for e in grads])
        return out
    finally:
        jdm._INTERPRET, jdp._INTERPRET = saved


def _bwd_model(inputs, kind, dtype, **kw):
    x, off, mask, wt, g = (torch.from_numpy(a) for a in inputs)
    dt = getattr(torch, dtype)
    return [t.numpy() for t in bwd_model(x.to(dt), off, mask, wt.to(dt), g.to(dt), 3,
                                         kind == "mxu", **kw)]


def _bwd_errors(got, want):
    """max |model - JAX| / max |JAX| per gradient."""
    return [float(np.abs(a - e).max() / np.abs(e).max()) for a, e in zip(got, want)]


@pytest.mark.parametrize("kind,dtype", BWD_CASES)
def test_backward_products_match_the_jax_kernel(jax_grads, kind, dtype):
    """The kernel's product routes give the JAX backward within the limit,
    1e-4 of max |JAX| per gradient, in fp32 and in bf16; d offset is 0 on
    the integral axis and where the offset was clipped."""
    inputs, want = jax_grads[(kind, dtype)]
    assert np.abs(inputs[1]).max() > 3
    got = _bwd_model(inputs, kind, dtype)
    errs = _bwd_errors(got, want)
    assert max(errs) <= 1e-4, errs
    doff = got[1].reshape(1, 10, 11, 9, 2)
    assert not doff[:, :, :, 0::2, 0].any()
    assert not doff[np.abs(inputs[1].reshape(doff.shape)) >= 3].any()


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
def test_backward_limit_sees_a_bf16_rounded_sample(jax_grads, kind):
    """The backward contracts its fp32 sample with g: rounding m * sample to
    bf16 first fails the limit on dweight (the other gradients do not use
    it), in bf16 as in fp32."""
    for dtype in ("float32", "bfloat16"):
        inputs, want = jax_grads[(kind, dtype)]
        errs = _bwd_errors(_bwd_model(inputs, kind, dtype, round_sample=True), want)
        assert errs[3] > 1e-4 and max(errs[:3]) <= 1e-4, errs
