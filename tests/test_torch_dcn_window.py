"""The bounded DCN kernels K2 (``deform_mxu``) and K3 (``deform_pallas``):
the PyTorch port's plain versions against the JAX kernels, which run here in
Pallas interpret mode (``_INTERPRET`` patched as tests/test_dcn_mxu.py
does). Inputs are made with numpy from seeds and go through both sides.

Tolerances: the fp32 forward within 1e-5 (the two sum the same terms, in
the same order up to XLA's dot); each fp32 gradient within 1e-4 of
max |JAX| (sums over channels in another order). d offset is exactly 0
along an axis whose sample coordinate is integral, and where
|offset| >= radius. The bf16 forward pins where each kernel rounds: within
one bf16 ulp of max |y| of its own kernel and bit-equal to it on at least
90 % of the outputs, more than to the other kernel's. The kernels against
these plain versions on the card are in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_ad_refine_tpu.ops.deform_mxu as dm
import yolo_ad_refine_tpu.ops.deform_pallas as dp
from yolo_ad_refine_tpu_torch.ops.deform_mxu import (
    deform_conv2d_mxu_grads_plain, deform_conv2d_mxu_plain, modulated_deform_conv2d_mxu)
from yolo_ad_refine_tpu_torch.ops.deform_pallas import (
    deform_conv2d_pallas_grads_plain, deform_conv2d_pallas_plain, modulated_deform_conv2d_pallas)

KERNELS = {
    "mxu": (dm, "modulated_deform_conv2d_mxu", deform_conv2d_mxu_plain,
            deform_conv2d_mxu_grads_plain, modulated_deform_conv2d_mxu),
    "pallas": (dp, "modulated_deform_conv2d_pallas", deform_conv2d_pallas_plain,
               deform_conv2d_pallas_grads_plain, modulated_deform_conv2d_pallas),
}
GRADS = ("dx", "doffset", "dmask", "dweight")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(dm, "_INTERPRET", True)
    monkeypatch.setattr(dp, "_INTERPRET", True)


def _inputs(sigma, seed=0, b=1, h=10, w=12, c=8, cout=8, integral=False):
    """x, offset, mask, weight, g. ``integral``: every y-offset of taps
    0, 2, 4, 6, 8 and every x-offset of taps 1, 3, 5, 7 is an integer."""
    r = np.random.default_rng(seed)
    x = r.normal(0, 1, (b, h, w, c)).astype(np.float32)
    off = r.normal(0, sigma, (b, h, w, 18)).astype(np.float32)
    if integral:
        off[..., 0::4] = np.round(off[..., 0::4])
        off[..., 3::4] = np.round(off[..., 3::4])
    mask = r.random((b, h, w, 9)).astype(np.float32)
    wt = r.normal(0, 0.1, (3, 3, c, cout)).astype(np.float32)
    g = r.normal(0, 1, (b, h, w, cout)).astype(np.float32)
    return x, off, mask, wt, g


def _jax_fn(kind):
    mod, name = KERNELS[kind][:2]
    return getattr(mod, name)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
@pytest.mark.parametrize("sigma", [1.2, 5.0])
def test_forward_fp32_matches_jax_kernel(kind, sigma):
    """Radius 3, offsets mostly inside it (N(0, 1.2)) and mostly beyond it
    (N(0, 5), clipped)."""
    x, off, mask, wt, _ = _inputs(sigma, seed=int(sigma * 10))
    want = np.asarray(_jax_fn(kind)(*(jnp.asarray(a) for a in (x, off, mask, wt)), 3))
    got = KERNELS[kind][2](*_torch(x, off, mask, wt), 3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
def test_forward_fp32_radius_8_matches_jax_kernel(kind):
    """A larger window: radius 8, offsets up to 17 px (clipped to 8)."""
    x, off, mask, wt, _ = _inputs(6.0, seed=8)
    off = np.clip(off, -17.0, 17.0)
    assert np.abs(off).max() > 8.0
    want = np.asarray(_jax_fn(kind)(*(jnp.asarray(a) for a in (x, off, mask, wt)), 8))
    got = KERNELS[kind][2](*_torch(x, off, mask, wt), 8).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
def test_gradients_fp32_match_jax_kernel(kind):
    """All four gradients at radius 3, offsets N(0, 2.5) with some beyond
    the radius and one axis of each tap integral: d offset is 0 there, on
    both sides, and 0 where the offset was clipped."""
    x, off, mask, wt, g = _inputs(2.5, seed=3, integral=True)
    fn = _jax_fn(kind)
    want = jax.grad(lambda *a: jnp.sum(fn(*a, 3) * g), argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, off, mask, wt)))
    got = [t.numpy() for t in KERNELS[kind][3](*_torch(x, off, mask, wt, g), 3)]
    for name, a, e in zip(GRADS, got, want):
        e = np.asarray(e)
        assert a.shape == e.shape and a.dtype == e.dtype, name
        err = np.abs(a - e).max() / np.abs(e).max()
        assert err <= 1e-4, f"{name}: max |port - jax| / max |jax| = {err:.2e}"
    doff = got[1].reshape(*got[1].shape[:-1], 9, 2)
    want_doff = np.asarray(want[1]).reshape(doff.shape)
    integral = np.zeros((9, 2), bool)
    integral[0::2, 0] = integral[1::2, 1] = True
    clipped = np.abs(off.reshape(doff.shape)) >= 3.0
    assert not doff[..., integral].any() and not want_doff[..., integral].any()
    assert clipped.any() and not doff[clipped].any()
    assert np.abs(doff[..., ~integral]).max() > 0.1


@pytest.fixture(scope="module")
def bf16_outputs():
    """Both JAX kernels' and both plain versions' bf16 forwards of one
    input (radius 3, offsets N(0, 2), B1 H8 W10 C = Cout = 16)."""
    import yolo_ad_refine_tpu.ops.deform_mxu as jdm
    import yolo_ad_refine_tpu.ops.deform_pallas as jdp

    saved = jdm._INTERPRET, jdp._INTERPRET
    jdm._INTERPRET = jdp._INTERPRET = True
    try:
        x, off, mask, wt, _ = _inputs(2.0, seed=0, b=1, h=8, w=10, c=16, cout=16)
        xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt, jnp.bfloat16)
        out = {}
        for kind in KERNELS:
            y = _jax_fn(kind)(xb, jnp.asarray(off), jnp.asarray(mask), wb, 3)
            out[("jax", kind)] = np.asarray(y.astype(jnp.float32))
            out[("port", kind)] = KERNELS[kind][2](
                torch.from_numpy(x).bfloat16(), torch.from_numpy(off), torch.from_numpy(mask),
                torch.from_numpy(wt).bfloat16(), 3).float().numpy()
        return out
    finally:
        jdm._INTERPRET, jdp._INTERPRET = saved


@pytest.mark.parametrize("kind,other", [("mxu", "pallas"), ("pallas", "mxu")])
def test_bf16_forward_rounds_where_its_kernel_does(bf16_outputs, kind, other):
    got = bf16_outputs[("port", kind)]
    own, theirs = bf16_outputs[("jax", kind)], bf16_outputs[("jax", other)]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(own).max())) - 7)  # bf16 ulp at max |y|
    assert np.abs(got - own).max() <= ulp
    same_own, same_other = (got == own).mean(), (got == theirs).mean()
    assert same_own >= 0.9 and same_own > same_other, (same_own, same_other)


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
def test_function_on_cpu_equals_plain_version(kind):
    _, _, plain, grads_plain, fn = KERNELS[kind]
    x, off, mask, wt, g = _inputs(4.0, seed=21)
    nchw = [torch.from_numpy(a).permute(0, 3, 1, 2).requires_grad_() for a in (x, off, mask)]
    weight = torch.from_numpy(wt).permute(3, 2, 0, 1).detach().requires_grad_()
    y = fn(*nchw, weight, 3)
    assert y.grad_fn is not None
    torch.testing.assert_close(y.permute(0, 2, 3, 1), plain(*_torch(x, off, mask, wt), 3),
                               rtol=0, atol=0)
    y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    want = grads_plain(*_torch(x, off, mask, wt, g), 3)
    got = [t.grad.permute(0, 2, 3, 1) for t in nchw] + [weight.grad.permute(2, 3, 1, 0)]
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["mxu", "pallas"])
def test_gradcheck_float64(kind):
    """The written-out gradients against finite differences, at radius 1
    with offsets kept 0.1 px away from the integers and from the clip."""
    r = np.random.default_rng(5)
    b, h, w, c, cout = 1, 5, 5, 3, 4
    off = r.uniform(-0.9, 0.9, (b, 18, h, w))
    off = np.where(np.abs(off - np.round(off)) < 0.1, off + 0.2, off)
    ins = [torch.from_numpy(a).requires_grad_() for a in (
        r.normal(0, 1, (b, c, h, w)), off, r.random((b, 9, h, w)),
        r.normal(0, 0.3, (cout, c, 3, 3)))]
    fn = KERNELS[kind][4]
    assert torch.autograd.gradcheck(lambda *a: fn(*a, radius=1), ins)
