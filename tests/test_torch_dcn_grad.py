"""DCNv2 gradients of the PyTorch port against the JAX package.

The port's backward on the CPU is the autograd of its plain version; here
all four gradients (x, offset, mask, weight) are held against ``jax.grad``
of ``yolo_ad_refine_tpu/ops/deform.py`` (unbounded sampling, the
reference's mmcv semantics) and, with radius=3, against the TPU kernel's
VJP (``deform_mxu2``) run in Pallas interpret mode. Tolerance: 1e-4 of
max |ref| per gradient, as tests/test_dcn_mxu2.py holds its kernel (fp32
sums in another order). Offsets of exactly 0 put every sample on an integer
coordinate, where both sides take the one-sided derivative of the floor
form. The kernel against this plain version is in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_ad_refine_tpu.ops.deform_mxu2 as dm2
from yolo_ad_refine_tpu.ops.deform import modulated_deform_conv2d as jax_dcn
from yolo_ad_refine_tpu_torch.ops.deform import (
    deform_conv2d_grads_plain, deform_conv2d_plain, modulated_deform_conv2d)


def _inputs(sigma, seed=0, b=2, h=9, w=11, c=16, cout=16):
    r = np.random.default_rng(seed)
    x = r.normal(0, 1, (b, h, w, c)).astype(np.float32)
    off = (r.normal(0, 1, (b, h, w, 18)) * sigma).astype(np.float32)
    mask = r.random((b, h, w, 9)).astype(np.float32)
    wt = r.normal(0, 0.1, (3, 3, c, cout)).astype(np.float32)
    g = r.normal(0, 1, (b, h, w, cout)).astype(np.float32)
    return x, off, mask, wt, g


def _port_grads(x, off, mask, wt, g, radius=None):
    grads = deform_conv2d_grads_plain(*(torch.from_numpy(a) for a in (x, off, mask, wt, g)),
                                      radius=radius)
    return [t.numpy() for t in grads]


def _assert_scaled_close(got, want, tol=1e-4):
    for name, a, e in zip(("dx", "doffset", "dmask", "dweight"), got, want):
        e = np.asarray(e)
        assert a.shape == e.shape, name
        err = np.abs(a - e).max() / np.abs(e).max()
        assert err <= tol, f"{name}: max |port - jax| / max |jax| = {err:.2e}"


@pytest.mark.parametrize("sigma", [0.0, 1.0, 5.0, 17.0])
def test_grads_match_jax_exact_gather(sigma):
    x, off, mask, wt, g = _inputs(sigma, seed=int(sigma) + 1)

    @jax.jit
    def grads(x, off, mask, wt, g):
        return jax.grad(lambda *a: jnp.sum(jax_dcn(*a) * g), argnums=(0, 1, 2, 3))(
            x, off, mask, wt)

    want = grads(*(jnp.asarray(a) for a in (x, off, mask, wt, g)))
    _assert_scaled_close(_port_grads(x, off, mask, wt, g), want)


@pytest.mark.parametrize("sigma", [1.0, 5.0])
def test_grads_radius_match_tpu_kernel_interpret(monkeypatch, sigma):
    monkeypatch.setattr(dm2, "_INTERPRET", True)
    x, off, mask, wt, g = _inputs(sigma, seed=int(sigma) + 11)

    def f(x, off, mask, wt):
        return jnp.sum(dm2.modulated_deform_conv2d_mxu2(x, off, mask, wt, 3) * g)

    want = jax.grad(f, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (x, off, mask, wt)))
    _assert_scaled_close(_port_grads(x, off, mask, wt, g, radius=3), want)


@pytest.mark.parametrize("radius", [None, 3])
def test_function_on_cpu_equals_plain_version(radius):
    x, off, mask, wt, g = _inputs(4.0, seed=21)
    nchw = [torch.from_numpy(a).permute(0, 3, 1, 2).requires_grad_() for a in (x, off, mask)]
    weight = torch.from_numpy(wt).permute(3, 2, 0, 1).detach().requires_grad_()
    y = modulated_deform_conv2d(*nchw, weight, radius=radius)
    assert y.grad_fn is not None
    want_y = deform_conv2d_plain(*(torch.from_numpy(a) for a in (x, off, mask, wt)), radius)
    torch.testing.assert_close(y.permute(0, 2, 3, 1), want_y, rtol=0, atol=0)
    y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    want = _port_grads(x, off, mask, wt, g, radius)
    got = [t.grad.permute(0, 2, 3, 1).numpy() for t in nchw] + \
          [weight.grad.permute(2, 3, 1, 0).numpy()]
    for a, e in zip(got, want):
        np.testing.assert_array_equal(a, e)


@pytest.mark.parametrize("radius", [None, 1])
def test_gradcheck_float64(radius):
    r = np.random.default_rng(5)
    b, h, w, c, cout = 1, 5, 5, 3, 4
    x = torch.from_numpy(r.normal(0, 1, (b, c, h, w)))
    off = torch.from_numpy(r.normal(0, 1.3, (b, 18, h, w)))
    mask = torch.from_numpy(r.random((b, 9, h, w)))
    wt = torch.from_numpy(r.normal(0, 0.3, (cout, c, 3, 3)))
    ins = [t.requires_grad_() for t in (x, off, mask, wt)]
    assert torch.autograd.gradcheck(
        lambda *a: modulated_deform_conv2d(*a, radius=radius), ins)


def test_integer_radius_takes_the_hat_derivative_of_deform_mxu2(monkeypatch):
    """At an integer radius the port follows ``deform_mxu2``'s hat
    derivative, which is 0 along an axis where the sample coordinate is
    integral: integral y-offsets in [-2, 2] give d offset_y = 0, where the
    floor form's one-sided derivative is not 0; x-offsets 0.3 off the
    integers keep d offset_x. All four gradients within 1e-5 of max |JAX|."""
    monkeypatch.setattr(dm2, "_INTERPRET", True)
    r = np.random.default_rng(0)
    b, h, w, c, cout = 1, 8, 8, 4, 4
    x = r.normal(0, 1, (b, h, w, c)).astype(np.float32)
    off = r.integers(-2, 3, (b, h, w, 9, 2)).astype(np.float32)
    off[..., 1] += 0.3
    off = off.reshape(b, h, w, 18)
    mask = r.random((b, h, w, 9)).astype(np.float32)
    wt = r.normal(0, 0.1, (3, 3, c, cout)).astype(np.float32)
    g = r.normal(0, 1, (b, h, w, cout)).astype(np.float32)

    def f(x, off, mask, wt):
        return jnp.sum(dm2.modulated_deform_conv2d_mxu2(x, off, mask, wt, 3) * g)

    want = jax.grad(f, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (x, off, mask, wt)))
    got = _port_grads(x, off, mask, wt, g, radius=3)
    assert not np.asarray(want[1])[..., 0::2].any() and not got[1][..., 0::2].any()
    assert np.abs(got[1][..., 1::2]).max() > 0.1
    _assert_scaled_close(got, want, tol=1e-5)
    # unbounded, the same inputs take the one-sided derivative of the floor form
    assert np.abs(_port_grads(x, off, mask, wt, g)[1][..., 0::2]).max() > 0.1
