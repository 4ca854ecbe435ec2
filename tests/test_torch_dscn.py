"""The snake sampling of ``ops/dscn.py`` and the DSAN blocks of
``nn/dsan.py`` against the JAX package, fp32 on the CPU.

``dscn_sample`` on seeded NHWC maps and offsets (up to +-4 taps, so
samples leave the map on both sides and are dropped whole) along x and y,
with groups, dilation, stride, an offset scale and ``remove_center``: the
output within 1e-5 of the largest |JAX| value, and its gradients to the
input and to the offsets within 1e-5 relative norm of ``jax.grad``'s (the
offsets' through the linear weights, 0 at integral locations on both
sides). Offsets whose location falls within 1e-3 of an integer are moved
off it, where either framework may round the floor the other way. The
branch modules (DSCN1D with and without its input projection, DSCNPair)
with numpy-randomised weights through the strict loader, eval at 1e-4 of
the largest |JAX| value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import randomize, transfer
from yolo_ad_refine_tpu.nn import dsan as JD
from yolo_ad_refine_tpu.ops.dscn import dscn_sample as jax_dscn
from yolo_ad_refine_tpu_torch.nn import dsan as PD
from yolo_ad_refine_tpu_torch.ops.dscn import dscn_sample


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# (kernel_size, axis, stride, pad, dilation, group, offset_scale, remove_center, (H, W, C))
SAMPLES = {
    "x": (3, "x", 1, None, 1, 1, 1.0, False, (9, 11, 8)),
    "y": (3, "y", 1, None, 1, 1, 1.0, False, (9, 11, 8)),
    "x_k7_groups": (7, "x", 1, 3, 1, 4, 1.0, False, (6, 13, 16)),
    "y_k7_groups": (7, "y", 1, 3, 1, 4, 1.0, False, (13, 6, 16)),
    "x_dilated_scaled": (5, "x", 1, None, 2, 2, 0.5, False, (7, 12, 8)),
    "y_remove_center": (5, "y", 1, None, 1, 2, 1.0, True, (12, 7, 8)),
    "x_stride2": (3, "x", 2, 1, 1, 1, 1.0, False, (9, 12, 8)),
}


def _sample_case(name, seed=0):
    k, axis, stride, pad, dil, g, scale, rc, (h, w, c) = SAMPLES[name]
    r = np.random.default_rng(seed)
    x = r.normal(0, 1, (2, h, w, c)).astype(np.float32)
    ho, wo = (h, (w + stride - 1) // stride) if axis == "x" else ((h + stride - 1) // stride, w)
    kt = k - int(rc)
    off = r.uniform(-4, 4, (2, ho, wo, g * kt)).astype(np.float32)
    # keep every location 1e-3 off an integer, where floor is decided by rounding
    frac = off - np.round(off)
    off = np.where(np.abs(frac) < 1e-3, off + 2e-3, off).astype(np.float32)
    kw = dict(kernel_size=k, axis=axis, stride=stride, pad=pad, dilation=dil, group=g,
              offset_scale=scale, remove_center=rc)
    return x, off, kw


@pytest.mark.parametrize("name", list(SAMPLES))
def test_dscn_sample_and_its_gradients_match_jax(name):
    x, off, kw = _sample_case(name)

    def f(a, o):
        return jax_dscn(a, o, **kw)

    want = np.asarray(jax.jit(f)(jnp.asarray(x), jnp.asarray(off)))
    cot = np.random.default_rng(1).normal(0, 1, want.shape).astype(np.float32)
    gx, goff = jax.jit(jax.grad(lambda a, o: jnp.sum(f(a, o) * cot), argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(off))
    xt = torch.from_numpy(x).requires_grad_(True)
    ot = torch.from_numpy(off).requires_grad_(True)
    got = dscn_sample(xt, ot, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    (got * torch.from_numpy(cot)).sum().backward()
    for g, w in ((xt.grad, gx), (ot.grad, goff)):
        w = np.asarray(w)
        assert np.linalg.norm(g.numpy() - w) <= 1e-5 * np.linalg.norm(w)


def test_dscn_sample_zero_offsets_is_a_box_filter():
    """With zero offsets and scale 1 the snake is a straight 1 x K box sum
    of the zero-padded map, whatever the framework."""
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (1, 5, 7, 4)).astype(np.float32))
    y = dscn_sample(x, torch.zeros(1, 5, 7, 3), 3, "x")
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1))
    box = xp[:, :, :-2] + xp[:, :, 1:-1] + xp[:, :, 2:]
    torch.testing.assert_close(y, box)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


BRANCHES = {
    "DSCN1D_x": (lambda: JD.DSCN1D(16, 7, 5, 1, 3, 1, 4, axis="x", with_proj=True),
                 lambda: PD.DSCN1D(16, 7, 5, 1, 3, 1, 4, axis="x", with_proj=True)),
    "DSCN1D_y": (lambda: JD.DSCN1D(16, 3, None, 1, 1, 2, 2, axis="y", with_proj=False),
                 lambda: PD.DSCN1D(16, 3, None, 1, 1, 2, 2, axis="y", with_proj=False)),
    "DSCNPair": (lambda: JD.DSCNPair(), lambda: PD.DSCNPair(16)),
    "Mlp": (lambda: JD.Mlp(32), lambda: PD.Mlp(16, 32)),
}


@pytest.mark.parametrize("name", list(BRANCHES))
def test_dsan_branch_matches_jax(name):
    jmod, pmod = (f() for f in BRANCHES[name])
    r = np.random.default_rng(3)
    x = r.normal(0, 1, (2, 9, 11, 16)).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(x)) if name.startswith("DSCN1D") else (jnp.asarray(x),)
    shapes = jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a), *args)
    variables = randomize(shapes, seed=5)
    transfer(pmod, variables)
    want = np.asarray(jax.jit(lambda v, *a: jmod.apply(v, *a))(variables, *args))
    with torch.no_grad():
        got = pmod(*(_nchw(x) for _ in args)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_dscn_offset_head_starts_at_zero():
    """The offset Linear is zero at construction, as the reference's and
    the JAX module's, so a fresh branch samples a straight snake."""
    m = PD.DSCN1D(8, 3)
    assert not m.offset.weight.any() and not m.offset.bias.any()
