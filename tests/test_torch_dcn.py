"""DCNv2 forward of the PyTorch port against the JAX package.

The port's plain version holds against ``ops/deform.py`` (unbounded, the
reference's mmcv semantics) at offsets inside and well beyond 3 px, and with
radius=3 against the TPU kernel ``deform_mxu2`` run in Pallas interpret
mode. The CUDA kernel against the plain version is in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_ad_refine_tpu.ops.deform_mxu2 as dm2
from yolo_ad_refine_tpu.ops.deform import modulated_deform_conv2d as jax_dcn
from yolo_ad_refine_tpu_torch.ops.deform import deform_conv2d_plain, modulated_deform_conv2d


def _inputs(seed=0, b=2, h=13, w=16, c=16, cout=16, off_scale=1.0):
    r = np.random.default_rng(seed)
    x = r.normal(0, 1, (b, h, w, c)).astype(np.float32)
    off = r.normal(0, off_scale, (b, h, w, 18)).astype(np.float32)
    mask = r.random((b, h, w, 9)).astype(np.float32)
    wt = r.normal(0, 0.1, (3, 3, c, cout)).astype(np.float32)
    return x, off, mask, wt


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("off_scale", [1.0, 5.0, 8.0, 17.0])
def test_plain_matches_exact_gather(off_scale):
    x, off, mask, wt = _inputs(seed=int(off_scale), off_scale=off_scale)
    want = np.asarray(jax_dcn(*(jnp.asarray(a) for a in (x, off, mask, wt))))
    got = deform_conv2d_plain(*_t(x, off, mask, wt)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("off_scale", [1.0, 5.0])
def test_plain_radius_matches_tpu_kernel_interpret(monkeypatch, off_scale):
    """radius=3 clips like the TPU kernel K1 (deform_mxu2), run in interpret mode."""
    monkeypatch.setattr(dm2, "_INTERPRET", True)
    x, off, mask, wt = _inputs(seed=3, h=10, w=12, off_scale=off_scale)
    want = np.asarray(dm2.modulated_deform_conv2d_mxu2(
        *(jnp.asarray(a) for a in (x, off, mask, wt)), 3))
    got = deform_conv2d_plain(*_t(x, off, mask, wt), radius=3).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_wrapper_on_cpu_is_plain_version_in_nchw():
    x, off, mask, wt = _inputs(seed=5, off_scale=5.0)
    launches = modulated_deform_conv2d.launches
    nchw = [torch.from_numpy(a).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            for a in (x, off, mask)]
    got = modulated_deform_conv2d(*nchw, torch.from_numpy(wt).permute(3, 2, 0, 1))
    want = deform_conv2d_plain(*_t(x, off, mask, wt))
    assert got.shape == (2, 16, 13, 16)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want.numpy())
    assert modulated_deform_conv2d.launches == launches  # the CPU path launches nothing
