"""The gather probe's port (``ops/gather.py``) against the JAX package.

The TPU kernel ``kernel`` of ``benchmarks/bench_dcn.py::probe_pallas_gather``
asks for TPU VMEM and has no interpret mode, so its body is the reference:
``jnp.take(x, idx, axis=0, fill_value=0)`` under ``jax.vmap`` over the
batch, as the probe maps its ``pallas_call``. The port's plain version
must be equal to it bit for bit: it copies rows. The CUDA kernel against
the plain version is in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_ad_refine_tpu_torch.engine import profile_gather
from yolo_ad_refine_tpu_torch.ops.gather import gather_rows, gather_rows_plain


def _probe_body(x, idx):
    return np.asarray(jax.vmap(lambda a, i: jnp.take(a, i, axis=0, fill_value=0))(x, idx))


def test_take_fill_semantics_are_pinned():
    """Indices -1, -3, -4, 2, 3 into 3 rows give rows 2, 0, zeros, 2, zeros:
    [-N, -1] wraps, below -N and at N or above fill."""
    x = np.arange(6, dtype=np.float32).reshape(1, 3, 2)
    idx = np.asarray([[-1, -3, -4, 2, 3]], np.int32)
    want = np.asarray([[[4, 5], [0, 1], [0, 0], [4, 5], [0, 0]]], np.float32)
    np.testing.assert_array_equal(_probe_body(jnp.asarray(x), jnp.asarray(idx)), want)
    np.testing.assert_array_equal(gather_rows_plain(torch.from_numpy(x),
                                                    torch.from_numpy(idx)).numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["in_range", "wrapped", "out_of_range", "mixed"])
def test_plain_equals_the_probe_body(dtype, kind):
    r = np.random.default_rng(len(kind))
    b, n, c = 3, 50, 8
    x = r.normal(0, 1, (b, n, c)).astype(np.float32)
    lo, hi = {"in_range": (0, n), "wrapped": (-n, 0), "out_of_range": (n, 3 * n),
              "mixed": (-2 * n, 2 * n)}[kind]
    idx = r.integers(lo, hi, (b, 9 * n)).astype(np.int32)
    if kind == "out_of_range":
        idx[1] = -idx[1] - 1  # below -N too
    jt = getattr(jnp, dtype)
    want = _probe_body(jnp.asarray(x, jt), jnp.asarray(idx))
    got = gather_rows_plain(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(idx))
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, 9 * n, c)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    if kind == "out_of_range":
        assert not got.any()


def test_wrapper_on_cpu_is_the_plain_version():
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.random((2, 20, 4)).astype(np.float32))
    idx = torch.from_numpy(r.integers(-30, 30, (2, 180)).astype(np.int32))
    launches = gather_rows.launches
    assert torch.equal(gather_rows(x, idx), gather_rows_plain(x, idx))
    assert gather_rows.launches == launches  # the CPU path launches nothing


@pytest.mark.parametrize("dtype,nbytes", [(torch.bfloat16, 353_740_800),
                                          (torch.float32, 697_804_800)])
def test_profile_probe_shapes_and_bound(dtype, nbytes):
    """``profile_gather`` draws the probe's inputs as bench_dcn.py does (a
    fresh default_rng(0) a level: x by ``random``, idx by ``integers(0,
    H*W)``), and its bound over the three levels at batch 32 is the bytes of
    x, idx and the output (8,400 rows of 64 and 75,600 indices and output
    rows an image) over 3.35 TB/s: 0.1056 ms in bf16, 0.2083 in fp32."""
    total = 0.0
    for h, w in profile_gather.LEVELS:
        x, idx = profile_gather.probe_inputs(2, h, w, dtype, "cpu")
        r = np.random.default_rng(0)
        np.testing.assert_array_equal(x.float().numpy(), torch.from_numpy(
            r.random((2, h * w, 64))).to(dtype).float().numpy())
        np.testing.assert_array_equal(idx.numpy(), r.integers(0, h * w, (2, 9 * h * w)))
        assert idx.dtype == torch.int32
        total += profile_gather.bound_ms(x, idx) * 16  # batch 2 -> 32: bytes scale with the batch
    assert total == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
