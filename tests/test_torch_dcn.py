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
from yolo_ad_refine_tpu_torch.engine import profile_dcn
from yolo_ad_refine_tpu_torch.ops.deform import (
    SMEM_PER_BLOCK, deform_conv2d_plain, k1_fwd_weight, k1_launch, modulated_deform_conv2d)


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


@pytest.mark.parametrize("kernel,dtype,smem,blocks", [
    ("fwd", torch.float32, 64_512, 3), ("fwd", torch.bfloat16, 44_032, 5),
    ("bwd", torch.float32, 89_088, 2), ("bwd", torch.bfloat16, 56_320, 4)])
def test_k1_launch_fits_the_flagship(kernel, dtype, smem, blocks):
    """K1 at the AYHead's C = Cout = 64: padded mma dimensions and the
    shared memory of a block, and how many such blocks share an SM's
    232,448 bytes."""
    got = k1_launch(kernel, 64, 64, dtype)
    assert got["smem"] == smem and SMEM_PER_BLOCK // smem == blocks
    if kernel == "fwd":
        assert (got["np"], got["cpad"]) == (64, 64)
    else:
        assert (got["cpn"], got["cok"]) == (64, 64)


@pytest.mark.parametrize("c,cout", [(20, 36), (128, 128), (48, 80), (512, 1024)])
def test_k1_forward_launches_at_any_width(c, cout):
    """The forward tiles output channels over blocks and input channels
    over steps, so its shared memory stops growing at Cout = 64."""
    got = k1_launch("fwd", c, cout, torch.float32)
    assert got["cpad"] % 32 == 0 and got["cpad"] >= c
    assert got["np"] == min(-(-cout // 16) * 16, 64)
    assert got["smem"] <= 64_512


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,cout,pairs", [(256, 64, 2), (64, 129, 2), (256, 256, 4),
                                          (384, 384, 9)])
def test_k1_backward_launches_at_any_width(c, cout, pairs, dtype):
    """Past 128 channels (the flagship's DCN at scales m, l: 256; x: 384)
    K1 bwd runs wide: one block a (C-chunk, Cout-chunk) pair of at most 128
    x 128, each with the shared memory of the 128 x 128 backward, within a
    block's 232,448 bytes."""
    got = k1_launch("bwd", c, cout, dtype)
    full = k1_launch("bwd", min(c, 128), min(cout, 128), dtype)
    assert got["wide"] and not full["wide"] and got["pairs"] == pairs and full["pairs"] == 1
    assert (got["cpn"], got["cok"]) == (min(c, 128), min(cout, 128))
    assert got["smem"] == full["smem"] <= SMEM_PER_BLOCK


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_fwd_weight_is_each_tap_transposed_and_padded(dtype):
    r = np.random.default_rng(7)
    w = torch.from_numpy(r.normal(0, 1, (36, 20, 3, 3)).astype(np.float32)).to(dtype)
    wt = k1_fwd_weight(w, k1_launch("fwd", 20, 36, dtype)["cpad"])
    assert wt.shape == (9, 36, 32) and wt.dtype == dtype and wt.is_contiguous()
    for t in range(9):
        np.testing.assert_array_equal(wt[t, :, :20].float().numpy(),
                                      w[:, :, t // 3, t % 3].float().numpy())
    assert not wt[:, :, 20:].any()


@pytest.mark.parametrize("split", sorted(profile_dcn.TREE_SPLITS))
def test_profile_cuts_apply_to_the_kernel_source(split, tmp_path):
    """``engine/profile_dcn.py --tree-split`` times cut copies of
    ``csrc/deform_conv.cu``: each cut must still find its text there, and
    change the source."""
    src = profile_dcn.kernels.CSRC / "deform_conv.cu"
    out = profile_dcn.cut_copy(src, split, profile_dcn.TREE_SPLITS[split], tmp_path)
    assert out.parent == tmp_path and out.read_text() != src.read_text()
