"""MobileSAM's TinyViT encoder in the PyTorch port against the JAX package,
fp32 on the CPU, every params and batch_stats leaf numpy-randomised (the
zero-initialised attention biases too) and carried over strictly.

Tolerances: each block alone within 1e-4 of max |JAX| on odd maps; the
whole encoder and the mobile_sam facade at 128 px (a point and a box):
IoU within 1e-5, the masks equal except at pixels whose JAX logit lies
within 1e-3 of 0. mobile_sam's parameter count at 1024 equals JAX's, and
its carry (params and batch_stats) is strict by shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sam import _scene, _upsampled
from torch_sam_helpers import (
    carry, carry_by_shape, jax_sam_facade, jax_variables, japply, masks_agree, nchw, nhwc,
    port_params, rel, t, x)
from yolo_ad_refine_tpu.models.sam import model as JM
from yolo_ad_refine_tpu.models.sam import tiny_encoder as J
from yolo_ad_refine_tpu_torch.models.sam import model as PM
from yolo_ad_refine_tpu_torch.models.sam import tiny_encoder as P
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_sam_variables

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _case(name):
    """(JAX module, port module, NHWC or token input, port input, port output -> numpy)."""
    tokens = lambda o: o.detach().numpy()  # noqa: E731
    if name == "Conv2d_BN_depthwise_strided":
        a = x((2, 9, 11, 8), 1)
        return J.ConvBN(8, 3, 2, 1, groups=8), P.Conv2d_BN(8, 8, 3, 2, 1, groups=8), a, nchw(a), \
            nhwc
    if name == "MBConv":
        a = x((2, 9, 11, 16), 1)
        return J.MBConv(16), P.MBConv(16, 16), a, nchw(a), nhwc
    if name == "PatchMerging_stride2":
        a = x((2, 9, 11, 16), 1)
        return J.PatchMerging(32), P.PatchMerging(16, 32), a, nchw(a), nhwc
    if name == "PatchMerging_into_320":  # stride 1 into 320 channels
        a = x((1, 6, 6, 40), 1)
        return J.PatchMerging(320), P.PatchMerging(40, 320), a, nchw(a), nhwc
    if name == "Attention_biased":
        a = x((3, 16, 32), 1)
        return (J.BiasedAttention(32, 8, 4, 1.0, (4, 4)), P.Attention(32, 8, 4, 1.0, (4, 4)),
                a, t(a), tokens)
    if name == "Attention_ratio4":
        a = x((2, 9, 32), 1)
        return (J.BiasedAttention(32, 8, 2, 4.0, (3, 3)), P.Attention(32, 8, 2, 4.0, (3, 3)),
                a, t(a), tokens)
    if name == "TinyViTBlock_padded_windows":  # 10 x 10 in windows of 4: padded to 12 x 12
        a = x((2, 100, 32), 1)
        return (J.TinyViTBlock(32, (10, 10), 2, 4), P.TinyViTBlock(32, (10, 10), 2, 4), a, t(a),
                tokens)
    if name == "TinyViTBlock_one_window":
        a = x((2, 49, 32), 1)
        return (J.TinyViTBlock(32, (7, 7), 4, 7), P.TinyViTBlock(32, (7, 7), 4, 7), a, t(a),
                tokens)
    raise KeyError(name)


BLOCKS = ["Conv2d_BN_depthwise_strided", "MBConv", "PatchMerging_stride2",
          "PatchMerging_into_320", "Attention_biased", "Attention_ratio4",
          "TinyViTBlock_padded_windows", "TinyViTBlock_one_window"]


@pytest.mark.parametrize("name", BLOCKS)
def test_block_matches_jax(name):
    jmod, pmod, a, pin, out = _case(name)
    variables = jax_variables(jmod, jnp.asarray(a), seed=3)
    want = japply(jmod, variables, jnp.asarray(a))
    carry(pmod, variables)
    with torch.no_grad():
        got = out(pmod(pin))
    assert got.shape == want.shape
    assert rel(got, want) <= TOL


def test_bias_idxs_match_jax():
    for res in ((4, 4), (3, 5), (7, 7)):
        pi, pn = P._bias_idxs(res)
        ji, jn = J._bias_idxs(res)
        assert pn == jn
        np.testing.assert_array_equal(pi.numpy(), ji)


@pytest.fixture(scope="module")
def facades():
    jsam = jax_sam_facade("mobile_sam", 128, seed=12)
    psam = PM.SAM("mobile_sam", img_size=128, device="cpu")
    load_sam_variables(psam.model, flatten_tree(jsam.variables["params"]),
                       flatten_tree(jsam.variables["batch_stats"]))
    img = _scene(2)
    jsam.set_image(img)
    psam.set_image(img)
    return jsam, psam


def test_tiny_vit_embeddings_match_jax(facades):
    """The whole TinyViT with its neck, at 128 px through the facades."""
    jsam, psam = facades
    assert psam._embeddings.shape == (1, 256, 8, 8)
    assert rel(nhwc(psam._embeddings), np.asarray(jsam._embeddings)) <= TOL


@pytest.mark.parametrize("prompt", ["point", "box"])
def test_mobile_sam_facade_matches_jax(facades, prompt):
    jsam, psam = facades
    kw = dict(points=[[60, 60]]) if prompt == "point" else dict(box=[30, 30, 90, 90],
                                                                multimask_output=False)
    jm, ji = jsam.predict(**kw)
    pm, pi = psam.predict(**kw)
    assert pm.shape == jm.shape
    assert np.abs(pi - ji).max() <= 1e-5
    ok, flipped = masks_agree(pm, jm, _upsampled(jsam, jsam._last_lowres))
    assert ok, flipped


def test_mobile_sam_count_and_carry_by_shape():
    shapes = jax.eval_shape(lambda: JM.build_sam("mobile_sam", 1024)[1])
    with torch.device("meta"):
        pmod = PM.SAMModel(img_size=1024, **PM.SAM_VARIANTS["mobile_sam"])
    assert carry_by_shape(pmod, shapes) == 10_130_348
    assert port_params(pmod) == 10_130_348
    stats = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["batch_stats"]))
    assert stats == sum(b.numel() for n, b in pmod.named_buffers()
                        if n.endswith(("running_mean", "running_var")))
