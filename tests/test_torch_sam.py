"""SAM (ViT encoder, prompt encoder, two-way decoder, facade) in the
PyTorch port against the JAX package, fp32 on the CPU, with every JAX leaf
numpy-randomised (the zero-initialised rel-pos tables and position
embedding too) and carried over by the strict loader.

Tolerances: each module alone within 1e-4 of max |JAX| at sam_test widths
(32 channels, 2 heads, an 8 x 8 grid); the facade at 128 px: IoU within
1e-5, the low-res logits within 1e-4 of max |JAX|, the masks equal except
at pixels whose JAX logit (upsampled as the facade does) lies within 1e-3
of 0, ``generate``'s candidates equal in order (bbox equal, predicted_iou
1e-5, stability 1e-4). Parameter counts of sam_b / l / h equal JAX's, and
their carries are strict, by shape alone (jax.eval_shape; the meta device).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_sam_helpers import (
    carry, carry_by_shape, jax_sam_facade, jax_variables, japply, masks_agree, nchw, nhwc,
    port_params, rel, t, x)
from yolo_ad_refine_tpu.models.sam import model as JM
from yolo_ad_refine_tpu.models.sam import modules as J
from yolo_ad_refine_tpu_torch.models.sam import model as PM
from yolo_ad_refine_tpu_torch.models.sam import modules as P
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
    """(JAX module, port module, JAX inputs, port inputs, port output -> NHWC-like numpy)."""
    same = lambda o: o.detach().numpy()  # noqa: E731
    if name == "LayerNorm2d":
        a = x((2, 5, 7, 16), 1, 3.0) + 2.0
        return J.LayerNorm2d(), P.LayerNorm2d(16), (a,), (nchw(a),), nhwc
    if name == "MLPBlock":
        a = x((2, 5, 32), 1)
        return J.MLPBlock(64), P.MLPBlock(32, 64), (a,), (t(a),), same
    if name == "MLPBlock_relu":
        a = x((2, 5, 32), 1)
        return J.MLPBlock(64, act="relu"), P.MLPBlock(32, 64, "relu"), (a,), (t(a),), same
    if name == "MLP_sigmoid":
        a = x((2, 5, 32), 1)
        return (J.MLP(48, 8, 3, sigmoid=True), P.MLP(32, 48, 8, 3, sigmoid=True), (a,), (t(a),),
                same)
    if name == "REAttention_window":
        a = x((3, 4, 4, 32), 1)
        return (J.REAttention(32, 2, True, (4, 4)), P.REAttention(32, 2, True, (4, 4)), (a,),
                (t(a),), same)
    if name == "ViTBlock_window_padded":  # window 3 over an 8 x 8 grid: padded to 9 x 9
        a = x((1, 8, 8, 32), 1)
        return (J.ViTBlock(32, 2, 4.0, 3, (8, 8)), P.ViTBlock(32, 2, 4.0, 3, (8, 8)), (a,),
                (t(a),), same)
    if name == "ViTBlock_global":
        a = x((2, 8, 8, 32), 1)
        return (J.ViTBlock(32, 2, 4.0, 0, (8, 8)), P.ViTBlock(32, 2, 4.0, 0, (8, 8)), (a,),
                (t(a),), same)
    if name == "ImageEncoderViT":  # sam_test's encoder at 128: windows of 14 pad the 8 x 8 grid
        a = x((1, 128, 128, 3), 1)
        cfg = dict(img_size=128, embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,))
        return (J.ImageEncoderViT(**cfg, out_chans=32), P.ImageEncoderViT(**cfg, out_chans=32),
                (a,), (nchw(a),), nhwc)
    if name == "DownAttention":
        q, k, v = x((2, 5, 32), 1), x((2, 12, 32), 2), x((2, 12, 32), 3)
        return (J.DownAttention(32, 2, 2), P.Attention(32, 2, 2), (q, k, v), (t(q), t(k), t(v)),
                same)
    if name in ("TwoWayAttentionBlock_skip_pe", "TwoWayAttentionBlock"):
        skip = name.endswith("skip_pe")
        q, k, qpe, kpe = x((2, 5, 32), 1), x((2, 64, 32), 2), x((2, 5, 32), 3), x((2, 64, 32), 4)
        return (J.TwoWayAttentionBlock(32, 8, 64, skip), P.TwoWayAttentionBlock(32, 8, 64, skip),
                (q, k, qpe, kpe), tuple(map(t, (q, k, qpe, kpe))), lambda o: tuple(
                    v.detach().numpy() for v in o))
    if name == "TwoWayTransformer":
        img, pe, pts = x((2, 8, 8, 32), 1), x((2, 8, 8, 32), 2), x((2, 5, 32), 3)
        return (J.TwoWayTransformer(2, 32, 8, 64), P.TwoWayTransformer(2, 32, 8, 64),
                (img, pe, pts), (nchw(img), nchw(pe), t(pts)),
                lambda o: tuple(v.detach().numpy() for v in o))
    raise KeyError(name)


MODULES = ["LayerNorm2d", "MLPBlock", "MLPBlock_relu", "MLP_sigmoid", "REAttention_window",
           "ViTBlock_window_padded", "ViTBlock_global", "ImageEncoderViT", "DownAttention",
           "TwoWayAttentionBlock_skip_pe", "TwoWayAttentionBlock", "TwoWayTransformer"]


@pytest.mark.parametrize("name", MODULES)
def test_module_matches_jax(name):
    jmod, pmod, jin, pin, out = _case(name)
    variables = jax_variables(jmod, *map(jnp.asarray, jin), seed=3)
    want = japply(jmod, variables, *map(jnp.asarray, jin))
    carry(pmod, variables)
    with torch.no_grad():
        got = out(pmod(*pin))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.shape == w.shape
        assert rel(g, w) <= TOL


def test_window_partition_round_trip_with_padding():
    a = x((2, 9, 11, 4), 1)
    win, pad = P.window_partition(t(a), 4)
    jwin, jpad = J.window_partition(jnp.asarray(a), 4)
    assert pad == jpad == (12, 12)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    back = P.window_unpartition(win, 4, pad, (9, 11))
    np.testing.assert_array_equal(back.numpy(), a)


def test_rel_coords_match_jax():
    for q, k in ((4, 4), (8, 8), (5, 9)):
        np.testing.assert_array_equal(P._rel_coords(q, k).numpy(), np.asarray(J._rel_coords(q, k)))


@pytest.fixture(scope="module")
def prompt_pair():
    """The JAX prompt encoder (every branch initialised) and its port."""
    jmod = J.PromptEncoder(embed_dim=32, image_embedding_size=(8, 8), input_image_size=(128, 128))
    pts, lab = jnp.zeros((1, 2, 2)), jnp.ones((1, 2))
    variables = jax_variables(jmod, points=(pts, lab), boxes=jnp.zeros((1, 2, 2)),
                              masks=jnp.zeros((1, 32, 32, 1)), seed=5)
    pmod = carry(P.PromptEncoder(32, (8, 8), (128, 128)), variables)
    return jmod, variables, pmod


@pytest.mark.parametrize("kind", ["points_padded", "boxes", "points_and_boxes", "mask"])
def test_prompt_encoder_matches_jax(prompt_pair, kind):
    jmod, variables, pmod = prompt_pair
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 128, (2, 4, 2)).astype(np.float32)
    lab = np.asarray([[1, 0, -1, 1], [0, 1, 1, -1]], np.float32)  # fg, bg and padding slots
    box = rng.uniform(0, 128, (2, 2, 2)).astype(np.float32)
    mask = x((2, 32, 32, 1), 8)
    jkw, pkw = {}, {}
    if kind in ("points_padded", "points_and_boxes"):
        jkw["points"], pkw["points"] = (jnp.asarray(pts), jnp.asarray(lab)), (t(pts), t(lab))
    if kind in ("boxes", "points_and_boxes"):
        jkw["boxes"], pkw["boxes"] = jnp.asarray(box), t(box)
    if kind == "mask":
        jkw["masks"], pkw["masks"] = jnp.asarray(mask), nchw(mask)
    js, jd = japply(jmod, variables, **jkw)
    with torch.no_grad():
        ps, pd = pmod(**pkw)
    assert ps.shape == js.shape
    if js.size:
        assert rel(ps.numpy(), js) <= TOL
    assert rel(nhwc(pd), jd) <= TOL
    dense_pe = japply(jmod, variables, method=J.PromptEncoder.get_dense_pe)
    assert rel(nhwc(pmod.get_dense_pe()), dense_pe[None]) <= TOL


@pytest.mark.parametrize("multimask", [True, False])
def test_mask_decoder_matches_jax(multimask):
    jmod = J.MaskDecoder(transformer_dim=32)
    emb, pe = x((1, 8, 8, 32), 1), x((8, 8, 32), 2)
    sparse, dense = x((2, 5, 32), 3), x((2, 8, 8, 32), 4)
    args = tuple(map(jnp.asarray, (emb, pe, sparse, dense)))
    variables = jax_variables(jmod, *args, True, seed=6)
    jm, ji = japply(jmod, variables, *args, multimask)
    pmod = carry(P.MaskDecoder(32), variables)
    with torch.no_grad():
        pm, pi = pmod(nchw(emb), nchw(pe[None]), t(sparse), nchw(dense), multimask)
    assert pm.shape == jm.shape == (2, 3 if multimask else 1, 32, 32)
    assert rel(pm.numpy(), jm) <= TOL and rel(pi.numpy(), ji) <= TOL


# -- the facade at 128 px -------------------------------------------------------------------


def _scene(seed=0):
    import cv2

    rng = np.random.default_rng(seed)
    img = rng.integers(150, 240, (120, 160, 3), dtype=np.uint8)
    cv2.rectangle(img, (30, 30), (90, 90), (10, 10, 10), -1)
    cv2.circle(img, (120, 50), 20, (40, 200, 40), -1)
    return img


@pytest.fixture(scope="module")
def facades():
    """The JAX and the port facade of sam_test at 128 on the same
    randomised variables (one JAX build and compile for the file)."""
    jsam = jax_sam_facade("sam_test", 128, seed=11)
    psam = PM.SAM("sam_test", img_size=128, device="cpu")
    load_sam_variables(psam.model, flatten_tree(jsam.variables["params"]))
    img = _scene()
    jsam.set_image(img)
    psam.set_image(img)
    return jsam, psam


def _upsampled(sam, lowres):
    """The facade's resize chain without the threshold (its logits per pixel)."""
    import cv2

    h0, w0 = sam._orig_shape
    nh, nw = int(round(h0 * sam._scale)), int(round(w0 * sam._scale))
    return np.stack([cv2.resize(cv2.resize(m, (sam.img_size,) * 2)[:nh, :nw], (w0, h0))
                     for m in lowres])


def test_facade_embeddings_match_jax(facades):
    jsam, psam = facades
    assert rel(nhwc(psam._embeddings), np.asarray(jsam._embeddings)) <= TOL


@pytest.mark.parametrize("prompt", ["point", "multi_point", "box"])
def test_facade_predict_matches_jax(facades, prompt):
    jsam, psam = facades
    kw = {"point": dict(points=[[60, 60]]),
          "multi_point": dict(points=[[60, 60], [10, 10], [120, 50]], labels=[1, 0, 1]),
          "box": dict(box=[30, 30, 90, 90], multimask_output=False)}[prompt]
    jm, ji = jsam.predict(**kw)
    pm, pi = psam.predict(**kw)
    assert pm.shape == jm.shape == ((1 if prompt == "box" else 3), 120, 160)
    assert pm.dtype == bool
    assert np.abs(pi - ji).max() <= 1e-5
    assert rel(psam._last_lowres, jsam._last_lowres) <= TOL
    ok, flipped = masks_agree(pm, jm, _upsampled(jsam, jsam._last_lowres))
    assert ok, flipped


def test_facade_generate_matches_jax(facades):
    jsam, psam = facades
    img = _scene(1)
    kw = dict(points_per_side=3, pred_iou_thresh=-10.0, stability_score_thresh=0.0)
    want = jsam.generate(img, **kw)
    got = psam.generate(img, **kw)
    assert len(want) > 0 and len(got) == len(want)
    for g, w in zip(got, want):
        assert g["bbox"] == w["bbox"]
        assert abs(g["predicted_iou"] - w["predicted_iou"]) <= 1e-5
        assert abs(g["stability_score"] - w["stability_score"]) <= 1e-4


def test_nms_is_the_jax_facades():
    rng = np.random.default_rng(3)
    cands = []
    for _ in range(40):
        x1, y1 = rng.integers(0, 80, 2)
        w, h = rng.integers(1, 40, 2)
        cands.append({"bbox": [int(x1), int(y1), int(x1 + w), int(y1 + h)],
                      "predicted_iou": float(rng.uniform())})
    assert PM.SAM._nms(cands, 0.5) == JM.SAM._nms(cands, 0.5)


def test_sam_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PM.SAM("sam_test", img_size=128)


# -- full width: parameter counts and the carry by shape ----------------------------------

COUNTS = {"sam_b": 93_735_728, "sam_l": 312_343_088, "sam_h": 641_090_864}


@pytest.mark.parametrize("variant", list(COUNTS))
def test_variant_counts_and_carry_by_shape(variant):
    shapes = jax.eval_shape(lambda: JM.build_sam(variant, 1024)[1])
    with torch.device("meta"):
        pmod = PM.SAMModel(img_size=1024, **PM.SAM_VARIANTS[variant])
    assert carry_by_shape(pmod, shapes) == COUNTS[variant]
    assert port_params(pmod) == COUNTS[variant]
