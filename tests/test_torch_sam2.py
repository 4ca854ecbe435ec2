"""SAM2 (Hiera, FPN neck, memory encoder and attention, SAM2 decoder, the
image and video predictors) in the PyTorch port against the JAX package,
fp32 on the CPU, with every JAX leaf numpy-randomised (Hiera's
zero-initialised position embeddings too) and carried over strictly.

Tolerances: the positional helpers within 1e-6 of max |JAX|; the bicubic
resize within 1e-6 (``F.interpolate``'s bicubic is another kernel and
misses it by far more); each module alone within 1e-4 of max |JAX| at
sam2_test widths; ``SAM2Predictor`` at 128 px: IoU within 1e-5, low-res
logits 1e-4, masks equal except where the JAX logit lies within 1e-3 of
0; ``SAM2VideoPredictor`` over 4 frames: each frame's object logit within
1e-4 (relative to max(1, |JAX|)), its memory within 1e-4, its mask as
above. Parameter counts of sam2_t / s / b / l equal JAX's and their carries
are strict, by shape alone.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_sam_helpers import (
    carry, carry_by_shape, jax_sam2, jax_variables, japply, masks_agree, nchw, nhwc, port_params,
    record, rel, t, x)
from yolo_ad_refine_tpu.models.sam import sam2 as JS2
from yolo_ad_refine_tpu.models.sam import sam2_modules as J
from yolo_ad_refine_tpu_torch.models.sam import sam2 as PS2
from yolo_ad_refine_tpu_torch.models.sam import sam2_modules as P
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


# -- positional helpers and the bicubic resize -----------------------------------------------


@pytest.mark.parametrize("hw,dim", [((8, 8), 32), ((5, 7), 64)])
def test_position_embedding_sine_matches_jax(hw, dim):
    want = np.asarray(J.position_embedding_sine(*hw, dim))
    got = P.position_embedding_sine(*hw, dim).permute(1, 2, 0).numpy()
    assert rel(got, want) <= 1e-6


def test_1d_sine_pe_and_rope_match_jax():
    pos = np.asarray([[0.0, 1.0, 3.0, 15.0]], np.float32) / 15
    assert rel(P.get_1d_sine_pe(t(pos), 64).numpy(),
               np.asarray(J.get_1d_sine_pe(jnp.asarray(pos), 64))) <= 1e-6
    for hd, side in ((32, 4), (256, 8)):
        want = np.asarray(J.axial_rope_angles(hd, side, side))
        got = P.axial_rope_angles(hd, side, side).numpy()
        assert rel(got, want) <= 1e-6
        a = x((2, 1, side * side, hd), 1)
        assert rel(P.apply_rotary(t(a), t(got)).numpy(),
                   np.asarray(J.apply_rotary(jnp.asarray(a), jnp.asarray(want)))) <= 1e-6


@pytest.mark.parametrize("size_in,size_out", [((7, 7), (32, 32)), ((14, 14), (32, 32)),
                                              ((7, 7), (256, 256)), ((9, 6), (20, 31))])
def test_resize_bicubic_is_jax_bicubic(size_in, size_out):
    """Keys' kernel at a = -0.5 with JAX's half-pixel centres and edge
    renormalisation; F.interpolate's bicubic (a = -0.75, clamped edges) is
    not it, which is why the port carries its own."""
    a = x((1, 8, *size_in), 2)
    want = np.asarray(jax.image.resize(jnp.asarray(a), (1, 8, *size_out), method="bicubic"))
    got = P.resize_bicubic(t(a), size_out).numpy()
    assert rel(got, want) <= 1e-6
    torch_bicubic = F.interpolate(t(a), size_out, mode="bicubic", align_corners=False).numpy()
    assert rel(torch_bicubic, want) > 1e-2


# -- modules ----------------------------------------------------------------------------------


def _case(name):
    """(JAX module, port module, JAX inputs, port inputs, kwargs, port output -> numpy)."""
    same = lambda o: o.detach().numpy()  # noqa: E731
    if name == "MultiScaleAttention_qpool":
        a = x((3, 8, 8, 16), 1)
        return J.MultiScaleAttention(32, 2, (2, 2)), P.MultiScaleAttention(16, 32, 2, (2, 2)), \
            (a,), (t(a),), {}, same
    if name == "MultiScaleBlock_stage_change":  # windows of 4 pad 10 -> 12, q-pool to 5 x 5
        a = x((1, 10, 10, 16), 1)
        return (J.MultiScaleBlock(16, 32, 2, (2, 2), 4),
                P.MultiScaleBlock(16, 32, 2, 4.0, (2, 2), 4),
                (a,), (t(a),), {}, same)
    if name == "MultiScaleBlock_global":
        a = x((2, 6, 6, 16), 1)
        return (J.MultiScaleBlock(16, 16, 2, None, 0), P.MultiScaleBlock(16, 16, 2, 4.0, None, 0),
                (a,), (t(a),), {}, same)
    if name == "Hiera":  # sam2_test's trunk at 128: the bicubic-resized background embedding
        a = x((1, 128, 128, 3), 1)
        cfg = dict(embed_dim=16, num_heads=1, stages=(1, 1, 1, 1), global_att_blocks=(2,),
                   window_pos_embed_bkg_spatial_size=(7, 7), window_spec=(8, 4, 4, 4))
        return J.Hiera(**cfg), P.Hiera(**cfg), (a,), (nchw(a),), {}, \
            lambda o: [nhwc(v) for v in o]
    if name == "FpnNeck":
        xs = [x((1, 32 // 2**i, 32 // 2**i, 16 * 2**i), i) for i in range(4)]
        return (J.FpnNeck(32, (128, 64, 32, 16)), P.FpnNeck(32, (128, 64, 32, 16)), (xs,),
                ([nchw(v) for v in xs],), {}, lambda o: ([nhwc(v) for v in o[0]],
                                                         [nhwc(v)[0] for v in o[1]]))
    if name == "CXBlock":
        a = x((2, 9, 11, 32), 1)
        return J.CXBlock(32), P.CXBlock(32), (a,), (nchw(a),), {}, nhwc
    if name == "MaskDownSampler":
        a = x((1, 64, 64, 1), 1)
        return J.MaskDownSampler(32), P.MaskDownSampler(32), (a,), (nchw(a),), {}, nhwc
    if name in ("MemoryEncoder", "MemoryEncoder_skip_sigmoid"):
        pix, m = x((1, 8, 8, 32), 1), x((1, 128, 128, 1), 2, 5.0)
        kw = {"skip_mask_sigmoid": name.endswith("sigmoid")}
        return J.MemoryEncoder(16, 32), P.MemoryEncoder(16, 32), (pix, m), (nchw(pix), nchw(m)), \
            kw, lambda o: (nhwc(o[0]), nhwc(o[1]))
    if name == "RoPEAttention_self":
        a = x((2, 16, 32), 1)
        return J.RoPEAttention(32, 1), P.RoPEAttention(32, 1), (a, a, a), (t(a),) * 3, {}, same
    if name in ("RoPEAttention_cross_masked", "RoPEAttention_every_slot_masked"):
        q, k, v = x((2, 16, 32), 1), x((2, 38, 16), 2), x((2, 38, 16), 3)
        mask = np.random.default_rng(4).uniform(size=(2, 38)) > 0.3
        if name.endswith("every_slot_masked"):
            mask[:] = False  # no valid slot: JAX's -1e9 gives the uniform softmax, not NaN
        return (J.RoPEAttention(32, 1, kv_in_dim=16, rope_k_repeat=True),
                P.RoPEAttention(32, 1, kv_in_dim=16, rope_k_repeat=True), (q, k, v),
                (t(q), t(k), t(v)), {"num_k_exclude_rope": 6, "k_mask": mask}, same)
    if name == "MemoryAttentionLayer":
        tgt, mem, pos, qpos = x((2, 16, 32), 1), x((2, 38, 16), 2), x((2, 38, 16), 3), \
            x((2, 16, 32), 4)
        mask = np.random.default_rng(5).uniform(size=(2, 38)) > 0.3
        return (J.MemoryAttentionLayer(32, 64, 16), P.MemoryAttentionLayer(32, 64, 16),
                (tgt, mem, pos, qpos), tuple(map(t, (tgt, mem, pos, qpos))),
                {"num_k_exclude_rope": 6, "k_mask": mask}, same)
    if name == "MemoryAttention":
        cur, mem, cpos, mpos = x((2, 16, 32), 1), x((2, 38, 16), 2), x((2, 16, 32), 3), \
            x((2, 38, 16), 4)
        mask = np.random.default_rng(6).uniform(size=(2, 38)) > 0.3
        return (J.MemoryAttention(32, 2, 16), P.MemoryAttention(32, 2, 16),
                (cur, mem, cpos, mpos), tuple(map(t, (cur, mem, cpos, mpos))),
                {"num_obj_ptr_tokens": 6, "k_mask": mask}, same)
    raise KeyError(name)


MODULES = ["MultiScaleAttention_qpool", "MultiScaleBlock_stage_change", "MultiScaleBlock_global",
           "Hiera", "FpnNeck", "CXBlock", "MaskDownSampler", "MemoryEncoder",
           "MemoryEncoder_skip_sigmoid", "RoPEAttention_self", "RoPEAttention_cross_masked",
           "RoPEAttention_every_slot_masked", "MemoryAttentionLayer", "MemoryAttention"]


def _flat(o):
    if isinstance(o, (list, tuple)):
        return [v for i in o for v in _flat(i)]
    return [o]


@pytest.mark.parametrize("name", MODULES)
def test_module_matches_jax(name):
    jmod, pmod, jin, pin, kw, out = _case(name)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    pkw = {k: t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jargs = jax.tree.map(jnp.asarray, jin)
    variables = jax_variables(jmod, *jargs, seed=3, **jkw)
    want = _flat(japply(jmod, variables, *jargs, **jkw))
    carry(pmod, variables)
    with torch.no_grad():
        got = _flat(out(pmod(*pin, **pkw)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.isfinite(g).all()
        assert rel(g, w) <= TOL


@pytest.mark.parametrize("multimask", [True, False])
def test_sam2_mask_decoder_matches_jax(multimask):
    """With the high-res skip features and the object-score token; single
    mask output goes through the dynamic multimask fallback."""
    jmod = J.SAM2MaskDecoder(transformer_dim=32)
    emb, pe = x((2, 8, 8, 32), 1), x((8, 8, 32), 2)
    sparse, dense = x((2, 5, 32), 3), x((2, 8, 8, 32), 4)
    hr = [x((2, 32, 32, 4), 5), x((2, 16, 16, 8), 6)]
    args = tuple(map(jnp.asarray, (emb, pe, sparse, dense)))
    variables = jax_variables(jmod, *args, True, [jnp.asarray(h) for h in hr], seed=6)
    want = japply(jmod, variables, *args, multimask, [jnp.asarray(h) for h in hr])
    pmod = P.SAM2MaskDecoder(32)
    del pmod.conv_s0, pmod.conv_s1  # the net's in JAX: SAM2Net applies them when it encodes
    carry(pmod, variables)
    with torch.no_grad():
        got = pmod(nchw(emb), nchw(pe[None]), t(sparse), nchw(dense), multimask,
                   [nchw(h) for h in hr])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel(g.numpy(), w) <= TOL


def test_dynamic_multimask_fallback_matches_jax():
    """Token 0 unstable (every logit near 0): the best multimask output
    replaces it; a stable token 0 stays."""
    masks = np.stack([np.full((8, 8), v, np.float32) for v in (0.01, -5.0, 6.0, -5.0)])[None]
    masks = np.concatenate([masks, masks + np.asarray([9.0, 0, 0, 0], np.float32)[None, :, None,
                                                                                None]])
    ious = np.asarray([[0.9, 0.1, 0.8, 0.2], [0.9, 0.1, 0.8, 0.2]], np.float32)
    jm, ji = J.SAM2MaskDecoder(transformer_dim=32)._dynamic_multimask(jnp.asarray(masks),
                                                                     jnp.asarray(ious))
    pm, pi = P.SAM2MaskDecoder(32)._dynamic_multimask(t(masks), t(ious))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert float(pi[0, 0]) == pytest.approx(0.8) and float(pm[0, 0, 0, 0]) == 6.0
    assert float(pi[1, 0]) == pytest.approx(0.9)


# -- the predictors at 128 px -------------------------------------------------------------------


def _frames(n=4):
    rng = np.random.default_rng(1)
    frames = []
    for i in range(n):
        f = rng.integers(0, 60, (128, 128, 3), dtype=np.uint8)
        x0 = 30 + 6 * i
        cv2.rectangle(f, (x0, 40), (x0 + 40, 80), (250, 240, 230), -1)
        frames.append(f)
    return frames


@pytest.fixture(scope="module")
def image_predictors():
    jp = jax_sam2(JS2.SAM2Predictor, "sam2_test", seed=21)
    pp = PS2.SAM2Predictor("sam2_test", device="cpu")
    load_sam_variables(pp.net, flatten_tree(jp.variables["params"]))
    return jp, pp


def test_sam2_predictor_matches_jax(image_predictors):
    jp, pp = image_predictors
    img = np.random.default_rng(0).integers(0, 255, (96, 120, 3), dtype=np.uint8)
    cv2.rectangle(img, (40, 30), (90, 70), (240, 240, 240), -1)
    jp.set_image(img)
    pp.set_image(img)
    for g, w in zip(pp._feats, jp._feats):
        assert rel(nhwc(g), np.asarray(w)) <= TOL
    jlow = record(jp, "_heads", lambda o: o[0][0])
    plow = record(pp.net, "sam_heads", lambda o: o[0][0])
    jm, ji = jp.predict(points=[[60, 48], [20, 20]], labels=[1, 0])
    pm, pi = pp.predict(points=[[60, 48], [20, 20]], labels=[1, 0])
    assert pm.shape == jm.shape == (3, 96, 120) and pm.dtype == bool
    assert np.abs(pi - ji).max() <= 1e-5
    assert rel(plow[0], jlow[0]) <= TOL
    order = np.argsort(-ji)
    up = np.stack([cv2.resize(cv2.resize(m, (128, 128))[:96, :120], (120, 96))
                   for m in jlow[0][order]])
    ok, flipped = masks_agree(pm, jm, up)
    assert ok, flipped


def test_sam2_video_predictor_matches_jax():
    frames = _frames(4)
    jv = jax_sam2(JS2.SAM2VideoPredictor, "sam2_test", seed=22)
    pv = PS2.SAM2VideoPredictor("sam2_test", device="cpu")
    load_sam_variables(pv.net, flatten_tree(jv.variables["params"]))
    jhi = record(jv, "_heads", lambda o: o[3][0, 0])
    jm0 = jv.add_points(frames[0], 0, points=[[50, 60]])
    pm0 = pv.add_points(frames[0], 0, points=[[50, 60]])
    assert pm0.shape == (128, 128)
    ok, flipped = masks_agree(pm0, jm0, jhi[-1])
    assert ok, flipped
    for i in range(1, 4):
        jm, jl = jv.track(frames[i], i)
        pm, pl = pv.track(frames[i], i)
        assert abs(pl - jl) <= 1e-4 * max(1.0, abs(jl)), (i, pl, jl)
        ok, flipped = masks_agree(pm, jm, jhi[-1])
        assert ok, (i, flipped)
        for k in ("mem_feat", "mem_pos"):
            assert rel(nhwc(pv.non_cond_frames[i][k]), jv.non_cond_frames[i][k]) <= TOL
        assert rel(pv.non_cond_frames[i]["obj_ptr"].numpy(),
                   jv.non_cond_frames[i]["obj_ptr"]) <= TOL
    assert set(pv.non_cond_frames) == set(jv.non_cond_frames) == {1, 2, 3}
    assert set(pv.cond_frames) == {0}


def test_predictors_without_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (PS2.SAM2Predictor, PS2.SAM2VideoPredictor):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls("sam2_test")


# -- full width -----------------------------------------------------------------------------

COUNTS = {"sam2_t": 38_946_242, "sam2_s": 46_044_098, "sam2_b": 80_833_922,
          "sam2_l": 224_430_386}


@pytest.mark.parametrize("variant", list(COUNTS))
def test_variant_counts_and_carry_by_shape(variant):
    shapes = jax.eval_shape(lambda: JS2.build_sam2(variant, 1024)[1])
    with torch.device("meta"):
        pmod = PS2.SAM2Net(**PS2.SAM2_CONFIGS[variant])
    assert carry_by_shape(pmod, shapes) == COUNTS[variant]
    assert port_params(pmod) == COUNTS[variant]
