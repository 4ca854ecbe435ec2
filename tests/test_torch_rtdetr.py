"""RT-DETR (rtdetr-l) in the PyTorch port against the JAX package, fp32 on
the CPU, with numpy-randomised weights carried over by the strict loader.

Tolerances: each module's output within 1e-5 of max |JAX| (the AIFI
encoder on a non-square 3 x 5 map, where a transposed position embedding
would show); rtdetr-l at 128 (its smallest size: 336 anchors for nq 300)
and the tiny decoder within 1e-4 of max |JAX|, eval and train, with and
without a denoising group; the validator's metrics within 1e-3
(tests/test_fullval_parity.py's) and its val losses 1e-4 relative.
Hazards: (d) the query selection on a flat image, where the encoder's
scores tie, keeps lax.top_k's order (the lower index first); (h) the JAX
predictor runs its NMS on RT-DETR's normalised xywh, so its boxes come out
within 1.5 px of the origin, and the port serves the validator's decode
instead.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import jax_shapes, randomize, transfer
from yolo_ad_refine_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from yolo_ad_refine_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_ad_refine_tpu.nn import block as JB
from yolo_ad_refine_tpu.nn import common as JC
from yolo_ad_refine_tpu.nn import transformer as JTR
from yolo_ad_refine_tpu.train.rtdetr import RTDETRLoss as JaxRTDETRLoss
from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
from yolo_ad_refine_tpu_torch.engine.exporter import AutoBackend, Exporter
from yolo_ad_refine_tpu_torch.engine.predictor import DetectionPredictor
from yolo_ad_refine_tpu_torch.engine.validator import DetectionValidator
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.nn import block as PB
from yolo_ad_refine_tpu_torch.nn import common as PC
from yolo_ad_refine_tpu_torch.nn import transformer as PTR
from yolo_ad_refine_tpu_torch.ops.nms import rtdetr_rows
from yolo_ad_refine_tpu_torch.train.rtdetr import RTDETRLoss
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

IMGSZ, TINY_IMGSZ = 128, 64
# the JAX package's tiny RT-DETR (tests/test_rtdetr_train.py): nc, hd, nq, ndl, d_ffn
TINY = {
    "nc": 3,
    "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "Conv", [32, 3, 2]]],
    "head": [[[2, 3, 4], 1, "RTDETRDecoder", [3, 64, 30, 2, 64]]],
}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _block(name):
    if name == "DWConv":  # gcd(32, 48) = 16 groups
        return JC.DWConv(48, 3, 2, act=False), PC.DWConv(32, 48, 3, 2, 1, False), _x((2, 9, 9, 32))
    if name == "HGStem":  # odd sizes: the bottom / right zero pads decide the shapes
        return JB.HGStem(16, 32), PB.HGStem(3, 16, 32), _x((2, 15, 17, 3))
    if name == "HGBlock":
        return (JB.HGBlock(16, 32, k=3, n=3), PB.HGBlock(24, 16, 32, 3, 3, False, False),
                _x((2, 8, 8, 24)))
    if name == "HGBlock_light_shortcut":
        return (JB.HGBlock(16, 32, k=5, n=2, lightconv=True, shortcut=True),
                PB.HGBlock(32, 16, 32, 5, 2, True, True), _x((2, 8, 8, 32)))
    if name == "RepC3":
        return JB.RepC3(32, n=2), PB.RepC3(24, 32, 2), _x((2, 8, 8, 24))
    if name == "AIFI":  # a non-square map: the sincos grid is w-major, the tokens (h, w)
        return JTR.AIFI(cm=64, num_heads=4), PTR.AIFI(32, 64, 4), _x((2, 3, 5, 32))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["DWConv", "HGStem", "HGBlock", "HGBlock_light_shortcut",
                                  "RepC3", "AIFI"])
def test_block_matches_jax(name):
    jmod, pmod, x = _block(name)
    variables = randomize(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)), seed=3)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    transfer(pmod, variables)
    with torch.no_grad():
        got = pmod(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5


def test_sincos_2d_is_the_jax_grid():
    np.testing.assert_array_equal(PTR.sincos_2d(5, 3, 16), JTR.sincos_2d(5, 3, 16))


SHAPES = ((4, 6), (2, 3))  # two levels, 30 values


@pytest.mark.parametrize("box", [4, 2])
def test_msdeform_attn_matches_jax(box):
    """Reference boxes (xywh) and points (xy); the random offsets put many
    samples off the map, where they read zero."""
    jmod = JTR.MSDeformAttn(d_model=32, n_levels=2, n_heads=4, n_points=3)
    q, v = _x((2, 5, 32), 1), _x((2, 30, 32), 2)
    rb = np.random.default_rng(3).uniform(0.1, 0.9, (2, 5, 2, box)).astype(np.float32)
    variables = randomize(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(rb), jnp.asarray(v), SHAPES)), seed=4)
    want = np.asarray(jmod.apply(variables, jnp.asarray(q), jnp.asarray(rb), jnp.asarray(v),
                                 SHAPES))
    pmod = transfer(PTR.MSDeformAttn(32, 2, 4, 3), variables)
    with torch.no_grad():
        got = pmod(torch.from_numpy(q), torch.from_numpy(rb), torch.from_numpy(v), SHAPES).numpy()
    assert _rel(got, want) <= 1e-5


def test_msda_core_is_zero_outside_and_matches_jax():
    r = np.random.default_rng(5)
    value = r.normal(0, 1, (2, 30, 4, 8)).astype(np.float32)
    loc = r.uniform(-0.3, 1.3, (2, 7, 4, 2, 3, 2)).astype(np.float32)
    loc[0, 0] = 5.0  # far off every map: zero
    w = r.uniform(0, 1, (2, 7, 4, 2, 3)).astype(np.float32)
    want = np.asarray(JTR.ms_deformable_attention(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                                                  jnp.asarray(w)))
    got = PTR.ms_deformable_attention(torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
                                      torch.from_numpy(w)).numpy()
    assert _rel(got, want) <= 1e-5
    assert not got[0, 0].any()


def test_offset_bias_init_is_the_jax_grid():
    want = JTR._msda_offset_bias_init(8, 3, 4)(jax.random.PRNGKey(0), (192,))
    np.testing.assert_array_equal(PTR.msda_offset_bias(8, 3, 4).numpy(), np.asarray(want))
    m = PTR.MSDeformAttn(256, 3, 8, 4)
    m.bias_init()
    assert not m.sampling_offsets.weight.any() and not m.attention_weights.weight.any()


def test_decoder_layer_with_blocked_attention_matches_jax():
    """A blocked mask (True = blocked) where the flax layer takes its
    negation: each query sees itself and one neighbour."""
    jmod = JTR.DeformableDecoderLayer(32, 4, 48, 2, 3)
    emb, qp, v = _x((2, 6, 32), 1), _x((2, 6, 32), 2), _x((2, 30, 32), 3)
    rb = np.random.default_rng(4).uniform(0.1, 0.9, (2, 6, 4)).astype(np.float32)
    blocked = ~(np.eye(6, dtype=bool) | np.eye(6, k=1, dtype=bool))
    args = (jnp.asarray(emb), jnp.asarray(rb), jnp.asarray(v), SHAPES, jnp.asarray(qp),
            jnp.asarray(~blocked)[None, None])
    variables = randomize(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args)), seed=5)
    want = np.asarray(jmod.apply(variables, *args))
    pmod = transfer(PTR.DeformableDecoderLayer(32, 4, 48, 2, 3), variables)
    with torch.no_grad():
        got = pmod(torch.from_numpy(emb), torch.from_numpy(rb), torch.from_numpy(v), SHAPES,
                   torch.from_numpy(qp), torch.from_numpy(blocked)).numpy()
    assert _rel(got, want) <= 1e-5


@pytest.fixture(scope="module")
def decoder():
    ch, hd = (16, 24, 32), 32
    xs = [_x((2, s, s, c), i) for i, (s, c) in enumerate(zip((8, 4, 2), ch))]
    jmod = JTR.RTDETRDecoder(nc=3, ch=ch, hd=hd, nq=10, ndl=2, d_ffn=48)
    variables = randomize(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs])), seed=6)
    pmod = transfer(PTR.RTDETRDecoder(nc=3, ch=ch, hd=hd, nq=10, ndl=2, d_ffn=48), variables)
    return jmod, variables, pmod, xs


def _dn(b=2, ndn=8, t=18, nc=3):
    r = np.random.default_rng(7)
    blocked = np.zeros((t, t), bool)
    blocked[ndn:, :ndn] = True
    blocked[:4, 4:ndn] = blocked[4:ndn, :4] = True  # two blind groups
    return {"cls": r.integers(0, nc, (b, ndn)).astype(np.int32),
            "bbox_logit": r.normal(0, 1, (b, ndn, 4)).astype(np.float32),
            "valid": (r.random((b, ndn)) < 0.7).astype(np.float32), "attn_blocked": blocked}


@pytest.mark.parametrize("mode", ["eval", "train", "train_dn"])
def test_decoder_matches_jax(decoder, mode):
    """Eval gives (y, raw) and train raw; the values are the same in both,
    and the denoising queries go before the selected ones."""
    jmod, variables, pmod, xs = decoder
    jx = [jnp.asarray(x) for x in xs]
    dn = _dn() if mode == "train_dn" else None
    if mode == "eval":
        want = jmod.apply(variables, jx, train=False)
        want = (want[0], *want[1])
    else:
        jdn = None if dn is None else {k: jnp.asarray(v) for k, v in dn.items()}
        want, _ = jmod.apply(variables, jx, train=True, dn=jdn, mutable=["batch_stats"])
    pmod.train(mode != "eval")
    pdn = None if dn is None else {k: torch.from_numpy(v) for k, v in dn.items()}
    with torch.no_grad():
        got = pmod([_nchw(x) for x in xs], dn=pdn)
    pmod.eval()
    if mode == "eval":
        got = (got[0], *got[1])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert _rel(g.numpy(), w) <= 1e-4
    if mode == "train_dn":
        assert got[0].shape[2] == 18  # 8 dn + 10 selected queries


@pytest.fixture(scope="module")
def rtdetr_l():
    jm, shapes = jax_shapes("rtdetr-l.yaml", IMGSZ)
    variables = randomize(shapes, seed=11)
    jm.variables = jax.tree.map(jnp.asarray, variables)
    port = DetectionModel("rtdetr-l.yaml")
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    fwd = jax.jit(lambda v, a: jm.apply(v, a, train=False))
    return jm, port.eval(), fwd


def _tie_scores(variables, head=None):
    """The encoder's score head made constant: every anchor scores alike, so
    only the tie order decides the selected queries."""
    params = variables["params"] if head is None else variables["params"][head]
    leaf = params["enc_score_head"]
    leaf["kernel"] = np.zeros_like(leaf["kernel"])
    leaf["bias"] = np.full_like(leaf["bias"], 0.3)
    return variables


@pytest.mark.parametrize("tied", [False, True])
def test_rtdetr_l_at_128_matches_jax(rtdetr_l, tied):
    """rtdetr-l at its smallest size: every parameter (32,970,476, the RT-DETR
    paper's ~32 M) carried strictly, the eval output and the raw tuple
    within 1e-4. Hazard (d): with every encoder score tied, the stable sort
    selects lax.top_k's queries (the first 300 anchors, in order)."""
    jm, port, fwd = rtdetr_l
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jm.variables["params"]))
    assert port.num_params() == n_jax == 32_970_476
    assert port.task == "detect" and port.head_kind == "rtdetr" and port.probe_strides() is None
    variables = jm.variables
    if tied:
        v = _tie_scores(jax.tree.map(np.asarray, jm.variables), "modules_28")
        variables = jax.tree.map(jnp.asarray, v)
        port = DetectionModel("rtdetr-l.yaml")
        load_jax_variables(port, flatten_tree(v["params"]), flatten_tree(v["batch_stats"]))
        port.eval()
    x = np.random.default_rng(2).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    y, raw = fwd(variables, jnp.asarray(x))
    with torch.no_grad():
        got, got_raw = port(_nchw(x))
    assert got.shape == (2, 300, 84) and torch.isfinite(got).all()
    assert _rel(got.numpy(), y) <= 1e-4
    for g, w in zip(got_raw, raw):
        assert _rel(g.numpy(), w) <= 1e-4
    if tied:
        assert np.ptp(np.asarray(raw[3])) == 0


@pytest.mark.parametrize("train", [False, True])
def test_decoder_on_invalid_anchors_keeps_inf_and_no_nan(train):
    """A 64 x 64 level has anchors within 0.01 of the border, whose logits
    are +inf; with tied scores the first 20 (the top row, all invalid) are
    selected, so every reference box is exactly 1.0 through sigmoid, and
    inverse_sigmoid's clip keeps the refinement finite, as in JAX."""
    xs = [_x((1, 64, 64, 8), 8)]
    jmod = JTR.RTDETRDecoder(nc=3, ch=(8,), hd=16, nq=20, ndl=2, d_ffn=24)
    variables = _tie_scores(randomize(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs])), seed=9))
    pmod = transfer(PTR.RTDETRDecoder(nc=3, ch=(8,), hd=16, nq=20, ndl=2, d_ffn=24), variables)
    if train:
        want, _ = jmod.apply(variables, [jnp.asarray(x) for x in xs], train=True,
                             mutable=["batch_stats"])
    else:
        want = jmod.apply(variables, [jnp.asarray(x) for x in xs], train=False)[1]
    pmod.train(train)
    with torch.no_grad():
        got = pmod([_nchw(x) for x in xs])
    got = got if train else got[1]
    assert (got[2] == 1.0).all()  # sigmoid(+inf + finite)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g.numpy(), w) <= 1e-4


def test_rtdetr_yaml_is_a_byte_identical_copy():
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    name = "rtdetr-l.yaml"
    ours = repo / "yolo_ad_refine_tpu_torch" / "cfg" / "models" / name
    assert ours.read_bytes() == (repo / "yolo_ad_refine_tpu" / "cfg" / "models" / name).read_bytes()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny RT-DETR at 64 on both sides, its score heads raised so that
    rows pass conf, and a shapes val set labelled with the port's own 3
    best rows an image."""
    jm, shapes = jax_shapes(TINY, TINY_IMGSZ)
    variables = randomize(shapes, seed=12)
    head = variables["params"]["modules_5"]
    for k in [k for k in head if "score_head" in k]:
        head[k]["bias"] = head[k]["bias"] + 1.5
    jm.variables = jax.tree.map(jnp.asarray, variables)
    port = DetectionModel(dict(TINY))
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    port.eval()
    root = tmp_path_factory.mktemp("rtdetr_val") / "ds"
    data = make_shapes_dataset(root, n_train=4, n_val=6, imgsz=TINY_IMGSZ, seed=6)
    files = sorted((root / "val" / "images").glob("*.jpg"))
    imgs = [cv2.imread(str(f)) for f in files]
    results = DetectionPredictor({"imgsz": TINY_IMGSZ, "conf": 0.0, "batch": 3})(imgs, model=port)
    for f, r in zip(files, results):
        lines = [f"{int(c)} {(x1 + x2) / 2 / TINY_IMGSZ:.6f} {(y1 + y2) / 2 / TINY_IMGSZ:.6f} "
                 f"{(x2 - x1) / TINY_IMGSZ:.6f} {(y2 - y1) / TINY_IMGSZ:.6f}"
                 for x1, y1, x2, y2, _, c in r.boxes.data[:3]]
        (root / "val" / "labels" / f"{f.stem}.txt").write_text("\n".join(lines) + "\n")
    return jm, port, data, imgs


def test_validation_matches_jax_validator(tiny):
    """The JAX validator's RT-DETR branch (normalised xywh x imgsz, the best
    class, a stable sort by score, no NMS) and its RTDETRLoss val losses."""
    jm, port, data, _ = tiny
    args = {"imgsz": TINY_IMGSZ, "batch": 3, "conf": 0.001, "iou": 0.7, "max_det": 300,
            "max_boxes": 16, "data": data}
    want = JaxValidator(args=dict(args))(
        model=jm, loss_fn=JaxRTDETRLoss(nc=3, nq=30, imgsz=TINY_IMGSZ, max_boxes=16))
    got = DetectionValidator(args=dict(args))(
        model=port, loss_fn=RTDETRLoss(nc=3, nq=30, imgsz=TINY_IMGSZ, max_boxes=16))
    assert want["metrics/mAP50(B)"] > 0.3  # the labels are findable: not vacuous
    for k in ("metrics/mAP50(B)", "metrics/mAP50-95(B)", "metrics/precision(B)",
              "metrics/recall(B)", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    for k in ("val/box_loss", "val/cls_loss", "val/dfl_loss"):
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got[k], want[k])


def test_predict_is_the_validator_decode_where_jax_predictor_misreads(tiny):
    """Hazard (h): the JAX predictor runs its NMS on the normalised xywh, so
    every box it reports lies within 1.5 px of the origin (xywh in [0, 1]
    as xyxy, which may pass 1 by half a width). The port's
    predict takes the validator's decode: each image's rows over conf in
    score order, in pixels, held against ``rtdetr_rows`` of the port's eval
    output (which the strict-load tests hold against the JAX model's)."""
    jm, port, _, imgs = tiny
    bad = JaxPredictor({"imgsz": TINY_IMGSZ, "conf": 0.25, "batch": 3})(source=imgs[:3], model=jm)
    boxes = np.concatenate([np.asarray(r.boxes.data)[:, :4] for r in bad])
    assert len(boxes) and np.abs(boxes).max() <= 1.5
    got = DetectionPredictor({"imgsz": TINY_IMGSZ, "conf": 0.25, "batch": 3})(imgs[:3], model=port)
    x = np.stack([im[..., ::-1] for im in imgs[:3]]).astype(np.float32) / 255.0
    with torch.no_grad():
        det, cnt, _ = rtdetr_rows(port(_nchw(x))[0], 0.25, TINY_IMGSZ)
    assert max(np.abs(r.boxes.data[:, :4]).max() for r in got if len(r)) > 8.0
    for r, d, n in zip(got, det.numpy(), cnt.numpy()):
        assert len(r.boxes.data) == n
        np.testing.assert_allclose(r.boxes.data[:, :4], d[:n, :4].clip(0, TINY_IMGSZ), atol=1e-3)
        np.testing.assert_allclose(r.boxes.data[:, 4:], d[:n, 4:], atol=1e-6)
        assert (np.diff(r.boxes.data[:, 4]) <= 0).all()


def test_backend_validation_of_an_exported_rtdetr_equals_eager(tiny, tmp_path):
    """A TorchScript RT-DETR program validates through its sidecar's head
    kind as the model does (ROADMAP Queue 3 item 1)."""
    _, port, data, _ = tiny
    path = Exporter(port, imgsz=TINY_IMGSZ, batch=4, half=False)("torchscript", tmp_path / "rt")
    backend = AutoBackend(path, device="cpu")
    assert backend.head == "rtdetr" and backend.n_scores == 3
    args = {"imgsz": TINY_IMGSZ, "batch": 4, "conf": 0.001, "data": data}
    want = DetectionValidator(dict(args))(model=port)
    got = DetectionValidator(dict(args))(backend=backend)
    assert want["metrics/mAP50(B)"] > 0.3
    for k in ("metrics/mAP50(B)", "metrics/mAP50-95(B)", "metrics/precision(B)",
              "metrics/recall(B)", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
