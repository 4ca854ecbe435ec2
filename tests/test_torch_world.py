"""YOLO-World (open vocabulary) in the PyTorch port against the JAX package,
fp32 on the CPU, with numpy-randomised weights carried over by the strict
loader.

Tolerances: encode_class_names and the placeholder text bit-equal;
adaptive_max_pool2d bit-equal to F.adaptive_max_pool2d and to the JAX one
(hazard (f): the same bins at every map size of the yamls at 640 and 64);
the blocks 1e-5 absolute, 1e-4 through attention (MaxSigmoidAttnBlock,
C2fAttn, ImagePoolingAttn); the whole models' eval outputs (boxes in
pixels, scores) 1e-4 of max |JAX| and their train maps 1e-3 of it
(batch-statistics BatchNorm over a 2 x 2 level); predicted boxes 1e-3 px
and scores 1e-5; the validator's metrics 1e-3. Hazards: (b) the JAX
validator hands K4's candidate selection the yaml's nc, not the
vocabulary's, and so picks wrong anchors and classes after set_classes;
the port's validator takes the vocabulary's count (its predictor, like the
JAX one, is right either way); (c) the JAX train step raises on a World
graph, and so does the port's trainer.
"""

import copy

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_weights import jax_shapes, randomize, transfer
from yolo_ad_refine_tpu import YOLO as JaxYOLO
from yolo_ad_refine_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from yolo_ad_refine_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_ad_refine_tpu.models.model import DetectionModel as JaxDetectionModel
from yolo_ad_refine_tpu.nn import block as JB
from yolo_ad_refine_tpu.nn import head as JH
from yolo_ad_refine_tpu.ops.nms import non_max_suppression as jax_nms
from yolo_ad_refine_tpu.train.loss import DetectionLoss as JaxDetectionLoss
from yolo_ad_refine_tpu.train.optim import build_optimizer as jax_build_optimizer
from yolo_ad_refine_tpu.train.step import TrainState, make_train_step
from yolo_ad_refine_tpu.utils.text import encode_class_names as jax_encode
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
from yolo_ad_refine_tpu_torch.engine.predictor import DetectionPredictor
from yolo_ad_refine_tpu_torch.engine.validator import DetectionValidator
from yolo_ad_refine_tpu_torch.models.model import DetectionModel, placeholder_text
from yolo_ad_refine_tpu_torch.nn import block as PB
from yolo_ad_refine_tpu_torch.nn import head as PH
from yolo_ad_refine_tpu_torch.ops.nms import non_max_suppression
from yolo_ad_refine_tpu_torch.train.trainer import DetectionTrainer
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables
from yolo_ad_refine_tpu_torch.utils.text import encode_class_names

IMGSZ, NC, STRIDES = 64, 4, (8, 16, 32)
NAMES = ["person", "car", "dog"]


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
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("names,embed", [(NAMES, 512), (["traffic light", "traffic-light",
                                                         "a", "", "Zebra Crossing"], 64)])
def test_encode_class_names_bit_equal(names, embed):
    got = encode_class_names(names, embed)
    np.testing.assert_array_equal(got, jax_encode(names, embed))
    assert got.dtype == np.float32 and got.shape == (len(names), embed)


@pytest.mark.parametrize("size", [80, 40, 20, 8, 4, 2, 3, 1])
def test_adaptive_max_pool_bins_match_torch_and_jax(size):
    """Hazard (f): the World yaml's maps (80, 40, 20 at 640; 8, 4, 2 at
    64) and odd sizes pool into the same 3 x 3 bins in torch's
    F.adaptive_max_pool2d, which ImagePoolingAttn calls, and the JAX one."""
    x = _x((2, size, size + 1, 5), seed=size)
    got = F.adaptive_max_pool2d(_nchw(x), 3)
    want = JB.adaptive_max_pool2d(jnp.asarray(x), 3)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def _block(name):
    x = _x((2, 8, 8, 32))
    guide = _x((2, 5, 24), seed=1)
    if name == "MaxSigmoidAttnBlock":
        return (JB.MaxSigmoidAttnBlock(32, nh=4, ec=32), PB.MaxSigmoidAttnBlock(32, 32, 4, 32, 24),
                (x, guide), 1e-4)
    if name == "MaxSigmoidAttnBlock_ec":  # 16 input channels: the ec projection to 32
        x16 = _x((2, 8, 8, 16), seed=3)
        return (JB.MaxSigmoidAttnBlock(32, nh=4, ec=32), PB.MaxSigmoidAttnBlock(16, 32, 4, 32, 24),
                (x16, guide), 1e-4)
    if name == "C2fAttn":
        return (JB.C2fAttn(48, n=2, ec=24, nh=2), PB.C2fAttn(32, 48, 2, ec=24, nh=2, gc=24),
                (x, guide), 1e-4)
    if name == "ImagePoolingAttn":
        xs = [_x((2, s, s, c), seed=s) for s, c in ((8, 16), (4, 32), (2, 64))]
        text = _x((2, 5, 40), seed=2)
        return (JB.ImagePoolingAttn(ec=32, ch=(16, 32, 64), ct=40, nh=4),
                PB.ImagePoolingAttn(32, (16, 32, 64), ct=40, nh=4), (xs, text), 1e-4)
    raise KeyError(name)


def _port_args(args):
    return [[_nchw(a) for a in x] if isinstance(x, list) else
            (_nchw(x) if x.ndim == 4 else torch.from_numpy(x)) for x in args]


@pytest.mark.parametrize("name", ["MaxSigmoidAttnBlock", "MaxSigmoidAttnBlock_ec", "C2fAttn",
                                  "ImagePoolingAttn"])
def test_world_block_matches_jax(name):
    jmod, pmod, args, atol = _block(name)
    jargs = jax.tree.map(jnp.asarray, args)
    variables = randomize(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), *jargs, train=False)), seed=5)
    want = np.asarray(jmod.apply(variables, *jargs, train=False))
    transfer(pmod, variables)
    with torch.no_grad():
        got = pmod(*_port_args(args))
    got = got.permute(0, 2, 3, 1) if got.ndim == 4 else got
    np.testing.assert_allclose(got.numpy(), want, atol=atol)


@pytest.mark.parametrize("with_bn", [True, False])
def test_world_head_matches_jax(with_bn):
    xs = [_x((2, s, s, 32), seed=10 + s) for s in (8, 4, 2)]
    text = encode_class_names(NAMES, 48)
    jmod = JH.WorldDetect(nc=NC, embed=48, with_bn=with_bn, ch=(32, 32, 32))
    jxs = [jnp.asarray(a) for a in xs]
    variables = randomize(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jxs, text_feats=jnp.asarray(text))), seed=6)
    pmod = transfer(PH.WorldDetect(NC, 48, with_bn, (32, 32, 32)), variables)
    y, maps = jmod.apply(variables, jxs, text_feats=jnp.asarray(text), input_h=16)
    with torch.no_grad():
        got, got_maps = pmod([_nchw(a) for a in xs], text_feats=torch.from_numpy(text), input_h=16)
    assert got.shape == (2, 84, 4 + 3)  # the vocabulary's columns
    assert _rel(got.numpy(), y) <= 1e-5
    for g, w in zip(got_maps, maps):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), atol=1e-4)
    want_t, _ = jmod.apply(variables, jxs, text_feats=jnp.asarray(text), train=True,
                           mutable=["batch_stats"])
    pmod.train()
    for g, w in zip(pmod([_nchw(a) for a in xs], text_feats=torch.from_numpy(text)), want_t):
        assert _rel(g.detach().permute(0, 2, 3, 1).numpy(), w) <= 1e-4


def _world_shapes(cfg):
    """jax_shapes for a World graph: its init needs the placeholder text."""
    m = JaxDetectionModel(cfg)
    shapes = jax.eval_shape(lambda: m.graph.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False,
        text_feats=jnp.asarray(m.text_feats)))
    return m, {c: shapes[c] for c in ("params", "batch_stats")}


def _world(cfg_name, nc=NC, seed=11):
    cfg = dict(JaxDetectionModel(cfg_name).yaml, nc=nc, scale="n")
    jm, shapes = _world_shapes(cfg)
    variables = randomize(shapes, seed=seed)
    jm.variables = jax.tree.map(jnp.asarray, variables)
    jm.strides = STRIDES
    port = DetectionModel(dict(jm.yaml))
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    port.strides = STRIDES
    return jm, variables, port.eval()


def _apply(jm, x, **kw):
    return jax.jit(lambda v, a: jm.apply(v, a, **kw))(jm.variables, jnp.asarray(x))


@pytest.mark.parametrize("cfg,n_params", [("yolov8n-worldv2.yaml", 3_543_679),
                                          ("yolov8n-world.yaml", 4_052_607)])
def test_world_model_loads_strictly_and_matches_jax(cfg, n_params):
    jm, variables, port = _world(cfg)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert port.num_params() == n_jax == n_params
    np.testing.assert_array_equal(port.text_feats.numpy(), jm.text_feats)  # the placeholder
    np.testing.assert_array_equal(placeholder_text(NC, 512), jm.text_feats)
    x = np.random.default_rng(2).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    y, _ = _apply(jm, x, train=False)
    with torch.no_grad():
        got, _ = port(_nchw(x))
    assert got.shape == (2, 84, 4 + NC)
    assert _rel(got.numpy(), y) <= 1e-4
    want_t, _ = _apply(jm, x, train=True, mutable=True)
    port.train()
    for g, w in zip(port(_nchw(x)), want_t):
        assert _rel(g.detach().permute(0, 2, 3, 1).numpy(), w) <= 1e-3
    port.eval()


def test_default_text_graph_matches_jax():
    """A WorldDetect without C2fAttn rows scores against its learned
    default_text, a leaf the strict loader carries."""
    cfg = {"nc": 3, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                                 [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                                 [-1, 1, "Conv", [32, 3, 2]]],
           "head": [[[2, 3, 4], 1, "WorldDetect", ["nc", 24, True]]]}
    jm, shapes = jax_shapes(cfg, IMGSZ)
    variables = randomize(shapes, seed=3)
    assert "default_text" in variables["params"]["modules_5"]
    jm.variables = jax.tree.map(jnp.asarray, variables)
    port = DetectionModel(cfg)
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    assert port.text_feats is None
    x = np.random.default_rng(4).random((1, IMGSZ, IMGSZ, 3)).astype(np.float32)
    y, _ = _apply(jm, x, train=False)
    with torch.no_grad():
        got, _ = port.eval()(_nchw(x))
    assert _rel(got.numpy(), y) <= 1e-5


@pytest.fixture(scope="module")
def worldv2():
    return _world("yolov8n-worldv2.yaml")


def _facades(jm, variables):
    """The JAX and port facades over the same weights (the JAX one without
    its own init)."""
    jy = JaxYOLO.__new__(JaxYOLO)
    jy.model, jy.overrides = jm, {"model": "yolov8n-worldv2.yaml", "task": "detect"}
    py = YOLO("yolov8n-worldv2.yaml", device="cpu", imgsz=IMGSZ, nc=jm.nc)
    load_jax_variables(py.model, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    return jy, py


def test_set_classes_matches_jax(worldv2):
    jm, variables, _ = worldv2
    jy, py = _facades(copy.copy(jm), variables)
    x = np.random.default_rng(5).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    outs = []
    apply = jax.jit(lambda v, a, t: jy.model.apply(v, a, text_feats=t))
    for names in (NAMES, ["bicycle", "bus", "cat"]):
        jy.set_classes(names)
        py.set_classes(names)
        assert py.model.names == dict(enumerate(names)) == jy.model.names
        np.testing.assert_array_equal(py.model.text_feats.numpy(), jy.model.text_feats)
        y, _ = apply(jm.variables, jnp.asarray(x), jnp.asarray(jy.model.text_feats))
        with torch.no_grad():
            got, _ = py.model.eval()(_nchw(x))
        assert got.shape == (2, 84, 4 + 3) and py.model.n_scores == 3
        assert _rel(got.numpy(), y) <= 1e-4
        outs.append(got[..., 4:])
    assert not torch.allclose(outs[0], outs[1])  # the scores follow the names
    with pytest.raises(ValueError, match="WorldDetect"):
        YOLO("yolov10n.yaml", device="cpu", imgsz=IMGSZ).set_classes(NAMES)


def test_predict_matches_jax_predictor(worldv2):
    """K4's candidates over the vocabulary's columns (the plain version of
    K4 here): the JAX predictor's single-label selection is right with
    either nc, and the port's rows equal its rows."""
    jm, variables, _ = worldv2
    jy, py = _facades(copy.copy(jm), variables)
    jy.set_classes(NAMES)
    py.set_classes(NAMES)
    imgs = [np.random.default_rng(i).integers(0, 255, (IMGSZ, IMGSZ, 3), dtype=np.uint8)
            for i in range(3)]
    args = {"imgsz": IMGSZ, "conf": 0.01, "batch": 3}
    want = JaxPredictor(dict(args))(source=imgs, model=jy.model)
    got = DetectionPredictor(dict(args))(imgs, model=py.model)
    n = 0
    for g, w in zip(got, want):
        gd, wd = np.asarray(g.boxes.data), np.asarray(w.boxes.data)
        assert gd.shape == wd.shape
        np.testing.assert_allclose(gd[:, :4], wd[:, :4], atol=1e-3)
        np.testing.assert_allclose(gd[:, 4], wd[:, 4], atol=1e-5)
        np.testing.assert_array_equal(gd[:, 5], wd[:, 5])
        n += len(gd)
    assert n > 0 and set(np.concatenate([np.asarray(g.boxes.data)[:, 5] for g in got])) <= {
        0.0, 1.0, 2.0}


def test_validator_selection_uses_the_vocabulary(worldv2):
    """Hazard (b): after set_classes with 3 names on a 4-class yaml, the JAX
    validator's multi-label selection (nc=4 over 3 columns) maps flat
    indices to wrong anchors and classes; the port's validator hands K4's
    selection the vocabulary's 3, which equals the JAX NMS given nc=3."""
    jm, variables, port = worldv2
    port = copy.deepcopy(port)
    port.text_feats = torch.from_numpy(encode_class_names(NAMES, 512))
    x = np.random.default_rng(6).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    with torch.no_grad():
        y, _ = port(_nchw(x))
    kw = dict(conf_thres=0.001, iou_thres=0.7, multi_label=True, use_pallas=False)
    bad_det, bad_cnt, _ = jax_nms(jnp.asarray(y.numpy()), nc=jm.nc, **kw)
    good_det, good_cnt, _ = jax_nms(jnp.asarray(y.numpy()), nc=3, **kw)
    assert (np.asarray(bad_det)[..., 5] >= 3).any() or not np.array_equal(bad_cnt, good_cnt)
    det, cnt, _ = non_max_suppression(y, conf_thres=0.001, iou_thres=0.7, multi_label=True,
                                      nc=port.n_scores)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(good_cnt))
    np.testing.assert_allclose(det.numpy(), np.asarray(good_det), atol=1e-4)


def test_validation_matches_jax_validator(tmp_path):
    """A 3-class yaml with a 3-name vocabulary, where the JAX validator's nc
    is the vocabulary's: the metrics on the shapes val set labelled with
    the port's own 3 best rows."""
    jm, variables, port = _world("yolov8n-worldv2.yaml", nc=3, seed=12)
    t = encode_class_names(["disc", "box", "tri"], 512)
    jm.text_feats, port.text_feats = t, torch.from_numpy(t)
    root = tmp_path / "ds"
    data = make_shapes_dataset(root, n_train=1, n_val=6, imgsz=IMGSZ, seed=8)
    files = sorted((root / "val" / "images").glob("*.jpg"))
    imgs = [cv2.imread(str(f)) for f in files]
    results = DetectionPredictor({"imgsz": IMGSZ, "conf": 0.0, "batch": 3})(imgs, model=port)
    for f, r in zip(files, results):
        lines = [f"{int(c)} {(x1 + x2) / 2 / IMGSZ:.6f} {(y1 + y2) / 2 / IMGSZ:.6f} "
                 f"{(x2 - x1) / IMGSZ:.6f} {(y2 - y1) / IMGSZ:.6f}"
                 for x1, y1, x2, y2, _, c in r.boxes.data[:3]]
        (root / "val" / "labels" / f"{f.stem}.txt").write_text("\n".join(lines) + "\n")
    args = {"imgsz": IMGSZ, "batch": 3, "conf": 0.001, "iou": 0.7, "max_det": 300,
            "max_boxes": 16, "data": data}
    want = JaxValidator(args=dict(args))(model=jm)
    got = DetectionValidator(args=dict(args))(model=port)
    assert want["metrics/mAP50(B)"] > 0.3
    for k in ("metrics/mAP50(B)", "metrics/mAP50-95(B)", "metrics/precision(B)",
              "metrics/recall(B)", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


def test_world_training_raises_as_in_jax(worldv2, tmp_path):
    """Hazard (c): the JAX train step calls the graph without text_feats, so
    its C2fAttn rows raise; the port's trainer raises on a World graph."""
    jm, variables, port = worldv2
    tx, _, _ = jax_build_optimizer(variables["params"], optimizer="SGD", epochs=1, nb=1,
                                   batch=2, nbs=2, warmup_epochs=0.0, nc=NC)
    state = TrainState.create(jm.variables, tx)
    batch = {"img": jnp.zeros((2, IMGSZ, IMGSZ, 3), jnp.uint8), "cls": jnp.zeros((2, 4, 1)),
             "bboxes": jnp.zeros((2, 4, 4)), "mask": jnp.zeros((2, 4, 1))}
    with pytest.raises(ValueError, match="C2fAttn needs text embeddings"):
        jax.jit(make_train_step(jm.graph, JaxDetectionLoss(NC, STRIDES), tx))(
            state, batch, jax.random.PRNGKey(0))
    data = make_shapes_dataset(tmp_path / "ds", n_train=2, n_val=2, imgsz=IMGSZ)
    with pytest.raises(ValueError, match="C2fAttn needs text embeddings"):
        DetectionTrainer({"data": data, "epochs": 1, "batch": 2, "imgsz": IMGSZ,
                          "project": str(tmp_path), "plots": False, "device": "cpu"},
                         model=copy.deepcopy(port)).train()


def test_worldv2_at_scale_s_loads_strictly():
    """yolov8s-worldv2, the size the card serves: every leaf maps (nc 80,
    the placeholder's 80 rows)."""
    jm, shapes = _world_shapes(dict(JaxDetectionModel("yolov8s-worldv2.yaml").yaml, scale="s"))
    port = DetectionModel(dict(jm.yaml))
    variables = randomize(shapes, seed=14)
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert port.num_params() == n_jax == 12_759_864
    assert tuple(port.text_feats.shape) == (80, 512)


def _label_with_own_rows(root, data, model, imgsz):
    """Each val image labelled with the model's own 3 best rows (random
    labels would give mAP 0 on every route and prove nothing)."""
    files = sorted((root / "val" / "images").glob("*.jpg"))
    results = DetectionPredictor({"imgsz": imgsz, "conf": 1e-6, "batch": 3})(
        [cv2.imread(str(f)) for f in files], model=model)
    for f, r in zip(files, results):
        rows = [f"{int(c)} " + " ".join(f"{v:.6f}" for v in b)
                for b, c in zip(r.boxes.xywhn[:3], r.boxes.cls[:3])]
        (root / "val" / "labels" / f"{f.stem}.txt").write_text("\n".join(rows) + "\n")
    return data


def test_backend_validation_of_an_exported_world_program_equals_eager(tmp_path):
    """ROADMAP Queue 3 item 1: a yolov8s-worldv2 program exported after
    set_classes with 3 names gives 4 + 3 columns; its sidecar records the
    head kind and the vocabulary's 3 scores (its nc stays the yaml's 80),
    so the backend's K4 selection takes 3 classes, as the model's does."""
    from yolo_ad_refine_tpu_torch.engine.exporter import AutoBackend

    m = YOLO("yolov8s-worldv2.yaml", device="cpu", imgsz=IMGSZ).set_classes(NAMES)
    root = tmp_path / "ds"
    data = _label_with_own_rows(root, make_shapes_dataset(root, n_train=1, n_val=6,
                                                          imgsz=IMGSZ, seed=9), m.model, IMGSZ)
    path = m.export(format="torchscript", imgsz=IMGSZ, batch=3, half=False,
                    path=str(tmp_path / "w"))
    backend = AutoBackend(path, device="cpu")
    assert (backend.head, backend.n_scores, backend.nc) == ("world", 3, 80)
    # the seeded head scores ~5e-5: under the default conf nothing would be kept
    args = {"imgsz": IMGSZ, "batch": 3, "conf": 1e-6, "data": data}
    want = DetectionValidator(dict(args))(model=m.model)
    got = DetectionValidator(dict(args))(backend=backend)
    assert want["metrics/mAP50(B)"] > 0.1  # not vacuous: the seeded boxes span the image
    for k in ("metrics/mAP50(B)", "metrics/mAP50-95(B)", "metrics/precision(B)",
              "metrics/recall(B)", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def test_vocabulary_survives_a_checkpoint(tmp_path):
    """ROADMAP Queue 3 item 3: the port's checkpoint carries text_feats, so
    a reload predicts over the same 3 names as before (the JAX checkpoint
    keeps no text_feats: intended difference). A checkpoint written without
    them (as before) would reload the 80-row placeholder beside 3 names,
    and raises."""
    m = YOLO("yolov8n-worldv2.yaml", device="cpu", imgsz=IMGSZ).set_classes(NAMES)
    imgs = [np.random.default_rng(i).integers(0, 255, (IMGSZ, IMGSZ, 3), dtype=np.uint8)
            for i in range(2)]
    before = m.predict(imgs, conf=1e-6, imgsz=IMGSZ)
    path = m.export(format="checkpoint", path=str(tmp_path / "ckpt"))
    again = YOLO(str(path), device="cpu")
    assert again.model.names == dict(enumerate(NAMES)) and again.model.n_scores == 3
    after = again.predict(imgs, conf=1e-6, imgsz=IMGSZ)
    assert sum(len(r) for r in before) > 0
    for a, b in zip(before, after):
        np.testing.assert_allclose(np.asarray(b.boxes.data), np.asarray(a.boxes.data),
                                   atol=1e-5)
    (path / "text_feats.pt").unlink()
    with pytest.raises(ValueError, match="3 names but 80 text embeddings"):
        YOLO(str(path), device="cpu")
