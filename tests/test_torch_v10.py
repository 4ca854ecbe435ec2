"""YOLOv10 (NMS-free) in the PyTorch port against the JAX package, fp32 on
the CPU, with numpy-randomised weights carried over by the strict loader.

Tolerances: the v10 blocks' outputs 1e-5 absolute (PSA, attention, 1e-4);
yolov10n at 64: the eval branch maps 1e-5 absolute, the selected rows
(boxes in pixels, up to ~500 with random weights) 1e-4 of max |JAX|, the
train-mode maps 1e-3 of max |JAX| (batch-statistics BatchNorm over 2
images of a 2 x 2 level, 8 values a channel, scales the rounding up to
~1.2e-4 of it); E2EDetectLoss's total 1e-5 relative, its components 1e-5
relative and its gradients 1e-4 relative norm per leaf against the same
step in fp64, or within 4 times the other fp32 side's distance from it
(the rule of tests/test_torch_obb_train.py: random weights make the two
fp32 sides land ~5e-4 apart on the first conv, and 1.5e-5 apart on the
small box component; leaf norms floored at 1e-6 of the largest); the
validator's metrics 1e-3 (tests/test_fullval_parity.py's). Hazards: (d) the selection
under fully tied scores keeps lax.top_k's order (lower index first); (g)
the one-to-one loss alone leaves every backbone gradient empty; (a) the JAX
predictor runs its NMS on v10's selected rows and reads the class column
as a score, so the port serves the validator's NMS-free rows instead.
"""

import copy

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import jax_shapes, randomize, transfer
from yolo_ad_refine_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from yolo_ad_refine_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_ad_refine_tpu.models.model import DetectionModel as JaxDetectionModel
from yolo_ad_refine_tpu.nn import conv_extras as JCE
from yolo_ad_refine_tpu.train.loss import E2EDetectLoss as JaxE2ELoss
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
from yolo_ad_refine_tpu_torch.engine.predictor import DetectionPredictor
from yolo_ad_refine_tpu_torch.engine.validator import DetectionValidator
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.nn import conv_extras as PCE
from yolo_ad_refine_tpu_torch.ops.boxes import xywh2xyxy
from yolo_ad_refine_tpu_torch.train.loss import E2EDetectLoss
from yolo_ad_refine_tpu_torch.train.trainer import synthetic_batch
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, jax_to_port, load_jax_variables

IMGSZ, NC, STRIDES = 64, 4, (8, 16, 32)


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


def _block(name):
    x = _x((2, 8, 8, 32))
    if name == "SCDown":
        return JCE.SCDown(48, 3, 2), PCE.SCDown(32, 48, 3, 2), x, 1e-5
    if name in ("CIB", "CIB_lk"):
        lk = name == "CIB_lk"
        return JCE.CIB(32, True, e=1.0, lk=lk), PCE.CIB(32, 32, True, e=1.0, lk=lk), x, 1e-5
    if name == "RepVGGDW":
        return JCE.RepVGGDW(32), PCE.RepVGGDW(32), x, 1e-5
    if name == "C2fCIB":
        return (JCE.C2fCIB(48, n=2, shortcut=True, lk=True), PCE.C2fCIB(32, 48, 2, True, True),
                x, 1e-5)
    if name == "PSA":
        xp = _x((2, 6, 6, 128), seed=1)
        return JCE.PSA(128), PCE.PSA(128, 128), xp, 1e-4
    raise KeyError(name)


@pytest.mark.parametrize("name", ["SCDown", "RepVGGDW", "CIB", "CIB_lk", "C2fCIB", "PSA"])
def test_v10_block_matches_jax(name):
    jmod, pmod, x, atol = _block(name)
    variables = randomize(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)), seed=3)
    want = jmod.apply(variables, jnp.asarray(x), train=False)
    transfer(pmod, variables)
    with torch.no_grad():
        got = pmod(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=atol)


def _tie(variables):
    """The one-to-one class branch's last conv made constant: every anchor
    and class scores the same, so only the tie order decides the rows."""
    head = variables["params"]["modules_23"]
    for i in range(3):
        leaf = head[f"cv3_one2one_{i}_2"]
        leaf["kernel"] = np.zeros_like(leaf["kernel"])
        leaf["bias"] = np.full_like(leaf["bias"], 0.3)
    return variables


@pytest.fixture(scope="module")
def v10n():
    cfg = dict(JaxDetectionModel("yolov10n.yaml").yaml, nc=NC, scale="n")
    jm, shapes = jax_shapes(cfg, IMGSZ)
    variables = randomize(shapes, seed=11)
    jm.variables = jax.tree.map(jnp.asarray, variables)
    jm.strides = STRIDES
    port = DetectionModel(dict(jm.yaml))
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    port.strides = STRIDES
    return jm, variables, port.eval()


@pytest.fixture(scope="module")
def jax_eval(v10n):
    """The JAX model's eval forward, compiled once for every weight set."""
    jm = v10n[0]
    return jax.jit(lambda v, a: jm.apply(v, a, train=False))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _maps(m):
    return {k: [a.detach().permute(0, 2, 3, 1).numpy() for a in v] for k, v in m.items()}


def test_v10n_loads_strictly_and_matches_jax(v10n, jax_eval):
    jm, variables, port = v10n
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert port.num_params() == n_jax == 2_708_584
    x = np.random.default_rng(2).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    det, maps = jax_eval(jm.variables, jnp.asarray(x))
    with torch.no_grad():
        got, got_maps = port(_nchw(x))
    assert got.shape == (2, 84, 6)  # min(max_det, 84 anchors) rows
    assert _rel(got.numpy(), det) <= 1e-4
    for k, levels in _maps(got_maps).items():
        for g, w in zip(levels, maps[k]):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)
    port.train()
    train_maps = port(_nchw(x))
    want_train, _ = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=True))(
        jm.variables, jnp.asarray(x))
    port.eval()
    for k, levels in _maps(train_maps).items():
        for g, w in zip(levels, want_train[k]):
            assert _rel(g, w) <= 1e-3


def test_tied_selection_keeps_top_k_order(v10n, jax_eval):
    """Hazard (d): with every score tied, the rows come in anchor order on
    both sides (lax.top_k's; the port's stable descending sort)."""
    jm, variables, _ = v10n
    tied = _tie(copy.deepcopy(variables))
    port = DetectionModel(dict(jm.yaml))
    load_jax_variables(port, flatten_tree(tied["params"]), flatten_tree(tied["batch_stats"]))
    x = np.random.default_rng(3).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    det, _ = jax_eval(jax.tree.map(jnp.asarray, tied), jnp.asarray(x))
    with torch.no_grad():
        got, _ = port.eval()(_nchw(x))
    assert np.ptp(np.asarray(det)[..., 4]) == 0  # all tied
    assert _rel(got.numpy(), det) <= 1e-4


def _targets():
    batch = synthetic_batch(4, IMGSZ, 8, NC, seed=5)
    return batch, {k: torch.from_numpy(batch[k]) for k in ("cls", "bboxes", "mask")}


def test_e2e_loss_and_gradients_match_jax(v10n):
    jm, variables, _ = v10n
    batch, t = _targets()
    img = batch["img"].astype(np.float32) / 255.0
    jloss = JaxE2ELoss(NC, STRIDES)

    def loss_fn(params):
        feats, _ = jm.graph.apply({"params": params, "batch_stats": jm.variables["batch_stats"]},
                                  jnp.asarray(img), train=True, mutable=["batch_stats"])
        out = jloss(feats, jnp.asarray(batch["cls"]), jnp.asarray(batch["bboxes"]),
                    jnp.asarray(batch["mask"]))
        return out.total, out.components

    (total, comps), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jm.variables["params"])
    port = DetectionModel(dict(jm.yaml))
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    port.strides = STRIDES
    port.train()
    port64 = copy.deepcopy(port).double()
    out64 = E2EDetectLoss(NC, STRIDES)(port64(_nchw(img).double()),
                                       *(v.double() for v in t.values()))
    out64.total.backward()
    out = E2EDetectLoss(NC, STRIDES)(port(_nchw(img)), t["cls"], t["bboxes"], t["mask"])
    out.total.backward()
    # the loss by the same rule as the leaves below, per component: both fp32
    # sides land within 1.5e-5 of each other on the small box component
    exact = out64.components.numpy()
    for got, want, ex in zip(out.components.numpy(), np.asarray(comps), exact):
        port_off, jax_off, lim = abs(got - ex), abs(want - ex), 1e-5 * abs(ex)
        assert port_off <= max(lim, 4 * jax_off) and jax_off <= max(lim, 4 * port_off)
    assert abs(out.total.item() - float(total)) <= 1e-5 * abs(float(total))
    want = jax_to_port(port, flatten_tree(jax.tree.map(np.asarray, grads)),
                       collections=("params",))
    named, named64 = dict(port.named_parameters()), dict(port64.named_parameters())
    assert want.keys() == named.keys()
    # the obb train test's rule: each fp32 side within 1e-4 of the fp64 step,
    # or within 4 times the other side's distance from it; a leaf's norm is
    # floored at 1e-6 of the largest leaf's (the P5 box branch, which no
    # target reaches, has a gradient of rounding noise, ~1e-10)
    floor = 1e-6 * max(np.linalg.norm(p.grad.numpy()) for p in named64.values())
    bad, within = [], 0
    for k, w in want.items():
        exact = named64[k].grad.numpy()
        lim = 1e-4 * max(np.linalg.norm(exact), floor)
        port_off = np.linalg.norm(named[k].grad.numpy() - exact)
        jax_off = np.linalg.norm(w - exact)
        within += bool(port_off <= lim)
        if port_off > max(lim, 4 * jax_off) or jax_off > max(lim, 4 * port_off):
            bad.append(f"{k}: |port - fp64| {port_off:.2e}, |jax - fp64| {jax_off:.2e}, "
                       f"limit {lim:.2e}")
    assert not bad, bad
    assert within > len(want) // 2, within


def test_one2one_loss_reaches_no_backbone_weight(v10n):
    """Hazard (g): the one-to-one branches read detached inputs, so their
    loss alone gives the backbone and neck no gradient, only the
    cv2_one2one / cv3_one2one weights."""
    jm, variables, _ = v10n
    _, t = _targets()
    port = DetectionModel(dict(jm.yaml))
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    port.strides = STRIDES
    port.train()
    x = _nchw(np.random.default_rng(4).random((4, IMGSZ, IMGSZ, 3)).astype(np.float32))
    loss = E2EDetectLoss(NC, STRIDES).one2one(port(x)["one2one"], t["cls"], t["bboxes"],
                                              t["mask"])
    loss.total.backward()
    reached = {n for n, p in port.named_parameters() if p.grad is not None and p.grad.any()}
    assert reached and all("_one2one." in n for n in reached), sorted(reached)[:5]
    assert any(n.startswith("model.23.cv3_one2one.") for n in reached)


@pytest.fixture(scope="module")
def val_setup(tmp_path_factory, v10n):
    """The shapes val set labelled with the port's own 3 best rows."""
    jm, variables, _ = v10n
    cfg = dict(jm.yaml, nc=3)
    jm3, shapes = jax_shapes(cfg, IMGSZ)
    v3 = randomize(shapes, seed=12)
    jm3.variables = jax.tree.map(jnp.asarray, v3)
    jm3.strides = STRIDES
    port = DetectionModel(cfg)
    load_jax_variables(port, flatten_tree(v3["params"]), flatten_tree(v3["batch_stats"]))
    port.strides = STRIDES
    port.eval()
    root = tmp_path_factory.mktemp("v10val") / "ds"
    data = make_shapes_dataset(root, n_train=4, n_val=6, imgsz=IMGSZ, seed=6)
    files = sorted((root / "val" / "images").glob("*.jpg"))
    imgs = [cv2.imread(str(f)) for f in files]
    results = DetectionPredictor({"imgsz": IMGSZ, "conf": 0.0, "batch": 3})(imgs, model=port)
    for f, r in zip(files, results):
        lines = [f"{int(c)} {(x1 + x2) / 2 / IMGSZ:.6f} {(y1 + y2) / 2 / IMGSZ:.6f} "
                 f"{(x2 - x1) / IMGSZ:.6f} {(y2 - y1) / IMGSZ:.6f}"
                 for x1, y1, x2, y2, _, c in r.boxes.data[:3]]
        (root / "val" / "labels" / f"{f.stem}.txt").write_text("\n".join(lines) + "\n")
    return jm3, port, data, imgs


def test_validation_matches_jax_validator(val_setup):
    jm3, port, data, _ = val_setup
    args = {"imgsz": IMGSZ, "batch": 3, "conf": 0.001, "iou": 0.7, "max_det": 300,
            "max_boxes": 16, "data": data}
    want = JaxValidator(args=dict(args))(model=jm3)
    got = DetectionValidator(args=dict(args))(model=port)
    assert want["metrics/mAP50(B)"] > 0.3  # the labels are findable: not vacuous
    for k in ("metrics/mAP50(B)", "metrics/mAP50-95(B)", "metrics/precision(B)",
              "metrics/recall(B)", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


def test_predict_is_nms_free_where_jax_predictor_misreads(val_setup):
    """Hazard (a): the JAX predictor puts v10's (B, 300, 6) rows through its
    NMS with nc=80 columns, so it takes the class column as a score (conf
    1 or more) and the classes it reports are 0 or 1. The port's predict
    takes the JAX validator's NMS-free rows: each image's rows over conf,
    in order, as xyxy, held against the port's own eval rows (which the
    strict-load test holds against the JAX model's)."""
    jm3, port, _, imgs = val_setup
    bad = JaxPredictor({"imgsz": IMGSZ, "conf": 0.001, "batch": 3})(source=imgs[:3], model=jm3)
    confs = np.concatenate([np.asarray(r.boxes.conf) for r in bad])
    classes = np.concatenate([np.asarray(r.boxes.cls) for r in bad])
    assert confs.max() >= 1.0 and set(classes.tolist()) <= {0.0, 1.0}
    got = DetectionPredictor({"imgsz": IMGSZ, "conf": 0.05, "batch": 3})(imgs[:3], model=port)
    x = np.stack([im[..., ::-1] for im in imgs[:3]]).astype(np.float32) / 255.0
    with torch.no_grad():
        det = port(_nchw(x))[0].numpy()
    for r, d in zip(got, det):
        d = d[d[:, 4] > 0.05]
        assert len(d) and len(r.boxes.data) == len(d)
        want = xywh2xyxy(torch.from_numpy(d[:, :4])).clamp(0, IMGSZ).numpy()
        np.testing.assert_allclose(r.boxes.data[:, :4], want, atol=1e-3)
        np.testing.assert_allclose(r.boxes.data[:, 4], d[:, 4], atol=1e-5)
        np.testing.assert_array_equal(r.boxes.data[:, 5], d[:, 5])


def test_yolo_train_and_val_run_e2e(val_setup, tmp_path):
    _, _, data, _ = val_setup
    m = YOLO("yolov10n.yaml", device="cpu", imgsz=IMGSZ, nc=3)
    m.train(data=data, epochs=1, batch=4, imgsz=IMGSZ, project=str(tmp_path), plots=False)
    val_loss = m.trainer.last_epoch_scalars["val/box_loss"]  # E2EDetectLoss's val loss
    assert np.isfinite(val_loss) and val_loss > 0
    assert type(m.trainer.loss_fn).__name__ == "E2EDetectLoss"
    v = m.val(data=data, imgsz=IMGSZ, batch=3)  # the reloaded best
    assert 0.0 <= v["metrics/mAP50(B)"] <= 1.0


@pytest.mark.parametrize("name", ["yolo11-cls.yaml", "yolov8-cls.yaml", "yolov10n.yaml",
                                  "yolov10s.yaml", "yolov8-world.yaml", "yolov8-worldv2.yaml"])
def test_slice_yamls_are_byte_identical_copies(name):
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    ours = repo / "yolo_ad_refine_tpu_torch" / "cfg" / "models" / name
    assert ours.read_bytes() == (repo / "yolo_ad_refine_tpu" / "cfg" / "models" / name).read_bytes()


def test_yolov10s_loads_strictly():
    """Scale s puts C2fCIB in the backbone too (row 8): every leaf of the
    JAX model's shapes maps, at the published widths (nc 80)."""
    jm, shapes = jax_shapes("yolov10s.yaml", IMGSZ)
    port = DetectionModel("yolov10s.yaml")
    variables = randomize(shapes, seed=13)
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert port.num_params() == n_jax == 8_128_256
    assert [s.name for s in port.specs].count("C2fCIB") == 2


def test_backend_validation_of_an_exported_v10_program_equals_eager(val_setup, tmp_path):
    """ROADMAP Queue 3 item 1: the sidecar records the head kind, so an
    exported yolov10n program's (B, 300, 6) selected rows take the
    NMS-free branch through the backend as through the model. A sidecar
    written without the head kind (as before it was recorded) counts as a
    plain detect head, and the program's 6 columns then raise at the first
    batch instead of going through K4's selection at nc."""
    import json

    from yolo_ad_refine_tpu_torch.engine.exporter import AutoBackend, Exporter

    _, port, data, _ = val_setup
    path = Exporter(port, imgsz=IMGSZ, batch=3, half=False)("torchscript", tmp_path / "v10")
    meta = json.loads(open(f"{path}.meta.json").read())
    assert meta["head"] == "v10" and meta["n_scores"] == 3
    args = {"imgsz": IMGSZ, "batch": 3, "conf": 0.001, "data": data}
    want = DetectionValidator(dict(args))(model=port)
    got = DetectionValidator(dict(args))(backend=AutoBackend(path, device="cpu"))
    assert want["metrics/mAP50(B)"] > 0.3
    for k in ("metrics/mAP50(B)", "metrics/mAP50-95(B)", "metrics/precision(B)",
              "metrics/recall(B)", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    old = {k: v for k, v in meta.items() if k not in ("head", "n_scores")}
    open(f"{path}.meta.json", "w").write(json.dumps(old))
    with pytest.raises(ValueError, match="export the model again"):
        DetectionValidator(dict(args))(backend=AutoBackend(path, device="cpu"))
