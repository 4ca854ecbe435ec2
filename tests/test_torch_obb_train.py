"""OBB training in the PyTorch port against the JAX package, fp32 on the CPU:
the rotated candidate test, the rotated TAL assigner, OBBLoss and its
gradient, probiou's gradient where its clamps act, the augmented OBB
sample, one train step of yolo11n-obb, the OBB val loss, and a tiny
``YOLO.train(task="obb")`` whose checkpoint reloads as OBB.

Tolerances: candidates, fg mask, labels and gt indices bit-equal; assigner
boxes 1e-6 and scores 1e-5; the loss 1e-5 relative and its gradient 1e-4
relative norm (sums over ~1,000 anchors in another order); probiou's value
1e-6 and gradient 1e-5 of max |ref|; the augmented image bit-equal (the
same cv2 and numpy calls on both sides) and its xywhr 1e-4; the train step
at the train slice's limits (loss 1e-5 relative and each gradient leaf
1e-4 relative norm, both held against the same step in fp64, params,
BN stats and EMA 1e-5 of max |ref|); the val losses 1e-4 relative (an eval
forward of ~100 fp32 layers, as the OBB slice's decoded output at 1e-4).
"""

import copy

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_weights import jax_shapes, randomize
from yolo_ad_refine_tpu.data.dataset import YOLODataset as JaxYOLODataset
from yolo_ad_refine_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_ad_refine_tpu.ops.iou import probiou as jax_probiou
from yolo_ad_refine_tpu.train.obb import OBBLoss as JaxOBBLoss
from yolo_ad_refine_tpu.train.obb import RotatedTaskAlignedAssigner as JaxRTAL
from yolo_ad_refine_tpu.train.obb import (
    select_candidates_in_rotated_gts as jax_select_candidates)
from yolo_ad_refine_tpu.train.optim import build_optimizer as jax_build_optimizer
from yolo_ad_refine_tpu.train.step import TrainState, make_train_step
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.data.build import DataLoader
from yolo_ad_refine_tpu_torch.data.dataset import YOLODataset
from yolo_ad_refine_tpu_torch.data.synthetic import make_dota_dataset
from yolo_ad_refine_tpu_torch.engine.validator import DetectionValidator
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.ops.iou import probiou
from yolo_ad_refine_tpu_torch.train.obb import (
    OBBLoss, RotatedTaskAlignedAssigner, select_candidates_in_rotated_gts)
from yolo_ad_refine_tpu_torch.train.optim import ModelEMA, build_optimizer
from yolo_ad_refine_tpu_torch.train.step import TrainStep, images_to_tensor
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

CFG, IMGSZ, NC, BATCH, MAX_BOXES = "yolo11n-obb.yaml", 128, 15, 2, 8
OPT = dict(optimizer="SGD", lr0=0.01, lrf=0.01, momentum=0.937, weight_decay=0.0005, epochs=1,
           nb=1, batch=BATCH, nbs=BATCH, warmup_epochs=0.0, warmup_momentum=0.8,
           warmup_bias_lr=0.1, cos_lr=False, nc=NC)
STRIDES = (8, 16, 32)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend.
    The one train step (``steps``) runs at the process's own count: its
    gradient rule sits at the fp32 rounding of the conv weight sums, which
    the thread count's split of those sums moves."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield n
    torch.set_num_threads(n)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _rboxes(r, shape, lo=8.0, hi=120.0):
    """xywhr boxes inside a 128 px tile, angles over [-pi/4, 3pi/4)."""
    xy = r.uniform(lo + 16, hi - 16, shape + (2,))
    wh = r.uniform(4, 40, shape + (2,))
    ang = r.uniform(-np.pi / 4, 3 * np.pi / 4, shape + (1,))
    return np.concatenate([xy, wh, ang], -1).astype(np.float32)


def _grid(n=16, stride=8.0):
    g = (np.stack(np.meshgrid(np.arange(n), np.arange(n)), -1).reshape(-1, 2) + 0.5) * stride
    return g.astype(np.float32)


# -- geometry and assignment ----------------------------------------------------------

def test_rotated_candidates_are_bit_equal():
    r = np.random.default_rng(0)
    anc = _grid()
    gt = _rboxes(r, (3, 7))
    gt[0, 0] = [64, 64, 40, 20, 0.0]        # axis-aligned: anchors on its edges
    gt[1, 1] = [64, 64, 32, 32, np.pi / 4]  # corners on the grid's diagonals
    got = select_candidates_in_rotated_gts(torch.from_numpy(anc), torch.from_numpy(gt)).numpy()
    want = np.asarray(jax_select_candidates(jnp.asarray(anc), jnp.asarray(gt)))
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 50 and not got.all()


def test_rotated_assigner_matches_jax_with_padded_rows_and_ties():
    r = np.random.default_rng(2)
    b, n, nc = 2, 6, 3
    anc = _grid()
    a = len(anc)
    pd_scores = r.random((b, a, nc)).astype(np.float32)
    pd_bboxes = np.concatenate([anc, np.full((a, 2), 14.0, np.float32),
                                np.full((a, 1), 0.3, np.float32)], -1)[None].repeat(b, 0)
    pd_scores[:, 40:90] = 0.5             # tied scores over identical boxes: tied metrics
    gt = _rboxes(r, (b, n))
    gt[:, 0] = [50, 40, 70, 40, 0.3]      # a large box covering the tied anchors
    labels = r.integers(0, nc, (b, n, 1)).astype(np.float32)
    mask = np.ones((b, n, 1), np.float32)
    mask[0, 4:] = 0                       # padded rows
    mask[1, 5:] = 0
    gt[mask[..., 0] == 0] = 0
    args = (pd_scores, pd_bboxes, anc, labels, gt, mask)
    want = JaxRTAL(topk=10, num_classes=nc, alpha=0.5, beta=6.0)(*(jnp.asarray(v) for v in args))
    got = RotatedTaskAlignedAssigner(topk=10, num_classes=nc)(*(torch.from_numpy(v) for v in args))
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(want.fg_mask))
    assert got.fg_mask.sum() > 10
    np.testing.assert_array_equal(got.target_gt_idx.numpy(), np.asarray(want.target_gt_idx))
    np.testing.assert_array_equal(got.target_labels.numpy(), np.asarray(want.target_labels))
    np.testing.assert_allclose(got.target_bboxes.numpy(), np.asarray(want.target_bboxes),
                               atol=1e-6)
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(want.target_scores),
                               atol=1e-5)


def test_probiou_gradient_at_its_clamps_matches_jax():
    """Pairs where probiou's clamps act: identical boxes (the distance
    clamped at eps), boxes far apart (clamped at 100), a near-degenerate
    box (its determinant near 0), beside ordinary pairs. The value and the
    gradient of both arguments are held."""
    r = np.random.default_rng(5)
    b1, b2 = _rboxes(r, (6,)), _rboxes(r, (6,))
    b2[0] = b1[0]                                  # identical
    b2[1, :2] = b1[1, :2] + 900.0                  # far apart
    b1[2, 3] = 1e-3                                # a sliver
    t1, t2 = torch.from_numpy(b1).requires_grad_(), torch.from_numpy(b2).requires_grad_()
    v = probiou(t1, t2)
    v.sum().backward()
    jv, (g1, g2) = jax.value_and_grad(lambda x, y: jnp.sum(jax_probiou(x, y)), (0, 1))(
        jnp.asarray(b1), jnp.asarray(b2))
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jax_probiou(jnp.asarray(b1),
                                                                            jnp.asarray(b2))),
                               atol=1e-6)
    for got, want in ((t1.grad, g1), (t2.grad, g2)):
        assert np.isfinite(got.numpy()).all()
        assert _rel_err(got.numpy(), want) <= 1e-5


def _loss_inputs(seed=3, b=2, nc=NC, n=5):
    r = np.random.default_rng(seed)
    no = 64 + nc
    feats = [r.normal(0, 1, (b, s, s, no)).astype(np.float32) for s in (16, 8, 4)]
    angle = r.uniform(-np.pi / 4, 3 * np.pi / 4, (b, 336, 1)).astype(np.float32)
    gt = _rboxes(r, (b, n))
    labels = r.integers(0, nc, (b, n, 1)).astype(np.float32)
    mask = np.ones((b, n, 1), np.float32)
    mask[1, 3:] = 0
    gt[mask[..., 0] == 0] = 0
    return feats, angle, labels, gt, mask


def test_obb_loss_and_gradient_match_jax():
    feats, angle, labels, gt, mask = _loss_inputs()
    jl = JaxOBBLoss(nc=NC, strides=STRIDES)

    @jax.jit
    def jax_loss(fs, ang):
        out = jl((fs, ang), jnp.asarray(labels), jnp.asarray(gt), jnp.asarray(mask))
        return out.total, out.components

    (jtotal, jcomps), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(f) for f in feats], jnp.asarray(angle))
    tf = [torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_() for f in feats]
    ta = torch.from_numpy(angle).requires_grad_()
    out = OBBLoss(nc=NC, strides=STRIDES)((tf, ta),
                                          *(torch.from_numpy(v) for v in (labels, gt, mask)))
    out.total.backward()
    assert not out.components.requires_grad
    assert abs(out.total.item() - float(jtotal)) <= 1e-5 * abs(float(jtotal))
    np.testing.assert_allclose(out.components.numpy(), np.asarray(jcomps), rtol=1e-5)
    assert (np.asarray(jcomps) > 0).all()
    for got, want in [*zip((t.grad.permute(0, 2, 3, 1) for t in tf), jgrads[0]),
                      (ta.grad, jgrads[1])]:
        want = np.asarray(want, np.float64)
        err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert err <= 1e-4, err


# -- data ----------------------------------------------------------------------------

HYP = {"hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "fliplr": 0.5, "mosaic": 1.0}


@pytest.fixture(scope="module")
def dota(tmp_path_factory):
    """4 train and 2 val DOTA tiles of 96 px: the 128 px datasets scale them up."""
    root = tmp_path_factory.mktemp("obbtrain") / "dota"
    return make_dota_dataset(root, n_val=2, n_train=4, imgsz=96, seed=4, max_objects=6)


def test_augmented_obb_sample_matches_jax(dota):
    path = f"{dota['path']}/train/images"
    kw = dict(imgsz=IMGSZ, augment=True, hyp=HYP, nc=NC, max_boxes=MAX_BOXES, task="obb")
    port, ref = YOLODataset(path, **kw), JaxYOLODataset(path, **kw)
    unflipped = YOLODataset(path, **{**kw, "hyp": {**HYP, "fliplr": 0.0}})
    flips = set()
    for i in range(4):
        for seed in range(3):
            got = port.get_sample(i, np.random.default_rng(seed))
            want = ref.get_sample(i, np.random.default_rng(seed))
            same = unflipped.get_sample(i, np.random.default_rng(seed))["img"]
            flips.add(not np.array_equal(got["img"], same))
            np.testing.assert_array_equal(got["img"], want["img"])
            assert got["bboxes"].shape == want["bboxes"].shape and got["bboxes"].shape[1] == 5
            np.testing.assert_allclose(got["bboxes"], want["bboxes"], atol=1e-4)
            np.testing.assert_array_equal(got["cls"], want["cls"])
            np.testing.assert_allclose(np.asarray(got["ratio_pad"][0]),
                                       np.asarray(want["ratio_pad"][0]), rtol=1e-6)
    assert flips == {True, False}  # both branches of the flip ran
    assert got["img"].shape == (IMGSZ, IMGSZ, 3)


@pytest.mark.parametrize("cache", ["ram", "disk"])
def test_obb_collate_and_cache_carry_the_rotated_boxes(dota, cache):
    path = f"{dota['path']}/train/images"
    kw = dict(imgsz=IMGSZ, augment=True, hyp=HYP, nc=NC, max_boxes=MAX_BOXES, task="obb")
    plain, cached = YOLODataset(path, **kw), YOLODataset(path, cache_images=cache, **kw)
    assert all("corners" in lb for lb in cached.labels)
    for _ in range(2):  # the second pass reads the cache
        got = next(iter(DataLoader(cached, batch_size=4, shuffle=False, seed=1)))
    want = next(iter(DataLoader(plain, batch_size=4, shuffle=False, seed=1)))
    assert got["bboxes"].shape == (4, MAX_BOXES, 5)
    for k in ("img", "bboxes", "cls", "mask"):
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["bboxes"][..., 2:4][got["mask"][..., 0] > 0] > 0).all()


# -- the train step and the val loss ------------------------------------------------

def _batch(seed=0):
    r = np.random.default_rng(seed)
    img = r.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    bboxes = _rboxes(r, (BATCH, MAX_BOXES))
    cls = r.integers(0, NC, (BATCH, MAX_BOXES, 1)).astype(np.float32)
    mask = np.zeros((BATCH, MAX_BOXES, 1), np.float32)
    mask[0, :5] = 1
    mask[1, :3] = 1
    return {"img": img, "cls": cls, "bboxes": bboxes * mask, "mask": mask}


def _port_like(variables: dict) -> DetectionModel:
    m = DetectionModel(CFG, nc=NC)
    load_jax_variables(m, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    return m


def _recording(tx):
    """``tx`` that also keeps the gradients it was given in its state, so one
    compiled JAX step yields both the step and its gradients."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def steps(few_threads):
    """One SGD step of yolo11n-obb (no warmup, so every group moves) on both
    sides, and the port's step again in fp64 for the gradient rule, at the
    process's own thread count."""
    torch.set_num_threads(few_threads)
    try:
        return _steps()
    finally:
        torch.set_num_threads(min(few_threads, 2))


def _steps():
    jm, shapes = jax_shapes(CFG, IMGSZ)
    variables = randomize(shapes, seed=13)
    batch = _batch()
    jloss = JaxOBBLoss(nc=NC, strides=STRIDES)
    tx, _, _ = jax_build_optimizer(variables["params"], **OPT)
    tx = _recording(tx)
    state = TrainState.create(jax.tree.map(jnp.asarray, variables), tx)
    jstate, jmetrics = jax.jit(make_train_step(jm.graph, jloss, tx))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    jgrads = jstate.opt_state[1]

    port = _port_like(variables)
    port64 = copy.deepcopy(port).double().train()
    out64 = OBBLoss(nc=NC, strides=STRIDES)(
        port64(images_to_tensor(batch["img"], "cpu").double()),
        *(torch.from_numpy(batch[k]).double() for k in ("cls", "bboxes", "mask")))
    out64.total.backward()
    grads64 = {n: p.grad.detach().clone() for n, p in port64.named_parameters()
               if p.grad is not None}
    opt, _, _ = build_optimizer(port.named_parameters(), **OPT)
    ema = ModelEMA(port)
    grads = {}
    for name, p in port.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda t, name=name: grads.__setitem__(name, t.grad.detach().clone()))
    metrics = TrainStep(port, OBBLoss(nc=NC, strides=STRIDES), opt, ema)(batch)
    metrics["fp64"] = out64
    return {"jax": (jm, variables, jgrads, jstate, jmetrics),
            "port": (port, (grads, grads64), ema, metrics)}


def test_obb_train_step_loss_matches_jax(steps):
    """The loss and its components within 1e-5 relative, both fp32 sides
    held against the same step's loss in fp64: with randomised weights the
    class loss sums ~10,000 BCE terms of large logits (670 here), and the
    two fp32 sums land on either side of the fp64 one, ~7e-6 and ~4e-6
    away (1.1e-5 from each other)."""
    jm = steps["jax"][-1]
    m = steps["port"][-1]
    exact = m["fp64"]
    for total, comps in ((m["loss"].item(), m["components"].numpy()),
                         (float(jm["loss"]), np.asarray(jm["components"]))):
        assert abs(total - exact.total.item()) <= 1e-5 * abs(exact.total.item())
        np.testing.assert_allclose(comps, exact.components.numpy(), rtol=1e-5)
    assert m["dcn_offset_max"].item() == 0.0  # no DCN in the OBB head


def test_obb_train_step_gradient_leaves_match_jax(steps):
    """Each leaf held at 1e-4 relative norm, with the same step in fp64 as
    the reference: the port's fp32 gradient within 1e-4 of it, or, where
    JAX's own fp32 gradient lies further off, within 4 times JAX's
    distance; and JAX's within 1e-4 of it or 4 times the port's distance
    (which checks the fp64 reference itself). The train slice holds the
    two fp32 gradients at 1e-4 of each other, with the fp64 rule for the
    leaves whose port rounding is above it; here the two fp32 sides lie up
    to 0.6e-4 from fp64 on opposite sides on many leaves (1.2e-4 from each
    other) and up to 2.6e-4 on some: with randomised weights the class
    loss sums ~10,000 BCE terms."""
    _, variables, jgrads, _, _ = steps["jax"]
    _, (grads, grads64), _, _ = steps["port"]
    ref = dict(_port_like({"params": jax.tree.map(np.asarray, jgrads),
                           "batch_stats": variables["batch_stats"]}).named_parameters())
    assert set(grads) == set(grads64) == set(ref) and len(grads) > 250
    bad, within = [], 0
    for name, want in ref.items():
        want = want.detach().double()
        got, exact = grads[name].double(), grads64[name]
        lim = 1e-4 * exact.norm()
        port_off, jax_off = (got - exact).norm(), (want - exact).norm()
        within += bool(port_off <= lim)
        if port_off > max(lim, 4 * jax_off) or jax_off > max(lim, 4 * port_off):
            bad.append(f"{name}: |port - fp64| {port_off:.2e}, |jax - fp64| {jax_off:.2e}, "
                       f"limit {lim:.2e}")
    assert not bad, bad
    assert within > len(ref) // 2, within


def test_obb_train_step_params_bn_stats_and_ema_match_jax(steps):
    jstate = steps["jax"][3]
    port, _, ema, _ = steps["port"]
    for got_model, (p, s) in ((port, (jstate.params, jstate.batch_stats)),
                              (ema.ema, (jstate.ema_params, jstate.ema_batch_stats))):
        want = _port_like(jax.tree.map(np.asarray, {"params": p, "batch_stats": s})).state_dict()
        got = got_model.state_dict()
        bad = [k for k, v in want.items() if v.dtype.is_floating_point
               and _rel_err(got[k].detach().numpy(), v.numpy()) > 1e-5]
        assert not bad, bad[:10]
    assert ema.updates == 1 and int(jstate.ema_updates) == 1


def test_obb_val_loss_matches_jax(steps, dota):
    """Both validators over the val tiles with OBBLoss as their loss, on the
    randomised weights before the step."""
    jm, variables, _, _, _ = steps["jax"]
    jm.variables = jax.tree.map(jnp.asarray, variables)
    port = _port_like(variables).eval()
    port.probe_strides(IMGSZ)
    args = {"imgsz": IMGSZ, "batch": 2, "conf": 0.001, "iou": 0.7, "max_det": 300,
            "max_boxes": MAX_BOXES, "task": "obb", "data": dota}
    got = DetectionValidator(dict(args))(model=port, loss_fn=OBBLoss(nc=NC, strides=STRIDES))
    want = JaxValidator(dict(args))(model=jm, loss_fn=JaxOBBLoss(nc=NC, strides=STRIDES))
    for k in ("val/box_loss", "val/cls_loss", "val/dfl_loss"):
        assert want[k] > 0 and abs(got[k] - want[k]) <= 1e-4 * want[k], (k, got[k], want[k])


# -- the facade ------------------------------------------------------------------------

TINY_OBB = """nc: 15
backbone:
  - [-1, 1, Conv, [16, 3, 2]]
  - [-1, 1, Conv, [32, 3, 2]]
  - [-1, 1, Conv, [64, 3, 2]]
  - [-1, 1, Conv, [64, 3, 2]]
  - [-1, 1, Conv, [64, 3, 2]]
head:
  - [[2, 3, 4], 1, OBB, [nc, 1]]
"""


def test_yolo_trains_obb_and_its_checkpoint_reloads_as_obb(dota, tmp_path):
    cfg = tmp_path / "tiny-obb.yaml"
    cfg.write_text(TINY_OBB)
    model = YOLO(str(cfg), task="obb", device="cpu", imgsz=64)
    res = model.train(data=dota, epochs=2, batch=2, imgsz=64, project=str(tmp_path / "runs"),
                      workers=2, optimizer="SGD", warmup_epochs=0.0)
    save = tmp_path / "runs" / "train"
    rows = (save / "results.csv").read_text().splitlines()
    assert len(rows) == 3 and "metrics/mAP50(B)" in res
    for row in rows[1:]:  # train and val losses of both epochs are finite and > 0
        vals = [float(v) for v in row.split(",")]
        assert all(np.isfinite(vals)) and min(vals[2:5] + vals[9:12]) > 0
    assert (save / "train_batch0.jpg").exists()  # 5-column boxes do not stop the plot
    assert cv2.imread(str(save / "train_batch0.jpg")) is not None
    assert model.task == model.model.task == "obb"
    again = YOLO(str(save / "weights" / "best"), device="cpu", imgsz=64)
    assert again.task == "obb" and again.model.nc == 15
    resumed = YOLO(str(cfg), task="obb", device="cpu", imgsz=64).train(
        data=dota, epochs=3, batch=2, imgsz=64, project=str(tmp_path / "runs"), workers=2,
        optimizer="SGD", warmup_epochs=0.0, resume=str(save / "weights" / "last"))
    assert len((tmp_path / "runs" / "train2" / "results.csv").read_text().splitlines()) == 2
    assert np.isfinite(resumed["fitness"])
