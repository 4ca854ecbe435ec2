"""The pose task of the PyTorch port against the JAX package, fp32 on the
CPU, with numpy-randomised weights carried over by the strict loader.

Tolerances: the heads' eval outputs (boxes, scores, decoded keypoints) 1e-4
of max |JAX| (the tiny yaml's and yolo11n-pose's at 64); the samples, the
collated keypoints and multi_scale's resize bit-equal (the same cv2 and
numpy calls, drawn from the same generators); PoseLoss's total and
components 1e-5 relative and its gradients 1e-4 relative norm, also past
``max_fg``; one train step of the tiny model: loss 1e-4 relative, each
gradient leaf 1e-3 relative norm; OKS 1e-12; the validator's (P) and (B)
metrics 1e-3; predicted boxes and keypoints 1e-3 px. Every case asserts
that it saw detections, keypoints or foreground anchors.
"""

import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_obb_train import _recording
from test_torch_weights import jax_shapes, randomize
from yolo_ad_refine_tpu.data.build import collate as jax_collate
from yolo_ad_refine_tpu.data.dataset import YOLODataset as JaxYOLODataset
from yolo_ad_refine_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from yolo_ad_refine_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_ad_refine_tpu.models.model import build_detection_model as jax_build
from yolo_ad_refine_tpu.train.optim import build_optimizer as jax_build_optimizer
from yolo_ad_refine_tpu.train.pose import PoseLoss as JaxPoseLoss
from yolo_ad_refine_tpu.train.step import TrainState, make_train_step
from yolo_ad_refine_tpu.train.trainer import multi_scale_batch as jax_multi_scale
from yolo_ad_refine_tpu.utils.metrics_np import kpt_iou_np as jax_kpt_iou
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.data.build import collate
from yolo_ad_refine_tpu_torch.data.dataset import YOLODataset, check_det_dataset
from yolo_ad_refine_tpu_torch.data.synthetic import make_pose_dataset
from yolo_ad_refine_tpu_torch.engine.predictor import DetectionPredictor
from yolo_ad_refine_tpu_torch.engine.validator import DetectionValidator
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.train.optim import ModelEMA, build_optimizer
from yolo_ad_refine_tpu_torch.train.pose import OKS_SIGMA, PoseLoss
from yolo_ad_refine_tpu_torch.train.step import TrainStep
from yolo_ad_refine_tpu_torch.train.trainer import multi_scale_batch
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables
from yolo_ad_refine_tpu_torch.utils.metrics import kpt_iou_np

from test_torch_segment import localise, pair_rows

KPT_SHAPE = (17, 3)
TINY_POSE = {  # tests/test_predict_tasks.py's tiny backbone with a 17-keypoint Pose head
    "nc": 1,
    "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [128, 3, 2]],
                 [-1, 1, "Conv", [256, 3, 2]]],
    "head": [[[2, 3, 4], 1, "Pose", ["nc", list(KPT_SHAPE)]]],
}
IMGSZ, STRIDES, NK = 64, (8, 16, 32), 51
OPT = dict(optimizer="SGD", lr0=0.01, lrf=0.01, momentum=0.937, weight_decay=0.0005, epochs=1,
           nb=1, batch=2, nbs=2, warmup_epochs=0.0, warmup_momentum=0.8, warmup_bias_lr=0.1,
           cos_lr=False, nc=1)
HYP = {"hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "fliplr": 0.5}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _port(cfg, variables):
    m = DetectionModel(cfg)
    load_jax_variables(m, flatten_tree(variables["params"]), flatten_tree(variables["batch_stats"]))
    assert m.task == "pose"
    m.strides = STRIDES
    return m.eval()


@pytest.fixture(scope="module")
def tiny():
    jm = jax_build(TINY_POSE, imgsz=IMGSZ)
    variables = localise(randomize(jm.variables, seed=9), kpt_scale=0.01)
    jm.variables = jax.tree.map(jnp.asarray, variables)
    return jm, variables, _port(TINY_POSE, variables)


def _eval_both(jm, port, x):
    want, (_, wk) = jax.jit(lambda v, a: jm.apply(v, a, train=False))(jm.variables,
                                                                     jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y, (_, kpt) = port(xt)
    return (y.numpy(), kpt.numpy()), (np.asarray(want), np.asarray(wk))


def test_tiny_pose_eval_matches_jax(tiny):
    jm, _, port = tiny
    x = np.random.default_rng(0).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    got, want = _eval_both(jm, port, x)
    assert got[0].shape == want[0].shape == (2, 84, 4 + 1 + NK)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4
    vis = got[0][..., 5:].reshape(2, 84, 17, 3)[..., 2]
    assert ((vis > 0) & (vis < 1)).all()  # the visibility is sigmoided


def test_yolo11n_pose_loads_strictly_and_matches_jax():
    jm, shapes = jax_shapes("yolo11n-pose.yaml", IMGSZ)
    variables = randomize(shapes, seed=8)
    jm.variables = jax.tree.map(jnp.asarray, variables)
    port = _port("yolo11n-pose.yaml", variables)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert port.num_params() == n_jax == 2_874_446
    assert port.nc == 1 and port.model[port.head_idx].kpt_shape == KPT_SHAPE
    x = np.random.default_rng(1).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    got, want = _eval_both(jm, port, x)
    assert got[0].shape == (2, 84, 56)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4


@pytest.fixture(scope="module")
def poseset(tmp_path_factory):
    root = tmp_path_factory.mktemp("poseset")
    return check_det_dataset(make_pose_dataset(root, n_val=4, n_train=6, imgsz=96, seed=1,
                                               max_objects=4))


@pytest.mark.parametrize("train,flip_idx", [(True, True), (True, False), (False, False)])
def test_pose_samples_and_collate_are_bit_equal(poseset, train, flip_idx):
    """Train with and without flip_idx (without it no flip), and val; the
    keypoint layout inferred from the label width on both sides."""
    kw = dict(imgsz=IMGSZ, augment=train, hyp=HYP if train else None, nc=1, max_boxes=8,
              task="pose", flip_idx=poseset["flip_idx"] if flip_idx else None)
    path = poseset["train" if train else "val"]
    ours, ref = YOLODataset(path, **kw), JaxYOLODataset(path, cache=False, **kw)
    assert ours.kpt_shape == ref.kpt_shape == KPT_SHAPE
    samples = []
    for i in range(len(ours)):
        got = ours.get_sample(i, np.random.default_rng(20 + i))
        want = ref.get_sample(i, np.random.default_rng(20 + i))
        for k in ("img", "bboxes", "cls", "keypoints"):
            np.testing.assert_array_equal(got[k], want[k])
        assert got["ratio_pad"] == want["ratio_pad"]
        samples.append((got, want))
    kp = np.concatenate([g["keypoints"] for g, _ in samples])
    assert len(kp) >= 4 and (kp[..., 2] == 0).any() and (kp[..., 2] > 0).any()
    assert (kp[kp[..., 2] == 0][:, :2] == 0).all()  # invisible keypoints are zeroed
    b, jb = collate([g for g, _ in samples], 8), jax_collate([w for _, w in samples], 8)
    assert b["keypoints"].shape == (len(samples), 8, 17, 3)
    for k in ("img", "cls", "bboxes", "mask", "keypoints"):
        np.testing.assert_array_equal(b[k], jb[k])


def test_multi_scale_resizes_keypoints_and_index_masks_as_jax():
    r = np.random.default_rng(3)
    batch = {"img": r.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8),
             "bboxes": r.uniform(0, 128, (2, 4, 4)).astype(np.float32),
             "keypoints": r.uniform(0, 128, (2, 4, 17, 3)).astype(np.float32),
             "masks": r.integers(0, 5, (2, 32, 32)).astype(np.int32)}
    for seed in range(4):
        got = multi_scale_batch(batch, 128, np.random.default_rng(seed))
        want = jax_multi_scale(batch, 128, np.random.default_rng(seed))
        for k in batch:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert got["masks"].shape[1] == got["img"].shape[1] // 4 != 32


def pose_step_batch(seed=0, b=2, n=6):
    """A seeded pose batch at IMGSZ: boxes with 17 keypoints inside them,
    a few invisible (zeroed)."""
    r = np.random.default_rng(seed)
    xy = r.uniform(2, 36, (b, n, 2))
    boxes = np.concatenate([xy, xy + r.uniform(10, 26, (b, n, 2))], -1)
    mask = (np.arange(n)[None, :, None] < np.array([[[5]], [[3]]])).astype(np.float32)
    t = r.uniform(0, 1, (b, n, 17, 2))
    kxy = boxes[..., None, :2] + t * (boxes[..., None, 2:] - boxes[..., None, :2])
    vis = (r.random((b, n, 17, 1)) > 0.2) * 2.0
    kpts = np.concatenate([kxy * (vis > 0), vis], -1) * mask[..., None]
    return {"img": r.integers(0, 256, (b, IMGSZ, IMGSZ, 3), dtype=np.uint8),
            "cls": np.zeros((b, n, 1), np.float32), "bboxes": (boxes * mask).astype(np.float32),
            "mask": mask, "keypoints": kpts.astype(np.float32)}


@pytest.mark.parametrize("max_fg", [64, 5])
def test_pose_loss_and_gradients_match_jax(max_fg):
    """max_fg 64 keeps every foreground anchor; at 5 each image has more
    (held below), so which are kept is decided by the tie order."""
    r = np.random.default_rng(1)
    feats = [r.normal(0, 1, (2, s, s, 65)).astype(np.float32) for s in (8, 4, 2)]
    kpt = r.normal(0, 1, (2, 84, NK)).astype(np.float32)
    batch = pose_step_batch(1)
    targets = [batch[k] for k in ("cls", "bboxes", "mask", "keypoints")]
    jl = JaxPoseLoss(nc=1, strides=STRIDES, kpt_shape=KPT_SHAPE, max_fg=max_fg)

    @jax.jit
    def jax_loss(fs, k):
        out = jl((fs, k), *(jnp.asarray(t) for t in targets))
        return out.total, out.components

    (jtotal, jcomps), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(f) for f in feats], jnp.asarray(kpt))
    loss = PoseLoss(nc=1, strides=STRIDES, kpt_shape=KPT_SHAPE, max_fg=max_fg)
    tf = [torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_() for f in feats]
    tk = torch.from_numpy(kpt).requires_grad_()
    parts = loss.det.components(tf, *(torch.from_numpy(t) for t in targets[:3]))[1]
    assert (parts.assign.fg_mask.sum(1) > 5).all()
    out = loss((tf, tk), *(torch.from_numpy(t) for t in targets))
    out.total.backward()
    assert out.components.shape == (5,) and not out.components.requires_grad
    assert abs(out.total.item() - float(jtotal)) <= 1e-5 * abs(float(jtotal))
    np.testing.assert_allclose(out.components.numpy(), np.asarray(jcomps), rtol=1e-5)
    assert (np.asarray(jcomps) > 0).all()
    for g, w in zip([*(t.grad.permute(0, 2, 3, 1) for t in tf), tk.grad],
                    [*jgrads[0], jgrads[1]]):
        w = np.asarray(w, np.float64)
        assert np.linalg.norm(g.numpy() - w) / np.linalg.norm(w) <= 1e-4


def test_pose_train_step_matches_jax(tiny):
    jm, variables, _ = tiny
    batch = pose_step_batch(3)
    tx, _, _ = jax_build_optimizer(variables["params"], **OPT)
    tx = _recording(tx)
    state = TrainState.create(jax.tree.map(jnp.asarray, variables), tx)
    jstate, jmetrics = jax.jit(make_train_step(
        jm.graph, JaxPoseLoss(nc=1, strides=STRIDES, kpt_shape=KPT_SHAPE), tx,
        extra_loss_keys=("keypoints",)))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    port = _port(TINY_POSE, variables)
    opt, _, _ = build_optimizer(port.named_parameters(), **OPT)
    grads = {}
    for name, p in port.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda t, name=name: grads.__setitem__(name, t.grad.detach().clone()))
    m = TrainStep(port, PoseLoss(nc=1, strides=STRIDES, kpt_shape=KPT_SHAPE), opt,
                  ModelEMA(port))(batch)
    assert abs(m["loss"].item() - float(jmetrics["loss"])) <= 1e-4 * abs(float(jmetrics["loss"]))
    np.testing.assert_allclose(m["components"].numpy(), np.asarray(jmetrics["components"]),
                               rtol=1e-4)
    assert m["components"][1].item() > 0 and m["dfl_loss"] == m["components"][4]
    ref = dict(_port(TINY_POSE, {"params": jax.tree.map(np.asarray, jstate.opt_state[1]),
                                 "batch_stats": variables["batch_stats"]}).named_parameters())
    assert set(grads) == set(ref)
    bad = [n for n, g in grads.items()
           if (g - ref[n]).norm() > 1e-3 * ref[n].norm().clamp(min=1e-30)]
    assert not bad, bad


def test_kpt_iou_matches_jax():
    r = np.random.default_rng(2)
    gt = np.concatenate([r.uniform(0, 64, (3, 17, 2)), r.integers(0, 3, (3, 17, 1))], -1)
    pred = gt[[0, 2, 1, 1]][..., :2] + r.normal(0, 2, (4, 17, 2))
    area = r.uniform(50, 900, 3)
    got = kpt_iou_np(gt, pred, area, OKS_SIGMA)
    np.testing.assert_allclose(got, jax_kpt_iou(gt, pred, area, OKS_SIGMA), rtol=0, atol=1e-12)
    assert got.max() > 0.3


@pytest.fixture(scope="module")
def labelled_val(tiny, tmp_path_factory):
    """Val images labelled with the port's own 3 best boxes and keypoints
    (all visible): random labels would give mAP 0 on both sides."""
    _, _, port = tiny
    root = tmp_path_factory.mktemp("poseval")
    data = make_pose_dataset(root, n_val=4, imgsz=IMGSZ, seed=2)
    files = sorted((root / "val" / "images").glob("*.jpg"))
    results = DetectionPredictor({"imgsz": IMGSZ, "conf": 0.001, "batch": 4})(
        source=[cv2.imread(str(f)) for f in files], model=port)
    n = 0
    for f, r in zip(files, results):
        rows = []
        for box, kp in zip(r.boxes.xywhn[:3], r.keypoints.xyn[:3]):
            kv = np.concatenate([kp.clip(0, 1), np.full((17, 1), 2.0)], -1)
            rows.append("0 " + " ".join(f"{v:.6f}" for v in (*box.clip(0, 1), *kv.reshape(-1))))
        n += len(rows)
        (root / "val" / "labels" / f"{f.stem}.txt").write_text("\n".join(rows) + "\n")
    assert n >= 4
    return data


def test_pose_val_metrics_match_jax(tiny, labelled_val):
    jm, _, port = tiny
    args = {"data": labelled_val, "imgsz": IMGSZ, "batch": 2, "conf": 0.001, "iou": 0.7,
            "max_det": 300, "task": "pose", "max_boxes": 8}
    got = DetectionValidator(args)(model=port)
    want = JaxValidator(args)(model=jm)
    assert want["metrics/mAP50(P)"] > 0.05 and want["metrics/mAP50(B)"] > 0.05
    for k in ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
              "metrics/mAP50-95(B)", "metrics/mAP50(P)", "metrics/mAP50-95(P)", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


def test_pose_predict_keypoints_and_rows_match_jax(tiny, tmp_path):
    jm, _, port = tiny
    r = np.random.default_rng(6)
    imgs = [r.integers(0, 256, s, dtype=np.uint8) for s in ((80, 100, 3), (64, 48, 3))]
    kw = {"imgsz": IMGSZ, "conf": 0.05, "batch": 2}
    got = DetectionPredictor(kw)(source=imgs, model=port)
    want = JaxPredictor(kw)(source=imgs, model=jm)
    assert sum(len(g) for g in got) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w) == len(g.keypoints)
        order = pair_rows(g.boxes.data, w.boxes.data)
        np.testing.assert_allclose(g.keypoints.data, w.keypoints.data[order], rtol=0, atol=1e-3)
        assert g.plot().shape == g.orig_img.shape
    g = next(g for g in got if len(g))
    first = g.save_txt(tmp_path / "pose.txt", save_conf=True).read_text().splitlines()[0].split()
    assert len(first) == 1 + 4 + 17 * 3 + 1  # cls, xywhn, the keypoints, conf
    entry = json.loads(g.tojson())[0]
    assert len(entry["keypoints"]["x"]) == len(entry["keypoints"]["visible"]) == 17


def test_pose_model_trains_and_reloads_as_pose(poseset, tmp_path):
    import yaml

    (tmp_path / "tiny-pose.yaml").write_text(yaml.safe_dump(TINY_POSE))
    model = YOLO(str(tmp_path / "tiny-pose.yaml"), task="pose", device="cpu", imgsz=IMGSZ)
    res = model.train(data=poseset, epochs=1, batch=2, imgsz=IMGSZ, plots=False, workers=2,
                      project=str(tmp_path / "runs"), warmup_epochs=0.0, multi_scale=True)
    assert "metrics/mAP50(P)" in res and np.isfinite(res["metrics/mAP50(P)"])
    assert YOLO(res["save_dir"] + "/weights/best", device="cpu").task == "pose"
