"""The segment task of the PyTorch port against the JAX package, fp32 on the
CPU, with numpy-randomised weights carried over by the strict loader.

Tolerances: the heads' eval outputs and prototypes 1e-4 of max |JAX| (the
tiny yaml's and yolo11n-seg's at 64: ~100 fp32 layers summed in other
orders); crop_mask, process_mask and mask_iou_matrix 1e-5; the index
masks, the collated masks and the samples bit-equal (the same cv2 and
numpy calls, drawn from the same generators); SegmentationLoss's total
and components 1e-5 relative and its gradients 1e-4 relative norm (sums
over every anchor in another order), also past ``max_fg``; one train step
of the tiny model: loss 1e-4 relative, each gradient leaf 1e-3 relative
norm; the validator's (M) and (B) metrics 1e-3; predicted boxes 1e-3 px
and masks within 0.2 % flipped pixels (a mask pixel flips where the two
sides' fp32 values straddle 0.5); two ranks' loss against one process's
(fp64) 1e-9 relative. Every case asserts that it saw detections or
foreground anchors.
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
from torch_parallel_worker import run_ranks
from yolo_ad_refine_tpu.data.build import collate as jax_collate
from yolo_ad_refine_tpu.data.dataset import YOLODataset as JaxYOLODataset
from yolo_ad_refine_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from yolo_ad_refine_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_ad_refine_tpu.models.model import build_detection_model as jax_build
from yolo_ad_refine_tpu.ops import masks as jax_masks
from yolo_ad_refine_tpu.train.optim import build_optimizer as jax_build_optimizer
from yolo_ad_refine_tpu.train.segment import SegmentationLoss as JaxSegLoss
from yolo_ad_refine_tpu.train.segment import polygons_to_index_mask as jax_index_mask
from yolo_ad_refine_tpu.train.step import TrainState, make_train_step
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.cfg.cli import entrypoint
from yolo_ad_refine_tpu_torch.data.build import collate
from yolo_ad_refine_tpu_torch.data.dataset import YOLODataset, check_det_dataset
from yolo_ad_refine_tpu_torch.data.synthetic import make_segment_dataset
from yolo_ad_refine_tpu_torch.engine.predictor import DetectionPredictor
from yolo_ad_refine_tpu_torch.engine.validator import DetectionValidator
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.ops import masks as port_masks
from yolo_ad_refine_tpu_torch.train.optim import ModelEMA, build_optimizer
from yolo_ad_refine_tpu_torch.train.segment import (
    SegmentationLoss, polygons_to_index_mask, top_foreground)
from yolo_ad_refine_tpu_torch.train.step import TrainStep, images_to_tensor
from yolo_ad_refine_tpu_torch.utils import ROOT
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

TINY_SEG = {  # tests/test_segment.py's tiny yaml
    "nc": 2,
    "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [128, 3, 2]],
                 [-1, 1, "Conv", [256, 3, 2]]],
    "head": [[[2, 3, 4], 1, "Segment", ["nc", 8, 32]]],
}
IMGSZ, NC, NM, STRIDES = 64, 2, 8, (8, 16, 32)
OPT = dict(optimizer="SGD", lr0=0.01, lrf=0.01, momentum=0.937, weight_decay=0.0005, epochs=1,
           nb=1, batch=2, nbs=2, warmup_epochs=0.0, warmup_momentum=0.8, warmup_bias_lr=0.1,
           cos_lr=False, nc=NC)
HYP = {"hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "fliplr": 0.5, "mosaic": 1.0,
       "copy_paste": 1.0, "degrees": 10.0, "translate": 0.1, "scale": 0.5, "shear": 2.0,
       "perspective": 0.0005}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _nhwc_to_port(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _port(cfg, variables, task="segment"):
    m = DetectionModel(cfg)
    load_jax_variables(m, flatten_tree(variables["params"]), flatten_tree(variables["batch_stats"]))
    assert m.task == task
    m.strides = STRIDES
    return m.eval()


def localise(variables, mask_bias: float = 0.0, kpt_scale: float = 1.0):
    """Randomised weights give every anchor a box over the whole image (its
    DFL logits saturate) and, in the segment head, masks that are empty:
    both sides' validators would then match nothing. Scale the box
    branch's last kernel by 0.1 with biases that favour the short bins, so
    the boxes are local and differ, and add ``mask_bias`` to the mask
    coefficients' biases; ``kpt_scale`` scales the pose branch's last
    kernel, whose random outputs put keypoints hundreds of pixels off
    their anchors (a trained head's offsets are of the order of 1)."""
    head = variables["params"]["modules_5"]
    for i in range(3):
        box = head["detect"][f"cv2_{i}_2"]
        box["kernel"] = box["kernel"] * 0.1
        box["bias"] = np.tile(-0.5 * np.arange(16, dtype=np.float32), 4)
        head[f"cv4_{i}_2"]["bias"] = head[f"cv4_{i}_2"]["bias"] + mask_bias
        head[f"cv4_{i}_2"]["kernel"] = head[f"cv4_{i}_2"]["kernel"] * kpt_scale
    return variables


@pytest.fixture(scope="module")
def tiny():
    """(JAX model with randomised variables, port model with the same)."""
    jm = jax_build(TINY_SEG, imgsz=IMGSZ)
    variables = localise(randomize(jm.variables, seed=5), mask_bias=2.0)
    jm.variables = jax.tree.map(jnp.asarray, variables)
    return jm, variables, _port(TINY_SEG, variables)


def _eval_both(jm, port, x):
    want, (wf, wmc, wp) = jax.jit(lambda v, a: jm.apply(v, a, train=False))(jm.variables,
                                                                           jnp.asarray(x))
    with torch.no_grad():
        y, (feats, mc, proto) = port(_nhwc_to_port(x))
    return (y.numpy(), proto.permute(0, 2, 3, 1).numpy(), mc.numpy()), \
        (np.asarray(want), np.asarray(wp), np.asarray(wmc))


def test_yaml_copies_identical():
    for name in ("yolo11-seg.yaml", "yolo11-pose.yaml"):
        ours = (ROOT / "cfg" / "models" / name).read_bytes()
        assert ours == (ROOT.parent / "yolo_ad_refine_tpu" / "cfg" / "models" / name).read_bytes()


def test_tiny_segment_eval_and_proto_match_jax(tiny):
    jm, _, port = tiny
    x = np.random.default_rng(0).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    got, want = _eval_both(jm, port, x)
    assert got[0].shape == want[0].shape == (2, 84, 4 + NC + NM)
    assert got[1].shape == want[1].shape == (2, 16, 16, NM)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4


def test_yolo11n_seg_loads_strictly_and_matches_jax():
    """yolo11n-seg at 64 (nc 80, nm 32, proto 64 channels at width 0.25)
    through the strict loader; its Proto's ConvTranspose takes the loader's
    spatial flip: without it the prototypes move by far more than the
    limit."""
    jm, shapes = jax_shapes("yolo11n-seg.yaml", IMGSZ)
    variables = randomize(shapes, seed=7)
    jm.variables = jax.tree.map(jnp.asarray, variables)
    port = _port("yolo11n-seg.yaml", variables)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert port.num_params() == n_jax == 2_876_832
    head = port.model[port.head_idx]
    assert head.npr == 64 and head.nm == 32 and head.proto.upsample.weight.shape == (64, 64, 2, 2)
    x = np.random.default_rng(1).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    got, want = _eval_both(jm, port, x)
    assert got[0].shape == (2, 84, 116)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-4
    with torch.no_grad():
        head.proto.upsample.weight.copy_(head.proto.upsample.weight.flip(2, 3))
        unflipped = port(_nhwc_to_port(x))[1][2].permute(0, 2, 3, 1).numpy()
    assert _rel(unflipped, want[1]) > 1e-2


def _mask_inputs(seed=0, k=6):
    r = np.random.default_rng(seed)
    proto = r.normal(0, 2, (16, 16, NM)).astype(np.float32)
    coeffs = r.normal(0, 1, (k, NM)).astype(np.float32)
    xy = r.uniform(-4, 50, (k, 2))
    boxes = np.concatenate([xy, xy + r.uniform(3, 40, (k, 2))], -1).astype(np.float32)
    return proto, coeffs, boxes


@pytest.mark.parametrize("upsample", [True, False])
def test_crop_and_process_mask_match_jax(upsample):
    proto, coeffs, boxes = _mask_inputs()
    want = jax_masks.process_mask(jnp.asarray(proto), jnp.asarray(coeffs), jnp.asarray(boxes),
                                  (IMGSZ, IMGSZ), upsample=upsample)
    got = port_masks.process_mask(torch.from_numpy(proto).permute(2, 0, 1),
                                  torch.from_numpy(coeffs), torch.from_numpy(boxes),
                                  (IMGSZ, IMGSZ), upsample=upsample)
    assert got.shape == want.shape == ((6, IMGSZ, IMGSZ) if upsample else (6, 16, 16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert (got.numpy() > 0.5).sum() > (100 if upsample else 20)
    m = np.random.default_rng(1).random((6, 16, 16)).astype(np.float32)
    np.testing.assert_allclose(
        port_masks.crop_mask(torch.from_numpy(m), torch.from_numpy(boxes / 4)).numpy(),
        np.asarray(jax_masks.crop_mask(jnp.asarray(m), jnp.asarray(boxes / 4))), atol=1e-5)


def test_mask_iou_matrix_matches_jax():
    proto, coeffs, boxes = _mask_inputs(2)
    gt = np.zeros((16, 16), np.int32)
    gt[2:9, 3:12], gt[8:15, 6:14], gt[0:4, 0:4] = 1, 2, 3
    want = jax_masks.mask_iou_matrix(jnp.asarray(proto), jnp.asarray(coeffs),
                                     jnp.asarray(boxes), (IMGSZ, IMGSZ), jnp.asarray(gt), 5)
    got = port_masks.mask_iou_matrix(torch.from_numpy(proto).permute(2, 0, 1),
                                     torch.from_numpy(coeffs), torch.from_numpy(boxes),
                                     (IMGSZ, IMGSZ), torch.from_numpy(gt), 5)
    assert got.shape == (5, 6) and (got.numpy() > 0.05).sum() >= 3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_polygons_to_index_mask_is_equal_with_overlaps():
    r = np.random.default_rng(3)
    polys = [np.stack([c[0] + s * np.cos(a), c[1] + s * np.sin(a)], -1).astype(np.float32)
             for c, s, a in ((r.uniform(6, 26, 2), r.uniform(3, 12), np.linspace(0, 6.2, 9))
                             for _ in range(7))]
    got = polygons_to_index_mask(polys, (32, 32))
    want = jax_index_mask(polys, (32, 32))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) >= 4


@pytest.fixture(scope="module")
def segset(tmp_path_factory):
    root = tmp_path_factory.mktemp("segset")
    return check_det_dataset(make_segment_dataset(root, n_val=4, n_train=6, imgsz=96, seed=1,
                                                  max_objects=5))


@pytest.mark.parametrize("train", [True, False])
def test_segment_samples_and_collate_are_bit_equal(segset, train):
    kw = dict(imgsz=IMGSZ, augment=train, hyp=HYP if train else None, nc=3, max_boxes=16,
              task="segment")
    path = segset["train" if train else "val"]
    ours, ref = YOLODataset(path, **kw), JaxYOLODataset(path, cache=False, **kw)
    samples = []
    for i in range(len(ours)):
        got = ours.get_sample(i, np.random.default_rng(10 + i))
        want = ref.get_sample(i, np.random.default_rng(10 + i))
        np.testing.assert_array_equal(got["img"], want["img"])
        for k in ("bboxes", "cls"):
            np.testing.assert_array_equal(got[k], want[k])
        assert len(got["segments"]) == len(want["segments"])
        for a, b in zip(got["segments"], want["segments"]):
            np.testing.assert_array_equal(a, b)
        assert got["ratio_pad"] == want["ratio_pad"] and got["ori_shape"] == want["ori_shape"]
        samples.append((got, want))
    assert sum(len(g["segments"]) for g, _ in samples) >= 6
    b, jb = collate([g for g, _ in samples], 16), jax_collate([w for _, w in samples], 16)
    assert b["masks"].shape == (len(samples), IMGSZ // 4, IMGSZ // 4)
    for k in ("img", "cls", "bboxes", "mask", "masks"):
        np.testing.assert_array_equal(b[k], jb[k])
    assert b["masks"].max() >= 2


def _loss_inputs(seed=0, b=2, n=6):
    r = np.random.default_rng(seed)
    feats = [r.normal(0, 1, (b, s, s, 64 + NC)).astype(np.float32) for s in (8, 4, 2)]
    mc = r.normal(0, 1, (b, 84, NM)).astype(np.float32)
    proto = r.normal(0, 1, (b, 16, 16, NM)).astype(np.float32)
    xy = r.uniform(2, 40, (b, n, 2))
    gt = np.concatenate([xy, xy + r.uniform(8, 24, (b, n, 2))], -1).astype(np.float32)
    mask = (np.arange(n)[None, :, None] < np.array([[[5]], [[3]]])).astype(np.float32)
    labels = r.integers(0, NC, (b, n, 1)).astype(np.float32)
    idx = np.zeros((b, 16, 16), np.int32)
    for i in range(b):
        for j in range(int(mask[i, :, 0].sum())):
            x1, y1, x2, y2 = (gt[i, j] / 4).astype(int)
            idx[i, y1:y2, x1:x2] = j + 1
    return feats, mc, proto, labels, gt * mask, mask, idx


@pytest.mark.parametrize("max_fg", [128, 6])
def test_segmentation_loss_and_gradients_match_jax(max_fg):
    """max_fg 128 keeps every foreground anchor; at 6 each image has more
    (held below), so which are kept is decided by the tie order."""
    feats, mc, proto, labels, gt, mask, idx = _loss_inputs()
    jl = JaxSegLoss(nc=NC, strides=STRIDES, max_fg=max_fg)

    @jax.jit
    def jax_loss(fs, m, p):
        out = jl((fs, m, p), jnp.asarray(labels), jnp.asarray(gt), jnp.asarray(mask),
                 jnp.asarray(idx))
        return out.total, out.components

    (jtotal, jcomps), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        [jnp.asarray(f) for f in feats], jnp.asarray(mc), jnp.asarray(proto))
    loss = SegmentationLoss(nc=NC, strides=STRIDES, max_fg=max_fg)
    tf = [torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_() for f in feats]
    tm = torch.from_numpy(mc).requires_grad_()
    tp = torch.from_numpy(proto).permute(0, 3, 1, 2).requires_grad_()
    fg = loss.det.components(tf, *(torch.from_numpy(v) for v in (labels, gt, mask)))[1]
    fg_counts = fg.assign.fg_mask.sum(1)
    assert (fg_counts > 6).all(), fg_counts  # past max_fg = 6 in both images
    out = loss((tf, tm, tp), *(torch.from_numpy(v) for v in (labels, gt, mask, idx)))
    out.total.backward()
    assert not out.components.requires_grad and out.components.shape == (4,)
    assert abs(out.total.item() - float(jtotal)) <= 1e-5 * abs(float(jtotal))
    np.testing.assert_allclose(out.components.numpy(), np.asarray(jcomps), rtol=1e-5)
    assert (np.asarray(jcomps) > 0).all()
    got = [*(t.grad.permute(0, 2, 3, 1) for t in tf), tm.grad, tp.grad.permute(0, 2, 3, 1)]
    for g, w in zip(got, [*jgrads[0], jgrads[1], jgrads[2]]):
        w = np.asarray(w, np.float64)
        assert np.linalg.norm(g.numpy() - w) / np.linalg.norm(w) <= 1e-4


def test_top_foreground_keeps_the_lowest_indices_as_lax_top_k():
    fg = np.random.default_rng(4).random((3, 200)) < 0.3
    want = np.asarray(jax.lax.top_k(jnp.asarray(fg, jnp.float32), 16)[1])
    got = top_foreground(torch.from_numpy(fg), 16).numpy()
    np.testing.assert_array_equal(got, want)
    assert (fg.sum(1) > 16).all()
    np.testing.assert_array_equal(got, np.stack([np.nonzero(f)[0][:16] for f in fg]))


def _step_batch(seed=0):
    feats, mc, proto, labels, gt, mask, idx = _loss_inputs(seed)
    img = np.random.default_rng(seed).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    return {"img": img, "cls": labels, "bboxes": gt, "mask": mask, "masks": idx}


def test_segment_train_step_matches_jax(tiny):
    """One SGD step of the tiny model on both sides: the loss within 1e-4
    relative, each gradient leaf within 1e-3 relative norm."""
    jm, variables, _ = tiny
    batch = _step_batch(1)
    tx, _, _ = jax_build_optimizer(variables["params"], **OPT)
    tx = _recording(tx)
    state = TrainState.create(jax.tree.map(jnp.asarray, variables), tx)
    jstate, jmetrics = jax.jit(make_train_step(
        jm.graph, JaxSegLoss(nc=NC, strides=STRIDES), tx, extra_loss_keys=("masks",)))(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    port = _port(TINY_SEG, variables)
    opt, _, _ = build_optimizer(port.named_parameters(), **OPT)
    grads = {}
    for name, p in port.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda t, name=name: grads.__setitem__(name, t.grad.detach().clone()))
    m = TrainStep(port, SegmentationLoss(nc=NC, strides=STRIDES), opt, ModelEMA(port))(batch)
    assert abs(m["loss"].item() - float(jmetrics["loss"])) <= 1e-4 * abs(float(jmetrics["loss"]))
    np.testing.assert_allclose(m["components"].numpy(), np.asarray(jmetrics["components"]),
                               rtol=1e-4)
    assert m["components"][1].item() > 0 and m["cls_loss"] == m["components"][2]
    ref = dict(_port(TINY_SEG, {"params": jax.tree.map(np.asarray, jstate.opt_state[1]),
                                "batch_stats": variables["batch_stats"]}).named_parameters())
    assert set(grads) == set(ref)
    bad = [n for n, g in grads.items()
           if (g - ref[n]).norm() > 1e-3 * ref[n].norm().clamp(min=1e-30)]
    assert not bad, bad


@pytest.fixture(scope="module")
def labelled_val(tiny, segset, tmp_path_factory):
    """The val images relabelled with the port's own 3 best masks of boxes
    under 40 px (their contours as polygons; the best boxes span the
    image): random labels would give mAP 0 on both sides."""
    _, _, port = tiny
    root = tmp_path_factory.mktemp("segval")
    data = make_segment_dataset(root, n_val=4, imgsz=IMGSZ, seed=2)
    files = sorted((root / "val" / "images").glob("*.jpg"))
    results = DetectionPredictor({"imgsz": IMGSZ, "conf": 0.001, "batch": 4})(
        source=[cv2.imread(str(f)) for f in files], model=port)
    n = 0
    for f, r in zip(files, results):
        rows = [f"{int(c)} " + " ".join(f"{v / IMGSZ:.6f}" for v in poly.reshape(-1))
                for c, b, poly in zip(r.boxes.cls, r.boxes.xyxy, r.masks.xy)
                if b[2] - b[0] < 40 and len(poly) >= 3][:3]
        n += len(rows)
        (root / "val" / "labels" / f"{f.stem}.txt").write_text("\n".join(rows) + "\n")
    assert n >= 4
    return {**data, "names": {0: "a", 1: "b"}}


def test_segment_val_metrics_match_jax(tiny, labelled_val):
    jm, _, port = tiny
    args = {"data": labelled_val, "imgsz": IMGSZ, "batch": 2, "conf": 0.001, "iou": 0.7,
            "max_det": 300, "task": "segment", "max_boxes": 16}
    got = DetectionValidator(args)(model=port)
    want = JaxValidator(args)(model=jm)
    assert want["metrics/mAP50(M)"] > 0.05 and want["metrics/mAP50(B)"] > 0.05
    for k in ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
              "metrics/mAP50-95(B)", "metrics/mAP50(M)", "metrics/mAP50-95(M)", "fitness"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


def pair_rows(got: np.ndarray, want: np.ndarray) -> list[int]:
    """For each detection row of ``got``, the row of ``want`` with its class,
    its box within 1e-3 px and its score within 1e-4, each taken once:
    with randomised weights many scores lie within float noise of each
    other, so the two sides may rank them apart."""
    used, order = set(), []
    for row in got:
        j = next((j for j, w in enumerate(want) if j not in used and w[5] == row[5]
                  and np.abs(w[:4] - row[:4]).max() <= 1e-3 and abs(w[4] - row[4]) <= 1e-4),
                 None)
        assert j is not None, row
        used.add(j)
        order.append(j)
    return order


def test_segment_predict_masks_and_rows_match_jax(tiny, tmp_path):
    jm, _, port = tiny
    r = np.random.default_rng(6)
    imgs = [cv2.GaussianBlur(r.integers(0, 256, s, dtype=np.uint8), (0, 0), 2)
            for s in ((80, 100, 3), (64, 48, 3))]
    kw = {"imgsz": IMGSZ, "conf": 0.05, "batch": 2}
    got = DetectionPredictor(kw)(source=imgs, model=port)
    want = JaxPredictor(kw)(source=imgs, model=jm)
    assert sum(len(g) for g in got) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w) == len(g.masks)
        order = pair_rows(g.boxes.data, w.boxes.data)
        assert g.masks.data.shape == w.masks.data.shape == (len(g), *g.orig_shape)
        flipped = ((g.masks.data > 0.5) != (w.masks.data[order] > 0.5)).mean()
        assert flipped <= 2e-3, flipped
        assert g.masks.data.sum() > 0
        assert g.plot().shape == g.orig_img.shape
    g = next(g for g in got if len(g))
    rows = g.save_txt(tmp_path / "seg.txt", save_conf=True).read_text().splitlines()
    assert len(rows) == len(g)
    i = max(range(len(g)), key=lambda j: len(g.masks.xy[j]))
    assert len(rows[i].split()) == 1 + 2 * len(g.masks.xy[i]) + 1  # cls, the contour, conf
    entry = json.loads(g.tojson())[i]
    assert len(entry["segments"]["x"]) == len(g.masks.xy[i]) > 0


def _cfg_file(tmp_path):
    """The tiny yaml as a file, as a user passes one to the CLI."""
    import yaml

    p = tmp_path / "tiny-seg.yaml"
    p.write_text(yaml.safe_dump(TINY_SEG))
    return p


def test_cli_segment_predict_on_the_cpu(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "im.jpg"), img)
    assert entrypoint(["segment", "predict", f"model={_cfg_file(tmp_path)}",
                       f"source={tmp_path / 'im.jpg'}", "imgsz=64", "conf=0.001", "device=cpu",
                       f"project={tmp_path / 'runs'}", "save_txt=True"]) == 0
    labels = list((tmp_path / "runs").rglob("*.txt"))
    assert len(labels) == 1 and labels[0].read_text().strip()


def test_segment_model_trains_and_reloads_as_segment(segset, tmp_path):
    model = YOLO(str(_cfg_file(tmp_path)), task="segment", device="cpu", imgsz=IMGSZ, nc=3)
    res = model.train(data=segset, epochs=1, batch=2, imgsz=IMGSZ, plots=False, workers=2,
                      project=str(tmp_path / "runs"), copy_paste=0.5, warmup_epochs=0.0,
                      multi_scale=True)
    assert "metrics/mAP50(M)" in res and np.isfinite(res["metrics/mAP50(M)"])
    header = (tmp_path / "runs" / "train" / "results.csv").read_text().splitlines()[0]
    assert "metrics/mAP50(B)" in header and "(M)" not in header
    assert YOLO(res["save_dir"] + "/weights/best", device="cpu").task == "segment"


def test_two_ranks_segment_and_pose_steps_match_one_process(tmp_path):
    """Two gloo ranks on the CPU each take half of a global batch of 2 in
    fp64 (the tiny segment and pose models, one start-up of the ranks):
    the loss and components are one process's, 1e-9 relative."""
    from test_torch_pose import KPT_SHAPE, TINY_POSE, pose_step_batch

    from yolo_ad_refine_tpu_torch.models.model import build_detection_model
    from yolo_ad_refine_tpu_torch.train.pose import PoseLoss

    cases = {"seg": (TINY_SEG, NC, _step_batch(2), SegmentationLoss(nc=NC, strides=STRIDES)),
             "pose": (TINY_POSE, 1, pose_step_batch(2),
                      PoseLoss(nc=1, strides=STRIDES, kpt_shape=KPT_SHAPE))}
    runs = []
    for name, (cfg, nc, batch, _) in cases.items():
        np.savez(tmp_path / f"{name}.npz", **{k: v[None] for k, v in batch.items()})
        runs.append({"cfg": cfg, "nc": nc, "batches": str(tmp_path / f"{name}.npz"),
                     "out": str(tmp_path / name)})
    recs = run_ranks({"scenario": "step", "device": "cpu", "imgsz": IMGSZ, "float64": True,
                      "opt": OPT, "threads": 1, "timeout_s": 240, "out": str(tmp_path),
                      "runs": runs}, world=2)
    for (name, (cfg, nc, batch, loss)), rec in zip(cases.items(), recs):
        model = build_detection_model(cfg, nc=nc, device="cpu", imgsz=IMGSZ).double().train()
        out = loss(model(images_to_tensor(batch["img"], "cpu").double()),
                   *(torch.from_numpy(batch[k]) for k in ("cls", "bboxes", "mask",
                                                          *loss.extra_keys)))
        assert out.components[1].item() > 0, name
        for r in rec:
            assert abs(r["loss"][0] - out.total.item()) <= 1e-9 * abs(out.total.item()), name
            np.testing.assert_allclose(r["components"][0], out.components.numpy(), rtol=1e-9)
