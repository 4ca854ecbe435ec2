"""The train path's building blocks in the PyTorch port against the JAX
package, fp32 on the CPU: box geometry, the TAL assigner, the detection
loss and its gradient, the BatchNorm running-stat update, the optimizer
with its schedules, clip, accumulation and EMA, and the AP metrics.

Tolerances: geometry 1e-6; assigner targets 1e-6; loss 1e-5 relative and
its gradient 1e-5 of max |ref| (sums of ~100 terms in another order);
running stats 1e-6; optimizer 1e-6 of max |param| per tensor after the
steps; metrics 1e-9 (the same numpy on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from test_torch_weights import randomize, transfer
from yolo_ad_refine_tpu.ops.anchors import bbox2dist as jax_bbox2dist
from yolo_ad_refine_tpu.ops.iou import bbox_iou as jax_bbox_iou
from yolo_ad_refine_tpu.ops.iou import wasserstein_similarity as jax_nwd
from yolo_ad_refine_tpu.train.loss import DetectionLoss as JaxDetectionLoss
from yolo_ad_refine_tpu.train.optim import build_optimizer as jax_build_optimizer
from yolo_ad_refine_tpu.train.optim import ema_update as jax_ema_update
from yolo_ad_refine_tpu.train.tal import TaskAlignedAssigner as JaxTAL
from yolo_ad_refine_tpu.utils import metrics as jax_metrics
from yolo_ad_refine_tpu_torch.nn.common import Conv
from yolo_ad_refine_tpu_torch.ops.anchors import bbox2dist
from yolo_ad_refine_tpu_torch.ops.iou import bbox_iou, wasserstein_similarity
from yolo_ad_refine_tpu_torch.train.loss import DetectionLoss
from yolo_ad_refine_tpu_torch.train.optim import ModelEMA, build_optimizer
from yolo_ad_refine_tpu_torch.train.tal import TaskAlignedAssigner
from yolo_ad_refine_tpu_torch.utils import metrics


def _boxes(r, shape, lo=0.0, hi=64.0):
    xy = r.uniform(lo, hi * 0.7, shape + (2,))
    wh = r.uniform(0.5, hi * 0.3, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _scaled_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# -- geometry ------------------------------------------------------------------

def test_bbox2dist_ciou_nwd_match_jax():
    r = np.random.default_rng(0)
    b1, b2 = _boxes(r, (7, 40)), _boxes(r, (7, 40))
    anc = r.uniform(0, 64, (40, 2)).astype(np.float32)
    t1, t2 = torch.from_numpy(b1), torch.from_numpy(b2)
    np.testing.assert_allclose(bbox2dist(torch.from_numpy(anc), t2, 15).numpy(),
                               np.asarray(jax_bbox2dist(jnp.asarray(anc), jnp.asarray(b2), 15)),
                               atol=1e-6, rtol=1e-6)
    for kw in ({}, {"CIoU": True}):
        np.testing.assert_allclose(
            bbox_iou(t1, t2, xywh=False, **kw).numpy(),
            np.asarray(jax_bbox_iou(jnp.asarray(b1), jnp.asarray(b2), xywh=False, **kw)),
            atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(wasserstein_similarity(t1, t2).numpy(),
                               np.asarray(jax_nwd(jnp.asarray(b1), jnp.asarray(b2))),
                               atol=1e-6, rtol=1e-6)


def test_ciou_alpha_carries_no_gradient():
    r = np.random.default_rng(1)
    b1, b2 = _boxes(r, (5,)), _boxes(r, (5,))
    t1 = torch.from_numpy(b1).requires_grad_()
    bbox_iou(t1, torch.from_numpy(b2), xywh=False, CIoU=True).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jax_bbox_iou(a, jnp.asarray(b2), xywh=False, CIoU=True)))(
        jnp.asarray(b1))
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


# -- assigner -------------------------------------------------------------------

def test_assigner_matches_jax_with_padded_rows_and_ties():
    r = np.random.default_rng(2)
    b, a, n, nc = 2, 84, 6, 3
    anc = np.stack(np.meshgrid(np.arange(0.5, 12), np.arange(0.5, 7)), -1).reshape(-1, 2)
    anc = (anc * 5.0).astype(np.float32)
    pd_scores = r.random((b, a, nc)).astype(np.float32)
    pd_bboxes = np.concatenate([anc - 6, anc + 6], -1)[None].repeat(b, 0).astype(np.float32)
    pd_scores[:, 20:40] = 0.5          # tied scores over identical-shape boxes: tied metrics
    gt = _boxes(r, (b, n), 0, 60)
    gt[:, 0] = [5, 5, 40, 30]          # a large box covering the tied anchors
    labels = r.integers(0, nc, (b, n, 1)).astype(np.float32)
    mask = np.ones((b, n, 1), np.float32)
    mask[0, 4:] = 0                    # padded rows
    mask[1, 5:] = 0
    gt[mask[..., 0] == 0] = 0
    args = (pd_scores, pd_bboxes, anc, labels, gt, mask)
    want = JaxTAL(topk=10, num_classes=nc, alpha=0.5, beta=6.0)(*(jnp.asarray(v) for v in args))
    got = TaskAlignedAssigner(topk=10, num_classes=nc)(*(torch.from_numpy(v) for v in args))
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(want.fg_mask))
    assert got.fg_mask.sum() > 10
    np.testing.assert_array_equal(got.target_gt_idx.numpy(), np.asarray(want.target_gt_idx))
    np.testing.assert_allclose(got.target_bboxes.numpy(), np.asarray(want.target_bboxes),
                               atol=1e-6)
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(want.target_scores),
                               atol=1e-6)


# -- loss --------------------------------------------------------------------------

def _loss_inputs(seed=3, b=2, nc=3, n=5):
    r = np.random.default_rng(seed)
    no = 64 + nc
    feats = [r.normal(0, 1, (b, s, s, no)).astype(np.float32) for s in (8, 4, 2)]
    gt = _boxes(r, (b, n), 0, 60)
    labels = r.integers(0, nc, (b, n, 1)).astype(np.float32)
    mask = np.ones((b, n, 1), np.float32)
    mask[1, 3:] = 0
    gt[mask[..., 0] == 0] = 0
    return feats, labels, gt, mask


def test_detection_loss_and_gradient_match_jax():
    feats, labels, gt, mask = _loss_inputs()
    jl = JaxDetectionLoss(nc=3, strides=(8, 16, 32))

    @jax.jit
    def jax_loss(fs):
        out = jl(fs, jnp.asarray(labels), jnp.asarray(gt), jnp.asarray(mask))
        return out.total, out.components

    (jtotal, jcomps), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
        [jnp.asarray(f) for f in feats])
    tf = [torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_() for f in feats]
    out = DetectionLoss(nc=3, strides=(8, 16, 32))(
        tf, *(torch.from_numpy(v) for v in (labels, gt, mask)))
    out.total.backward()
    assert abs(out.total.item() - float(jtotal)) <= 1e-5 * abs(float(jtotal))
    np.testing.assert_allclose(out.components.numpy(), np.asarray(jcomps), rtol=1e-5)
    for t, g in zip(tf, jgrads):
        assert _scaled_err(t.grad.permute(0, 2, 3, 1).numpy(), g) <= 1e-5


# -- BatchNorm -----------------------------------------------------------------------

def test_conv_train_step_running_stats_match_flax():
    """One train-mode call of Conv on a tiny map: the output and the
    running mean / variance (flax's biased variance) within 1e-6."""
    from yolo_ad_refine_tpu.nn.common import Conv as JConv

    x = np.random.default_rng(4).normal(0.5, 2.0, (2, 2, 2, 3)).astype(np.float32)
    v = randomize(JConv(8, 1).init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 2, 3))), seed=4)
    y, mutated = JConv(8, 1).apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    port = transfer(Conv(3, 8, 1), v).train()
    yt = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(yt.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(port.bn.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["bn"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(port.bn.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["bn"]["var"]), atol=1e-6)
    assert int(port.bn.num_batches_tracked) == 1


# -- optimizer and EMA --------------------------------------------------------------

class _Tiny(nn.Module):
    """conv.weight (decay), conv.bias (bias), bn.weight / bn.bias, and BN
    running stats for the EMA."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(2, 4, 3)
        self.bn = nn.BatchNorm2d(4)


def _tiny_params(r):
    return {"conv": {"kernel": r.normal(0, 0.3, (3, 3, 2, 4)).astype(np.float32),
                     "bias": r.normal(0, 0.3, (4,)).astype(np.float32)},
            "bn": {"scale": r.uniform(0.5, 1.5, (4,)).astype(np.float32),
                   "bias": r.normal(0, 0.3, (4,)).astype(np.float32)}}


def _to_port(tree):
    return {"conv.weight": tree["conv"]["kernel"].transpose(3, 2, 0, 1),
            "conv.bias": tree["conv"]["bias"], "bn.weight": tree["bn"]["scale"],
            "bn.bias": tree["bn"]["bias"]}


OPT_CASES = {
    # name: (optimizer, epochs, nb, batch, batches run, grad scale)
    "sgd": ("SGD", 10, 20, 64, 6, 0.1),
    "sgd_accumulate4": ("SGD", 10, 20, 16, 24, 0.1),
    "sgd_warmup_crossing": ("SGD", 20, 10, 64, 104, 0.05),
    "auto_adam_clip_fires": ("auto", 10, 20, 64, 6, 50.0),
    "auto_adam_accumulate4": ("auto", 10, 20, 16, 24, 0.1),
    "auto_sgd": ("auto", 200, 60, 64, 6, 0.1),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_and_ema_match_optax(case):
    opt_name, epochs, nb, batch, n_batches, gscale = OPT_CASES[case]
    r = np.random.default_rng(7)
    params = _tiny_params(r)
    kw = dict(optimizer=opt_name, lr0=0.01, lrf=0.01, momentum=0.937, weight_decay=0.0005,
              epochs=epochs, nb=nb, batch=batch, nbs=64, warmup_epochs=3.0,
              warmup_momentum=0.8, warmup_bias_lr=0.1, cos_lr=False, nc=3)
    tx, acc_j, _ = jax_build_optimizer(params, **kw)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    stats = {"mean": np.zeros(4, np.float32), "var": np.ones(4, np.float32)}
    jema = {"params": jax.tree.map(jnp.asarray, params), "stats": jax.tree.map(jnp.asarray, stats)}
    ema_updates = jnp.float32(0.0)

    model = _Tiny()
    with torch.no_grad():
        for k, v in _to_port(params).items():
            model.get_parameter(k).copy_(torch.from_numpy(np.ascontiguousarray(v)))
    opt, acc_p, _ = build_optimizer(model.named_parameters(), **kw)
    assert acc_p == acc_j
    ema = ModelEMA(model)

    for step in range(n_batches):
        grads = jax.tree.map(lambda p: (r.normal(0, 1, p.shape) * gscale).astype(np.float32),
                             params)
        stats = {"mean": r.normal(0, 1, 4).astype(np.float32),
                 "var": r.uniform(0.5, 1.5, 4).astype(np.float32)}
        # JAX: the train step's update and EMA (train/step.py:143-156)
        updates, opt_state = update(jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        is_opt = float((step + 1) % acc_j == 0)
        ema_updates = ema_updates + is_opt
        for key, new in (("params", jparams), ("stats", jax.tree.map(jnp.asarray, stats))):
            upd = jax_ema_update(jema[key], new, ema_updates)
            jema[key] = jax.tree.map(lambda a, b: a + is_opt * (b - a), jema[key], upd)
        # port
        for k, g in _to_port(grads).items():
            p = model.get_parameter(k)
            g = torch.from_numpy(np.ascontiguousarray(g))
            p.grad = g if p.grad is None else p.grad + g
        model.bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        model.bn.running_var.copy_(torch.from_numpy(stats["var"]))
        if opt.step():
            ema.update(model)

    jnp_params = jax.tree.map(np.asarray, jparams)
    for k, want in _to_port(jnp_params).items():
        assert _scaled_err(model.get_parameter(k).detach().numpy(), want) <= 1e-6, k
    ema_sd = ema.ema.state_dict()
    for k, want in _to_port(jax.tree.map(np.asarray, jema["params"])).items():
        assert _scaled_err(ema_sd[k].numpy(), want) <= 1e-6, f"ema {k}"
    assert _scaled_err(ema_sd["bn.running_mean"].numpy(), jema["stats"]["mean"]) <= 1e-6
    assert _scaled_err(ema_sd["bn.running_var"].numpy(), jema["stats"]["var"]) <= 1e-6
    assert ema.updates == int(ema_updates) == n_batches // acc_j


def test_auto_takes_adam_with_coupled_decay():
    model = _Tiny()
    opt, _, _ = build_optimizer(model.named_parameters(), optimizer="auto", epochs=10, nb=20,
                                batch=64, nc=3)
    assert type(opt.opt) is torch.optim.Adam
    groups = {g["name"]: g for g in opt.opt.param_groups}
    assert groups["decay"]["weight_decay"] == 0.0005 and groups["bias"]["weight_decay"] == 0
    assert groups["decay"]["betas"] == (0.9, 0.999)
    assert opt.lr_fns["bias"](0) == 0.0  # auto sets warmup_bias_lr to 0
    # lr0 = round(0.002 * 5 / (4 + nc), 6); at batch 100 (epoch 5 of 10) lf = 0.505
    assert opt.lr_fns["decay"](100) == pytest.approx(round(0.002 * 5 / 7, 6) * 0.505)


# -- metrics --------------------------------------------------------------------------

def test_ap_per_class_and_det_metrics_match_jax():
    r = np.random.default_rng(8)
    n, m = 300, 80
    tp = r.random((n, 10)) < np.linspace(0.8, 0.2, 10)
    conf = r.random(n)
    pred_cls = r.integers(0, 4, n).astype(np.float64)
    target_cls = r.integers(0, 4, m).astype(np.float64)
    want = jax_metrics.ap_per_class(tp, conf, pred_cls, target_cls)
    got = metrics.ap_per_class(tp, conf, pred_cls, target_cls)
    for k in ("p", "r", "f1", "ap"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-9, rtol=0)
    dm, jm = metrics.DetMetrics({}), jax_metrics.DetMetrics({})
    for lo in range(0, n, 100):
        for d in (dm, jm):
            d.update_stats(tp[lo:lo + 100], conf[lo:lo + 100], pred_cls[lo:lo + 100],
                           target_cls[lo // 100 * 20: lo // 100 * 20 + 20])
    res, jres = dm.process(), jm.process()
    for k, v in jres.items():
        assert abs(res[k] - v) <= 1e-9, k
    assert res["fitness"] == pytest.approx(0.9 * res["metrics/mAP50(B)"]
                                           + 0.1 * res["metrics/mAP50-95(B)"], abs=1e-12)
