"""One train step of the flagship, the PyTorch port against the JAX package:
YOLO-AD-Refine at imgsz 128, nc 2, batch 2, fp32 on the CPU, SGD without
warmup (so every group moves on the first step), the same randomised
weights and the same batch on both sides.

Held: the loss within 1e-5 relative; every gradient leaf within 1e-4
relative norm (names mapped through ``load_jax_variables``, as
test_torch_weights does); the updated params, BN running stats and EMA
within 1e-5 of max |ref| per tensor. ``dcn_offset_max`` is a forward
quantity like the loss, the max of a conv output 30 layers deep whose fp32
sums run in another order in each framework (6.6e-6 relative apart here),
so it is held at 1e-5 relative; that the port records exactly the max of
its own raw offsets is held at 0.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import FLAGSHIP, jax_shapes, randomize
from yolo_ad_refine_tpu.models.model import DetectionModel as JaxDetectionModel
from yolo_ad_refine_tpu.train.loss import DetectionLoss as JaxDetectionLoss
from yolo_ad_refine_tpu.train.optim import build_optimizer as jax_build_optimizer
from yolo_ad_refine_tpu.train.step import TrainState, make_train_step
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.train.loss import DetectionLoss
from yolo_ad_refine_tpu_torch.train.optim import ModelEMA, build_optimizer
from yolo_ad_refine_tpu_torch.train.step import TrainStep, images_to_tensor
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

IMGSZ, NC, BATCH, MAX_BOXES = 128, 2, 2, 8
OPT = dict(optimizer="SGD", lr0=0.01, lrf=0.01, momentum=0.937, weight_decay=0.0005, epochs=1,
           nb=1, batch=BATCH, nbs=BATCH, warmup_epochs=0.0, warmup_momentum=0.8,
           warmup_bias_lr=0.1, cos_lr=False, nc=NC)


def _batch(seed=0):
    r = np.random.default_rng(seed)
    img = r.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    xy = r.uniform(0, 90, (BATCH, MAX_BOXES, 2))
    wh = r.uniform(8, 38, (BATCH, MAX_BOXES, 2))
    bboxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    cls = r.integers(0, NC, (BATCH, MAX_BOXES, 1)).astype(np.float32)
    mask = np.zeros((BATCH, MAX_BOXES, 1), np.float32)
    mask[0, :5] = 1
    mask[1, :3] = 1
    bboxes *= mask
    return {"img": img, "cls": cls, "bboxes": bboxes, "mask": mask}


def _port_like(variables: dict) -> DetectionModel:
    """A port model holding a JAX {'params', 'batch_stats'} tree."""
    m = DetectionModel(FLAGSHIP, nc=NC)
    load_jax_variables(m, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    return m


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def steps():
    cfg = dict(JaxDetectionModel(FLAGSHIP).yaml, nc=NC)
    jm, shapes = jax_shapes(cfg, IMGSZ)
    variables = randomize(shapes, seed=11)
    batch = _batch()
    jloss = JaxDetectionLoss(nc=NC, strides=(8, 16, 32))

    def loss_of(params, stats, img, cls, bboxes, mask):
        feats, _ = jm.graph.apply({"params": params, "batch_stats": stats},
                                  img.astype(jnp.float32) / 255.0, train=True,
                                  mutable=["batch_stats", "diagnostics"])
        return jloss(feats, cls, bboxes, mask).total

    jgrads = jax.jit(jax.grad(loss_of))(variables["params"], variables["batch_stats"],
                                        *(jnp.asarray(batch[k])
                                          for k in ("img", "cls", "bboxes", "mask")))
    tx, _, _ = jax_build_optimizer(variables["params"], **OPT)
    state = TrainState.create(jax.tree.map(jnp.asarray, variables), tx)
    step = jax.jit(make_train_step(jm.graph, jloss, tx))
    jstate, jmetrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(0))

    port = _port_like(variables)
    # the same forward and backward in fp64: the reference for fp32 noise
    port64 = copy.deepcopy(port).double().train()
    out64 = DetectionLoss(nc=NC, strides=(8, 16, 32))(
        port64(images_to_tensor(batch["img"], "cpu").double()),
        *(torch.from_numpy(batch[k]).double() for k in ("cls", "bboxes", "mask")))
    out64.total.backward()
    grads64 = {n: p.grad.detach().clone() for n, p in port64.named_parameters()
               if p.grad is not None}
    opt, _, _ = build_optimizer(port.named_parameters(), **OPT)
    ema = ModelEMA(port)
    offsets = []  # the raw offset channels of the three levels, as the head made them
    port.model[port.head_idx].spatial_conv_offset.register_forward_hook(
        lambda mod, args, out: offsets.append(out[:, :18].detach().abs().amax()))
    grads = {}
    for name, p in port.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda t, name=name: grads.__setitem__(name, t.grad.detach().clone()))
    metrics = TrainStep(port, DetectionLoss(nc=NC, strides=(8, 16, 32)), opt, ema)(batch)
    assert len(offsets) == 3
    metrics["offsets_max"] = torch.stack(offsets).amax()
    return {"jax": (variables, jgrads, jstate, jmetrics),
            "port": (port, (grads, grads64), ema, metrics)}


def test_loss_and_offset_max_match(steps):
    _, _, _, jm = steps["jax"]
    _, _, _, m = steps["port"]
    assert abs(m["loss"].item() - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    np.testing.assert_allclose(m["components"].numpy(), np.asarray(jm["components"]), rtol=1e-5)
    assert m["dcn_offset_max"].item() == m["offsets_max"].item() > 0
    assert abs(m["dcn_offset_max"].item() - float(jm["dcn_offset_max"])) <= \
        1e-5 * float(jm["dcn_offset_max"])


def test_every_gradient_leaf_matches(steps):
    """Each leaf within 1e-4 relative norm of JAX's, unless the leaf's own
    fp32 rounding is above that limit: where the port's fp32 gradient lies
    more than 1e-4 relative from the same step run in fp64, no fp32 result
    can meet the limit. Those are sums that cancel almost to nothing (a
    conv bias ahead of a train-mode BatchNorm has gradient 0 up to
    rounding; a scalar gate's gradient sums a whole map; 21 of 440 leaves
    here, among them the TaskDecomposition gates). For them the port's fp64
    gradient is the reference, and JAX's fp32 gradient must lie within 4
    times the distance of the port's own fp32 gradient from it."""
    variables, jgrads, _, _ = steps["jax"]
    _, (grads, grads64), _, _ = steps["port"]
    ref = dict(_port_like({"params": jax.tree.map(np.asarray, jgrads),
                           "batch_stats": variables["batch_stats"]}).named_parameters())
    assert set(grads) == set(grads64) <= set(ref) and len(grads) > 350
    bad, noisy = [], []
    for name, want in ref.items():
        want = want.detach().double()
        if name not in grads:
            # unused by the forward (AdaptiveDynamicTanh's scale_weights, as
            # in the reference): no gradient in torch, 0 in JAX
            assert not want.any(), name
            continue
        got, exact = grads[name].double(), grads64[name]
        port_off = (got - exact).norm()
        if port_off <= 1e-4 * exact.norm():
            err = (got - want).norm() / want.norm().clamp(min=1e-30)
            if err > 1e-4:
                bad.append(f"{name}: {err:.2e} relative norm")
            continue
        jax_off = (want - exact).norm()
        noisy.append(name)
        if jax_off > 4 * port_off:
            bad.append(f"{name}: |jax - fp64| {jax_off:.2e}, |port - fp64| {port_off:.2e}")
    assert not bad, bad
    assert noisy, "no leaf cancels: the fp64 route is untested"


def test_params_bn_stats_and_ema_match(steps):
    _, _, jstate, _ = steps["jax"]
    port, _, ema, _ = steps["port"]
    jax_np = jax.tree.map(np.asarray, {"params": jstate.params,
                                       "batch_stats": jstate.batch_stats})
    jax_ema = jax.tree.map(np.asarray, {"params": jstate.ema_params,
                                        "batch_stats": jstate.ema_batch_stats})
    for got_model, want_vars in ((port, jax_np), (ema.ema, jax_ema)):
        want = _port_like(want_vars).state_dict()
        got = got_model.state_dict()
        bad = [k for k, v in want.items() if v.dtype.is_floating_point
               and _rel_err(got[k].detach().numpy(), v.numpy()) > 1e-5]
        assert not bad, bad[:10]
    assert ema.updates == 1 and int(jstate.ema_updates) == 1
