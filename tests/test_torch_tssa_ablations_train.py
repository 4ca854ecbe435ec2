"""One train step of the 697 ablation model (the flagship yaml with
``C2TSSA_DYT_Mona_EDFFN`` at layer 10), the PyTorch port against the JAX
package: imgsz 128, nc 2, batch 2, fp32 on the CPU, SGD without warmup,
the same randomised weights and batch on both sides. (At 256 the neck's
gradient into row 12 already lies ~1.5e-3 from the fp64 step on both fp32
sides, so every backbone leaf would fall to the fp64 rule below; at 128
the direct 1e-3 rule holds for them.) Layer 10's two
Monas drop units in train mode: the JAX step draws its masks from its own
dropout rng (captured as it runs, ``capture_dropout``), and the port's
step drops exactly those (``tests/torch_dropout_masks.py``).

Held: the loss within 1e-4 relative; every gradient leaf within 1e-3
relative norm of JAX's, unless the port's fp32 gradient lies more than
1e-3 from the same step in fp64 (sums that cancel to rounding, e.g. a conv
bias ahead of a train-mode BatchNorm): then JAX's must lie within 4 times
the port's distance from the fp64 one (the rule of
``tests/test_torch_train_slice.py``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_obb_train import _recording
from test_torch_tssa_ablations import ablation_cfg, capture_dropout, port_masks
from test_torch_weights import jax_shapes, randomize
from torch_dropout_masks import FixedDropout, set_masks
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


@pytest.fixture(scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


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
    return {"img": img, "cls": cls, "bboxes": bboxes * mask, "mask": mask}


def _port_like(cfg, variables) -> DetectionModel:
    m = DetectionModel(cfg, nc=NC)
    load_jax_variables(m, flatten_tree(variables["params"]), flatten_tree(variables["batch_stats"]))
    return m


@pytest.fixture(scope="module")
def steps(few_threads):
    cfg = dict(ablation_cfg("C2TSSA_DYT_Mona_EDFFN"), nc=NC)
    jm, shapes = jax_shapes(cfg, IMGSZ)
    variables = randomize(shapes, seed=17)
    batch = _batch()
    tx, _, _ = jax_build_optimizer(variables["params"], **OPT)
    tx = _recording(tx)
    state = TrainState.create(jax.tree.map(jnp.asarray, variables), tx)
    store = {}
    with capture_dropout(store):
        step = jax.jit(make_train_step(jm.graph, JaxDetectionLoss(nc=NC, strides=(8, 16, 32)), tx))
        jstate, jmetrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                jax.random.PRNGKey(0))
        jax.block_until_ready(jstate)
        jax.effects_barrier()  # the dropout masks' callbacks have run
    jgrads = jstate.opt_state[1]

    port = _port_like(cfg, variables)
    set_masks(port, port_masks(port, store))
    port64 = copy.deepcopy(port).double().train()
    out64 = DetectionLoss(nc=NC, strides=(8, 16, 32))(
        port64(images_to_tensor(batch["img"], "cpu").double()),
        *(torch.from_numpy(batch[k]).double() for k in ("cls", "bboxes", "mask")))
    out64.total.backward()
    grads64 = {n: p.grad.detach().clone() for n, p in port64.named_parameters()
               if p.grad is not None}
    opt, _, _ = build_optimizer(port.named_parameters(), **OPT)
    grads = {}
    for name, p in port.named_parameters():
        p.register_post_accumulate_grad_hook(
            lambda t, name=name: grads.__setitem__(name, t.grad.detach().clone()))
    metrics = TrainStep(port, DetectionLoss(nc=NC, strides=(8, 16, 32)), opt, ModelEMA(port))(batch)
    return cfg, variables, store, jgrads, jmetrics, port, grads, grads64, metrics


def test_the_jax_step_dropped_units_in_every_mona(steps):
    _, _, store, *_, port, _, _, _ = steps
    assert len(store) == 2  # layer 10's one block at scale n: mona1, mona2
    fixed = [m for m in port.modules() if isinstance(m, FixedDropout)]
    assert len(fixed) == 2
    for m in fixed:
        assert m.keep.shape == (BATCH, 64, IMGSZ // 32, IMGSZ // 32)
        assert 0.8 < m.keep.float().mean() < 0.97


def test_loss_matches(steps):
    *_, jmetrics, _, _, _, metrics = steps
    assert abs(metrics["loss"].item() - float(jmetrics["loss"])) <= \
        1e-4 * abs(float(jmetrics["loss"]))
    np.testing.assert_allclose(metrics["components"].numpy(), np.asarray(jmetrics["components"]),
                               rtol=1e-4)


def test_every_gradient_leaf_matches(steps):
    cfg, variables, _, jgrads, _, _, grads, grads64, _ = steps
    ref = dict(_port_like(cfg, {"params": jax.tree.map(np.asarray, jgrads),
                                "batch_stats": variables["batch_stats"]}).named_parameters())
    assert set(grads) == set(grads64) <= set(ref) and len(grads) > 300
    bad, noisy = [], []
    for name, want in ref.items():
        want = want.detach().double()
        if name not in grads:
            assert not want.any(), name  # unused by the forward (scale_weights)
            continue
        got, exact = grads[name].double(), grads64[name]
        port_off = (got - exact).norm()
        if port_off <= 1e-3 * exact.norm():
            err = (got - want).norm() / want.norm().clamp(min=1e-30)
            if err > 1e-3:
                bad.append(f"{name}: {err:.2e} relative norm")
            continue
        noisy.append(name)
        if (want - exact).norm() > 4 * port_off:
            bad.append(f"{name}: |jax - fp64| {(want - exact).norm():.2e}, "
                       f"|port - fp64| {port_off:.2e}")
    assert not bad, bad
    layer10 = [n for n in grads if n.startswith("model.10.m.")]
    assert any("mona" in n for n in layer10) and any("attn.temp" in n for n in layer10)
