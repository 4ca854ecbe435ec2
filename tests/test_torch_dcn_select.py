"""The DCN variant a user picks, and the radius it clips at, through the
port's DyDCNv2 against the JAX package's.

``YAT_DCN_IMPL`` and ``YAT_DCN_RADIUS`` are the JAX package's variables
(its nn/head.py:517-523); the port reads them in ``ops/deform.py
dcn_impl``. The JAX K2 and K3 run in Pallas interpret mode, as
tests/test_dcn_mxu.py runs them. The flagship's eval outputs are held at
1e-4 as in test_torch_slice.py; the train step's loss at 1e-5 relative and
its head gradients at 1e-4 relative norm, as test_torch_train_slice.py
holds them (``_check_train_step`` says which leaves cancel and why they are
printed instead).
The flagship's train step under an interpret-mode kernel costs some 45 s of
JAX compilation on one CPU and is marked slow; the kernels' gradients stay
in the quick tier in test_torch_dcn_window.py.
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolo_ad_refine_tpu.ops.deform_mxu as dm
import yolo_ad_refine_tpu.ops.deform_pallas as dp
from test_torch_train_slice import _batch
from test_torch_weights import FLAGSHIP, jax_shapes, randomize
from yolo_ad_refine_tpu.models.model import DetectionModel as JaxDetectionModel
from yolo_ad_refine_tpu.train.loss import DetectionLoss as JaxDetectionLoss
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.ops.deform import dcn_impl, modulated_deform_conv2d
from yolo_ad_refine_tpu_torch.ops.deform_mxu import modulated_deform_conv2d_mxu
from yolo_ad_refine_tpu_torch.ops.deform_pallas import modulated_deform_conv2d_pallas
from yolo_ad_refine_tpu_torch.train import trainer as trainer_mod
from yolo_ad_refine_tpu_torch.train.loss import DetectionLoss
from yolo_ad_refine_tpu_torch.train.step import images_to_tensor
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

TINY_AY = {  # tests/test_dcn_radius.py's model: five convs and the flagship's head
    "nc": 3,
    "backbone": [
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 1, "Conv", [32, 3, 2]],
        [-1, 1, "Conv", [64, 3, 2]],
        [-1, 1, "Conv", [128, 3, 2]],
        [-1, 1, "Conv", [256, 3, 2]],
    ],
    "head": [[[2, 3, 4], 1, "AYHead", ["nc"]]],
}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(dm, "_INTERPRET", True)
    monkeypatch.setattr(dp, "_INTERPRET", True)
    monkeypatch.delenv("YAT_DCN_IMPL", raising=False)
    monkeypatch.delenv("YAT_DCN_RADIUS", raising=False)


@pytest.mark.parametrize("impl,fn,radius", [
    (None, modulated_deform_conv2d, None), ("auto", modulated_deform_conv2d, None),
    ("exact", modulated_deform_conv2d, None), ("mxu2", modulated_deform_conv2d, 5),
    ("mxu", modulated_deform_conv2d_mxu, 5), ("pallas", modulated_deform_conv2d_pallas, 5)])
def test_dcn_impl_maps_each_value(monkeypatch, impl, fn, radius):
    if impl is not None:
        monkeypatch.setenv("YAT_DCN_IMPL", impl)
    assert dcn_impl(5.0) == (fn, radius)


def test_dcn_radius_variable_overrides_and_unknown_impl_raises(monkeypatch):
    monkeypatch.setenv("YAT_DCN_IMPL", "pallas")
    monkeypatch.setenv("YAT_DCN_RADIUS", "7.9")
    assert dcn_impl(3.0) == (modulated_deform_conv2d_pallas, 7)  # int(float(...)), as JAX
    monkeypatch.setenv("YAT_DCN_IMPL", "palas")
    with pytest.raises(ValueError, match="auto, mxu2, mxu, pallas, exact"):
        dcn_impl(3.0)


def test_yaml_dcn_radius_reaches_module():
    m = DetectionModel({**TINY_AY, "dcn_radius": 9.0})
    head = m.model[m.head_idx]
    assert head.dcn_radius == 9.0 and head.DyDCNV2.radius == 9.0
    head = DetectionModel(TINY_AY).model[DetectionModel(TINY_AY).head_idx]
    assert head.dcn_radius == 3.0 and head.DyDCNV2.radius == 3.0


@pytest.fixture(scope="module")
def flagship():
    jm, shapes = jax_shapes(FLAGSHIP, 128)
    variables = randomize(shapes, seed=3)
    port = DetectionModel(FLAGSHIP)
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    x = np.random.default_rng(0).random((1, 128, 128, 3)).astype(np.float32)
    return jm, variables, port.eval(), x


@pytest.mark.parametrize("impl", ["mxu", "pallas"])
def test_flagship_eval_matches_jax_under_impl(monkeypatch, flagship, impl):
    jm, variables, port, x = flagship
    monkeypatch.setenv("YAT_DCN_IMPL", impl)
    want, _ = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = port(xt)[0].numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def _train_step_case(cfg, imgsz, nc, seed, monkeypatch, impl):
    """(JAX loss, JAX grads as port names, port loss, port grads, port fp64
    grads) of one train-mode forward and backward under ``impl``."""
    monkeypatch.setenv("YAT_DCN_IMPL", impl)
    cfg = dict(JaxDetectionModel(cfg).yaml, nc=nc)
    jm, shapes = jax_shapes(cfg, imgsz)
    variables = randomize(shapes, seed=seed)
    batch = _batch()
    if imgsz != 128:
        batch["img"] = batch["img"][:, :imgsz, :imgsz]
        batch["bboxes"] = batch["bboxes"] * (imgsz / 128)
    keys = ("img", "cls", "bboxes", "mask")
    jloss = JaxDetectionLoss(nc=nc, strides=(8, 16, 32))

    def loss_of(params, stats, img, cls, bboxes, mask):
        feats, _ = jm.graph.apply({"params": params, "batch_stats": stats},
                                  img.astype(jnp.float32) / 255.0, train=True,
                                  mutable=["batch_stats", "diagnostics"])
        return jloss(feats, cls, bboxes, mask).total

    jl, jg = jax.jit(jax.value_and_grad(loss_of))(variables["params"], variables["batch_stats"],
                                                  *(jnp.asarray(batch[k]) for k in keys))
    ref = DetectionModel(cfg)
    load_jax_variables(ref, flatten_tree(jax.tree.map(np.asarray, jg)),
                       flatten_tree(variables["batch_stats"]))
    port = DetectionModel(cfg)
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    out = {}
    for dtype in (torch.float32, torch.float64):
        m = copy.deepcopy(port).to(dtype).train()
        loss = DetectionLoss(nc=nc, strides=(8, 16, 32))(
            m(images_to_tensor(batch["img"], "cpu").to(dtype)),
            *(torch.from_numpy(batch[k]).to(dtype) for k in keys[1:])).total
        loss.backward()
        out[dtype] = (loss.item(), {n: p.grad.detach().double() for n, p in m.named_parameters()
                                    if p.grad is not None})
    return (float(jl), dict(ref.named_parameters()), out[torch.float32][0],
            out[torch.float32][1], out[torch.float64][1], f"model.{port.head_idx}.")


def _check_train_step(case):
    """The loss at 1e-5 relative, and each head leaf at 1e-4 relative norm
    where the port's own fp32 rounding (its distance from the fp64 step) is
    below that limit, as test_torch_train_slice.py holds them. The leaves
    above it are sums that cancel (the TaskDecomposition gates, and the
    CoordAtt conv bias ahead of a train-mode BatchNorm); there
    JAX's fp32 gradient under its interpret-mode K3 lies 8-20 times farther
    from the fp64 step than the port's (2.9e-3 against 1.5e-4 to 3.6e-4
    relative for the reg-branch gates), so they are printed, not held."""
    jloss, ref, loss, grads, grads64, head = case
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    names = [n for n in grads if n.startswith(head)]
    assert len(names) > 50
    bad, noisy = [], []
    for n in names:
        want, got, exact = ref[n].detach().double(), grads[n], grads64[n]
        port_off = (got - exact).norm() / exact.norm()
        if port_off <= 1e-4:
            err = (got - want).norm() / want.norm().clamp(min=1e-30)
            if err > 1e-4:
                bad.append(f"{n}: {err:.2e}")
        else:
            noisy.append(n)
            print(f"cancelling, not held: {n}: |port - fp64| {port_off:.1e}, "
                  f"|jax - fp64| {(want - exact).norm() / exact.norm():.1e}")
    assert not bad, bad
    # the gates, and a conv bias ahead of a train-mode BatchNorm (gradient 0
    # up to rounding): nothing else may cancel
    assert noisy and all("_decomp.la_conv" in n or n.endswith("coord_attention_reg.conv1.bias")
                         for n in noisy), noisy


@pytest.mark.slow
def test_flagship_train_step_matches_jax_under_pallas(monkeypatch):
    """The flagship at imgsz 128, batch 2, under K3: loss and head
    gradients against JAX (about 45 s of interpret-mode compilation)."""
    _check_train_step(_train_step_case(FLAGSHIP, 128, 2, 11, monkeypatch, "pallas"))


def test_offset_guard_warns_near_the_radius(monkeypatch):
    """Offsets blown past the radius reach the head's recorded
    ``dcn_offset_max`` and the trainer's guard warns, as JAX's does
    (its train/trainer.py:392-398)."""
    m = DetectionModel({**TINY_AY, "dcn_radius": 4.0})
    head = m.model[m.head_idx]
    with torch.no_grad():
        head.spatial_conv_offset.bias[:18] = 9.0
    m.train()(torch.zeros(1, 3, 64, 64))
    off_max = float(head.dcn_offset_max)
    assert off_max > 4.0
    said = []
    monkeypatch.setattr(trainer_mod.LOGGER, "warning", said.append)
    guard = trainer_mod.DetectionTrainer._check_dcn_offsets
    guard(SimpleNamespace(model=m, dcn_offset_max=off_max))
    assert len(said) == 1 and f"{off_max:.2f}" in said[0] and "radius 4" in said[0]
    guard(SimpleNamespace(model=m, dcn_offset_max=0.89 * 4.0))
    assert len(said) == 1
