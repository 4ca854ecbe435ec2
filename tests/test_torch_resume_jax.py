"""Resume in the PyTorch port from the JAX package's ``last`` checkpoint
(``train.msgpack`` + ``weights.msgpack`` + ``meta.yaml``).

The optax state against the torch optimizer's, on a tiny detector (Conv
+ Detect, all three parameter groups): the JAX transform runs a few
updates on seeded gradients and is saved in flax's msgpack; the port loads
it into its optimizer; one more update on both sides from the same
gradient gives the same parameters within 1e-6. SGD (momentum, nesterov)
and Adam, each with and without accumulation (mid-accumulation, so the
summed gradients carry). The JAX-layout writer that ``chip_smoke.py``
uses on the card (``tests/torch_jax_checkpoint.py``) writes the loaded
state back leaf for leaf as JAX saved it: arrays and counts exactly, the
logged lr / momentum within 1e-6 relative (the JAX package computes them
in float32).

The flagship's JAX ``last`` resumed for one more epoch against the JAX
trainer is ``test_torch_resume_jax_trainer.py``: the two halves run on two
workers under ``--dist loadfile``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from test_torch_weights import FLAGSHIP, jax_shapes, randomize
from torch_jax_checkpoint import opt_state_tree, serialize
from yolo_ad_refine_tpu.train.optim import build_optimizer as jax_build_optimizer
from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
from yolo_ad_refine_tpu_torch.engine.checkpoint import read_flax_msgpack
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.train.optim import build_optimizer, load_jax_opt_state
from yolo_ad_refine_tpu_torch.train.trainer import DetectionTrainer
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, jax_to_port, load_jax_variables

TINY = {"nc": 3,
        "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                     [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [64, 3, 2]],
                     [-1, 1, "Conv", [64, 3, 2]]],
        "head": [[[2, 3, 4], 1, "Detect", ["nc"]]]}
IMGSZ, NC = 128, 3
HYPER_KEYS = ("hyperparams/lr", "hyperparams/mom")  # logged in float32 by the JAX schedules


def assert_same_tree(got: dict, want: dict):
    """Flattened flax trees: the same leaves, equal (dtype and shape too);
    the logged lr / momentum within 1e-6 relative."""
    got, want = flatten_tree(got), flatten_tree(want)
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))[:10]
    for k, w in want.items():
        g = got[k]
        assert np.asarray(g).dtype == np.asarray(w).dtype and np.shape(g) == np.shape(w), k
        if k.endswith(HYPER_KEYS):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _decoded(tmp_path, tree, name):
    """A tree as the JAX package writes it (np.asarray leaves through flax's
    msgpack), decoded by the port's reader."""
    f = tmp_path / name
    f.write_bytes(serialization.msgpack_serialize(jax.tree.map(np.asarray, tree)))
    return read_flax_msgpack(f)


@pytest.mark.parametrize("optimizer,batch", [("SGD", 64), ("SGD", 32), ("AdamW", 64),
                                             ("AdamW", 32)])
def test_optax_state_carries_into_the_torch_optimizer(optimizer, batch, tmp_path):
    """batch 32 of nbs 64: accumulate 2, saved after 5 batches (2 steps and
    one batch of a third); batch 64: accumulate 1, after 3 steps."""
    variables = randomize(jax_shapes(TINY, 64)[1], seed=3)
    params = jax.tree.map(jnp.asarray, variables["params"])
    kw = dict(optimizer=optimizer, lr0=0.02, momentum=0.9, weight_decay=0.0005, epochs=2, nb=4,
              batch=batch, nbs=64, warmup_epochs=0.5, nc=3)
    tx, acc, _ = jax_build_optimizer(params, **kw)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(7)
    grad = lambda: jax.tree.map(  # noqa: E731
        lambda p: jnp.asarray(rng.normal(0, 0.05, p.shape), jnp.float32), params)
    n = 5 if acc > 1 else 3
    for _ in range(n):
        updates, opt_state = update(grad(), opt_state, params)
        params = optax.apply_updates(params, updates)
    saved = _decoded(tmp_path, serialization.to_state_dict(opt_state), "opt.msgpack")

    port = DetectionModel(TINY)
    load_jax_variables(port, flatten_tree(jax.device_get(params)),
                       flatten_tree(variables["batch_stats"]))
    opt, acc_port, _ = build_optimizer(port.named_parameters(), **kw)
    assert acc_port == acc
    opt.batches = n
    load_jax_opt_state(opt, saved, port)
    assert opt.steps == n // acc
    assert_same_tree(opt_state_tree(opt, port), saved)

    g = grad()
    updates, opt_state = update(g, opt_state, params)
    params = optax.apply_updates(params, updates)
    g_port = jax_to_port(port, flatten_tree(jax.device_get(g)), collections=("params",))
    for name, p in port.named_parameters():
        gp = torch.from_numpy(g_port[name])
        p.grad = gp if p.grad is None else p.grad + gp
    assert opt.step()
    want = jax_to_port(port, flatten_tree(jax.device_get(params)), collections=("params",))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-6, rtol=1e-5,
                                   err_msg=name)


def test_a_state_that_does_not_fit_warns_and_starts_fresh(tmp_path):
    """An Adam state into an SGD optimizer: the JAX package warns and
    restarts the optimizer (its engine/checkpoint.py:145-150); so does the
    port, and nothing of the state is loaded."""
    from yolo_ad_refine_tpu_torch.engine.checkpoint import _load_jax_train_state
    from yolo_ad_refine_tpu_torch.train.optim import ModelEMA

    variables = jax.tree.map(jnp.asarray, randomize(jax_shapes(TINY, 64)[1], seed=4))
    tx, _, _ = jax_build_optimizer(variables["params"], optimizer="AdamW", batch=64, nc=3)
    blob = {"variables": variables, "step": np.asarray(3, np.int32),
            "ema_updates": np.asarray(3.0, np.float32),
            "opt_state": serialization.to_state_dict(tx.init(variables["params"]))}
    (tmp_path / "train.msgpack").write_bytes(
        serialization.msgpack_serialize(jax.tree.map(np.asarray, blob)))
    (tmp_path / "weights.msgpack").write_bytes(
        serialization.msgpack_serialize(jax.tree.map(np.asarray, variables)))
    port = DetectionModel(TINY)
    opt, _, _ = build_optimizer(port.named_parameters(), optimizer="SGD", batch=64, nc=3)
    ema = ModelEMA(port)
    _load_jax_train_state(tmp_path, port, ema, opt)
    assert not opt.opt.state and opt.steps == 0
    assert opt.batches == 3 and ema.updates == 3


def test_param_groups_are_the_jax_labels_of_the_flax_leaves():
    """Every flagship parameter in the group the JAX package gives its flax
    leaf (its train/optim.py param_group_label), AdaptiveDynamicTanh's
    alphas too, which the port holds as (1, ns, 1, 1)."""
    from yolo_ad_refine_tpu.train.optim import param_group_label as jax_label
    from yolo_ad_refine_tpu_torch.train.optim import param_group_label
    from yolo_ad_refine_tpu_torch.utils.jax_weights import jax_leaf_map

    _, shapes = jax_shapes(FLAGSHIP, IMGSZ)
    labels = flatten_tree(jax.tree_util.tree_map_with_path(jax_label, shapes["params"]))
    port = DetectionModel(FLAGSHIP)
    named = dict(port.named_parameters())
    checked = 0
    for name, _, targets in jax_leaf_map(port):
        if name in named:
            assert {labels[key] for _, key, _, _ in targets} == {
                param_group_label(name, named[name])}, name
            checked += 1
    assert checked == len(named)


def test_missing_train_msgpack_raises(tmp_path):
    data = make_shapes_dataset(tmp_path / "ds", n_train=2, n_val=1, imgsz=64, seed=1)
    last = tmp_path / "last"
    last.mkdir()
    (last / "meta.yaml").write_text("epoch: 0\n")
    t = DetectionTrainer({"model": TINY, "data": data, "epochs": 1, "batch": 2, "imgsz": 64,
                          "plots": False, "project": str(tmp_path), "device": "cpu",
                          "resume": str(last)})
    with pytest.raises(FileNotFoundError, match="resume checkpoint"):
        t._setup()


def test_serialize_matches_flax():
    """The writer's msgpack encoding is flax's, byte for byte."""
    tree = {"a": {"k": np.arange(6, dtype=np.float32).reshape(2, 3), "e": {}},
            "s": np.asarray(3, np.int32)}
    assert serialize(tree) == serialization.msgpack_serialize(tree)
