"""Resume in the PyTorch port from the JAX package's ``last`` of a real
training run: the flagship at the trainer-parity size (imgsz 128, batch 2,
6 train images; nbs 4, so accumulate 2 and the saved ``last`` is
mid-accumulation). The JAX trainer trains 2 epochs with SGD and its
``last`` after epoch 0 is kept; the port resumes from it: weights, EMA,
counters, best fitness and dcn_offset_max equal the JAX state, the
JAX-layout writer (``tests/torch_jax_checkpoint.py``) reproduces the JAX
files leaf for leaf, and the port's epoch 1 matches the JAX trainer's
epoch 1 within the trainer parity's 1e-4 relative. The optimizer-state
cases are ``test_torch_resume_jax.py``.
"""

import csv
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_resume_jax import IMGSZ, NC, assert_same_tree
from test_torch_weights import FLAGSHIP, jax_shapes, randomize
from torch_jax_checkpoint import write_jax_last
from yolo_ad_refine_tpu.models.model import DetectionModel as JaxDetectionModel
from yolo_ad_refine_tpu.train.trainer import DetectionTrainer as JaxTrainer
from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
from yolo_ad_refine_tpu_torch.engine.checkpoint import read_flax_msgpack
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.train.trainer import DetectionTrainer
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, jax_to_port, load_jax_variables


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX trainer for 2 epochs (its last after epoch 0 kept), and the
    port resumed from that last for the second."""
    tmp = tmp_path_factory.mktemp("resume_jax")
    data = make_shapes_dataset(tmp / "ds", n_train=6, n_val=2, imgsz=IMGSZ, seed=6)
    cfg = dict(JaxDetectionModel(FLAGSHIP).yaml, nc=NC)
    jm, shapes = jax_shapes(cfg, IMGSZ)
    variables = randomize(shapes, seed=31)
    jm.variables = jax.tree.map(jnp.asarray, variables)
    jm.strides = (8, 16, 32)
    args = {"data": data, "epochs": 2, "batch": 2, "nbs": 4, "imgsz": IMGSZ, "plots": False,
            "max_boxes": 16, "workers": 2, "val": False, "optimizer": "SGD"}
    jt = JaxTrainer({**args, "project": str(tmp / "jax")}, model=jm)
    kept = tmp / "jax_last_epoch0"

    def keep(trainer):  # the JAX package's save_checkpoint of the state after epoch 0
        if trainer.current_epoch == 0:
            shutil.copytree(trainer.wdir / "last", kept)

    jt.callbacks.add("on_model_save", keep)
    want = jt.train()

    port = DetectionModel(FLAGSHIP, nc=NC)
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    port.probe_strides(IMGSZ)
    pt = DetectionTrainer({**args, "resume": str(kept), "project": str(tmp / "port")}, model=port)
    pt._setup()
    resumed = {"start_epoch": pt.start_epoch, "best_fitness": pt.best_fitness,
               "dcn_offset_max_run": pt.dcn_offset_max_run, "batches": pt.optimizer.batches,
               "steps": pt.optimizer.steps, "ema_updates": pt.ema.updates,
               "model": {k: v.clone() for k, v in pt.model.state_dict().items()},
               "ema": {k: v.clone() for k, v in pt.ema.ema.state_dict().items()},
               "grads": {n: None if p.grad is None else p.grad.clone()
                         for n, p in pt.model.named_parameters()}}
    write_jax_last(tmp / "port_written", model=pt.model, ema=pt.ema, optimizer=pt.optimizer,
                   epoch=0, best_fitness=pt.best_fitness, names=pt.data["names"],
                   dcn_offset_max=pt.dcn_offset_max_run, train_args=pt.args)
    pt._setup = lambda: None  # train() from the state just checked
    got = pt.train()
    return {"tmp": tmp, "kept": kept, "resumed": resumed, "port": pt, "got": got, "want": want}


def test_resumed_state_is_the_jax_state(runs):
    r, kept = runs["resumed"], runs["kept"]
    blob = read_flax_msgpack(kept / "train.msgpack")
    meta = __import__("yaml").safe_load((kept / "meta.yaml").read_text())
    assert r["start_epoch"] == 1 == meta["epoch"] + 1
    assert r["best_fitness"] == meta["best_fitness"]
    assert r["dcn_offset_max_run"] == pytest.approx(meta["dcn_offset_max"], rel=1e-12)
    assert r["dcn_offset_max_run"] > 0
    assert r["batches"] == int(blob["step"]) == 3
    assert r["steps"] == 1  # accumulate 2: one step, and the third batch's gradient carried
    assert r["ema_updates"] == int(blob["ema_updates"]) == 1
    port = runs["port"].model
    for key, state in (("model", blob["variables"]),
                       ("ema", read_flax_msgpack(kept / "weights.msgpack"))):
        want = jax_to_port(port, flatten_tree(state["params"]), flatten_tree(state["batch_stats"]))
        for name, v in want.items():
            np.testing.assert_array_equal(r[key][name].numpy(), v, err_msg=f"{key} {name}")
    grads = [g for g in r["grads"].values() if g is not None]
    assert len(grads) == len(r["grads"]) and any(float(g.abs().sum()) > 0 for g in grads)


def test_writer_reproduces_the_jax_files_leaf_for_leaf(runs):
    """What the card's phase writes from a port state decodes as what the
    JAX package's save_checkpoint wrote for the same state."""
    ours, theirs = runs["tmp"] / "port_written", runs["kept"]
    for f in ("train.msgpack", "weights.msgpack"):
        assert_same_tree(read_flax_msgpack(ours / f), read_flax_msgpack(theirs / f))


def test_one_more_epoch_matches_the_jax_trainer(runs):
    def rows(path):
        with open(path) as f:
            return list(csv.DictReader(f))

    got = rows(Path(runs["got"]["save_dir"]) / "results.csv")
    want = rows(Path(runs["want"]["save_dir"]) / "results.csv")
    assert [r["epoch"] for r in got] == ["1"] and len(want) == 2
    for k in ("train/box_loss", "train/cls_loss", "train/dfl_loss"):
        a, b = float(got[0][k]), float(want[1][k])
        assert abs(a - b) <= 1e-4 * abs(b), (k, a, b)
    for k in ("lr/pg0", "lr/pg1", "lr/pg2"):
        assert float(got[0][k]) == pytest.approx(float(want[1][k]), rel=1e-5)
    assert runs["port"].optimizer.batches == 6 and runs["port"].optimizer.steps == 3
