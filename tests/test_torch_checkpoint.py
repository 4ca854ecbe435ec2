"""Checkpoints and resume of the PyTorch port's trainer, on the CPU with the
small stock yolo11n at imgsz 64: a checkpoint directory carries the JAX
package's meta.yaml keys and reloads to the same weights; resume restores
the weights, optimizer, EMA and counters and seeds the run's
dcn_offset_max from meta.yaml (ROADMAP Queue 3). A checkpoint the JAX
package wrote loads into the port, and a checkpoint's dcn_offset_max widens
the DCN radius, whichever package wrote it."""

import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
from yolo_ad_refine_tpu_torch.engine.checkpoint import load_checkpoint
from yolo_ad_refine_tpu_torch.train.trainer import DetectionTrainer

JAX_META_KEYS = ["model_yaml", "nc", "dcn_offset_max", "names", "epoch", "best_fitness",
                 "train_args", "date", "version"]  # yolo_ad_refine_tpu/engine/checkpoint.py:59-73


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    data = make_shapes_dataset(tmp / "ds", n_train=4, n_val=2, imgsz=64, seed=2)
    args = {"model": "yolo11n.yaml", "data": data, "epochs": 1, "batch": 2, "imgsz": 64,
            "plots": False, "device": "cpu", "project": str(tmp / "runs"), "workers": 2,
            "nbs": 2}  # an optimizer step every batch
    trainer = DetectionTrainer(args)
    trainer.train()
    return trainer, args


def test_checkpoint_meta_and_reload(run):
    trainer, _ = run
    last = trainer.wdir / "last"
    meta = yaml.safe_load((last / "meta.yaml").read_text())
    assert list(meta) == JAX_META_KEYS
    assert meta["epoch"] == 0 and meta["nc"] == 3 and meta["names"] == {0: "disc", 1: "box",
                                                                         2: "tri"}
    model = load_checkpoint(last, "cpu")
    ema = trainer.ema.ema.state_dict()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, ema[k], rtol=0, atol=0)
    assert model.strides == (8, 16, 32) and not model.training


def test_resume_restores_state_and_seeds_offset_max(run):
    trainer, args = run
    last = trainer.wdir / "last"
    meta = yaml.safe_load((last / "meta.yaml").read_text())
    meta["dcn_offset_max"] = 7.5
    (last / "meta.yaml").write_text(yaml.safe_dump(meta, sort_keys=False))
    resumed = DetectionTrainer({**args, "epochs": 2, "resume": str(last),
                                "project": str(trainer.save_dir.parent / "resumed")})
    resumed._setup()
    assert resumed.start_epoch == 1 and resumed.dcn_offset_max_run == 7.5
    assert resumed.optimizer.batches == trainer.optimizer.batches == 2
    assert resumed.optimizer.steps == 2 and resumed.ema.updates == trainer.ema.updates == 2
    state = resumed.optimizer.opt.state_dict()["state"]
    want = trainer.optimizer.opt.state_dict()["state"]
    assert len(state) == len(want) > 0
    for i, s in want.items():
        torch.testing.assert_close(state[i]["exp_avg"], s["exp_avg"], rtol=0, atol=0)
    raw = trainer.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), raw[k].numpy())


TINY_AY = {  # tests/test_dcn_radius.py's model: five convs and the flagship's head
    "nc": 3,
    "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [128, 3, 2]],
                 [-1, 1, "Conv", [256, 3, 2]]],
    "head": [[[2, 3, 4], 1, "AYHead", ["nc"]]],
}


def _jax_checkpoint(path, cfg, imgsz, seed, dcn_offset_max=None):
    """A checkpoint directory the JAX package's save_checkpoint writes, with
    numpy-randomised variables; returns the JAX model."""
    from test_torch_weights import jax_shapes, randomize
    from yolo_ad_refine_tpu.engine.checkpoint import save_checkpoint as jax_save

    jm, shapes = jax_shapes(cfg, imgsz)
    jm.variables = jax.tree.map(jnp.asarray, randomize(shapes, seed=seed))
    jax_save(path, model=jm, train_args={"imgsz": imgsz}, dcn_offset_max=dcn_offset_max)
    return jm


def test_jax_checkpoint_loads_into_the_port():
    """The flagship at 128 written by the JAX package: ``YOLO(dir)`` reads
    weights.msgpack with msgpack alone, through the strict loader, and the
    eval outputs match the JAX model's within 1e-4 (test_torch_slice.py's
    tolerance)."""
    from test_torch_weights import FLAGSHIP
    from yolo_ad_refine_tpu_torch import YOLO

    with tempfile.TemporaryDirectory() as tmp:
        jm = _jax_checkpoint(Path(tmp) / "ck", FLAGSHIP, 128, seed=5)
        assert (Path(tmp) / "ck" / "weights.msgpack").exists()
        model = YOLO(str(Path(tmp) / "ck"), device="cpu").model
    x = np.random.default_rng(4).random((1, 128, 128, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False)[0])(jm.variables,
                                                                          jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = model(xt)[0].numpy()
    assert model.strides == (8, 16, 32) and not model.training
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_flax_msgpack_reader_refuses_chunked_arrays(tmp_path):
    import msgpack

    from yolo_ad_refine_tpu_torch.engine.checkpoint import read_flax_msgpack

    blob = {"params": {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 1}, "chunks": {}}}}
    (tmp_path / "weights.msgpack").write_bytes(msgpack.packb(blob))
    with pytest.raises(ValueError, match="chunked"):
        read_flax_msgpack(tmp_path / "weights.msgpack")


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("offset_max,radius", [(18.0, 19.0), (1.4, 3.0)])
def test_checkpoint_offset_max_widens_the_radius(tmp_path, writer, offset_max, radius):
    """As tests/test_dcn_radius.py:39-58 for the JAX package: dcn_offset_max
    18 -> ceil(18) + 1 = 19; small offsets keep the yaml's 3."""
    from yolo_ad_refine_tpu_torch.engine.checkpoint import save_checkpoint
    from yolo_ad_refine_tpu_torch.models.model import DetectionModel

    if writer == "jax":
        _jax_checkpoint(tmp_path / "ck", TINY_AY, 64, seed=1, dcn_offset_max=offset_max)
    else:
        save_checkpoint(tmp_path / "ck", model=DetectionModel(TINY_AY),
                        train_args={"imgsz": 64}, dcn_offset_max=offset_max)
    model = load_checkpoint(tmp_path / "ck", "cpu")
    head = model.model[model.head_idx]
    assert head.dcn_radius == radius and head.DyDCNV2.radius == radius
