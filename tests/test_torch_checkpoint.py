"""Checkpoints and resume of the PyTorch port's trainer, on the CPU with the
small stock yolo11n at imgsz 64: a checkpoint directory carries the JAX
package's meta.yaml keys and reloads to the same weights; resume restores
the weights, optimizer, EMA and counters and seeds the run's
dcn_offset_max from meta.yaml (ROADMAP Queue 3)."""

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
