"""The trainer's integrations in the PyTorch port against the JAX package's:
``metrics.jsonl`` line for line, TensorBoard event files where the
``tensorboard`` package imports, and the settings that switch them off.
The settings live in pytest's temporary directory, as every file written
here does.
"""

import json

import numpy as np
import pytest
import torch

from yolo_ad_refine_tpu.utils.callbacks import tracker_callbacks as jax_tracker_callbacks
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
from yolo_ad_refine_tpu_torch.utils import callbacks, settings, yaml_save

TINY = {
    "nc": 3,
    "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "Conv", [32, 3, 2]]],
    "head": [[[2, 3, 4], 1, "Detect", ["nc"]]],
}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def own_settings(tmp_path, monkeypatch):
    s = settings.SettingsManager(tmp_path / "settings.json")
    monkeypatch.setattr(settings, "_settings", s)
    return s


class Trainer:
    """What the hooks read of a trainer."""

    def __init__(self, save_dir):
        self.args = {"lr0": 0.01, "epochs": 2, "model": "tiny.yaml", "amp": True,
                     "multi_scale": None, "names": [0, 1]}
        self.save_dir = save_dir
        self.current_epoch = 0
        self.last_epoch_scalars = {"train/box_loss": 1.5, "metrics/mAP50(B)": 0.25}


def _drive(hooks, trainer):
    hooks["on_train_start"](trainer)
    for epoch, loss in enumerate((1.5, 1.2)):
        trainer.current_epoch = epoch
        trainer.last_epoch_scalars = {"train/box_loss": loss, "metrics/mAP50(B)": 0.25 * epoch}
        hooks["on_fit_epoch_end"](trainer)
    hooks["on_train_end"](trainer)


def test_jsonl_equals_the_jax_trackers_line_for_line(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    (run / "results.csv").write_text("epoch\n")
    (run / "args.yaml").write_text("lr0: 0.01\n")
    outs = []
    for name, make in (("jax", jax_tracker_callbacks), ("port", callbacks.tracker_callbacks)):
        d = tmp_path / name
        d.mkdir()
        _drive(make("jsonl", str(d)), Trainer(run))
        outs.append((d / "metrics.jsonl").read_text().splitlines())
    assert outs[0] == outs[1] and len(outs[0]) == 4
    lines = [json.loads(x) for x in outs[1]]
    assert lines[0]["params"] == {"lr0": 0.01, "epochs": 2, "model": "tiny.yaml", "amp": True}
    assert [x["step"] for x in lines[1:3]] == [0, 1]
    assert lines[2]["metrics"]["train/box_loss"] == 1.2
    assert lines[3]["artifacts"] == [str(run / "results.csv"), str(run / "args.yaml")]


def test_absent_packages_are_skipped():
    for name in ("wandb", "comet", "clearml", "dvc", "neptune"):
        assert callbacks.tracker_callbacks(name, "unused") == {}
    assert callbacks.mlflow_callbacks("unused") == {}  # mlflow is not installed here


def _events(path):
    """The Event protos of a TensorBoard event file (TFRecord framing:
    length, its crc, the data, its crc)."""
    import struct

    from tensorboard.compat.proto.event_pb2 import Event

    data, out = path.read_bytes(), []
    while data:
        (n,) = struct.unpack("<Q", data[:8])
        out.append(Event.FromString(data[12:12 + n]))
        data = data[16 + n:]
    assert out[0].file_version == "brain.Event:2"
    return out


def _train(tmp_path, name):
    yaml_save(tmp_path / "tiny.yaml", TINY)
    data = make_shapes_dataset(tmp_path / "ds", n_train=2, n_val=2, imgsz=64, seed=1)
    m = YOLO(str(tmp_path / "tiny.yaml"), device="cpu", imgsz=64)
    r = m.train(data=data, epochs=2, batch=2, imgsz=64, project=str(tmp_path / "runs"),
                name=name, plots=False, warmup_epochs=0.0)
    return m, r


def test_training_writes_metrics_jsonl_and_event_files(tmp_path, own_settings):
    """The default settings: metrics.jsonl with one line an epoch, holding
    the epoch's scalars, and TensorBoard's event files in the run."""
    import importlib.util

    m, r = _train(tmp_path, "on")
    save_dir = tmp_path / "runs" / "on"
    assert r["save_dir"] == str(save_dir)
    lines = [json.loads(x) for x in (save_dir / "metrics.jsonl").read_text().splitlines()]
    assert [x["event"] for x in lines] == ["start", "epoch", "epoch", "end"]
    assert lines[0]["params"]["epochs"] == 2 and lines[2]["step"] == 1
    assert lines[2]["metrics"]["train/box_loss"] == pytest.approx(
        m.trainer.last_epoch_scalars["train/box_loss"])
    assert np.isfinite(lines[1]["metrics"]["metrics/mAP50(B)"])
    events = list(save_dir.glob("events.out.tfevents.*"))
    assert len(events) == (1 if importlib.util.find_spec("tensorboard") else 0)
    if events:
        steps = [(e.step, {v.tag: v.simple_value for v in e.summary.value})
                 for e in _events(events[0]) if e.summary.value]
        assert [st for st, _ in steps] == [0, 1]
        assert steps[1][1]["train/box_loss"] == pytest.approx(lines[2]["metrics"]["train/box_loss"])
    assert (tmp_path / "settings.json").exists()


def test_settings_switch_the_integrations_off(tmp_path, own_settings):
    own_settings.update(tensorboard=False, jsonl=False, mlflow=False)
    _train(tmp_path, "off")
    save_dir = tmp_path / "runs" / "off"
    assert (save_dir / "results.csv").exists()
    assert not (save_dir / "metrics.jsonl").exists()
    assert not list(save_dir.glob("events.out.tfevents.*"))


def test_callbacks_of_the_facade_are_not_shared_by_runs(tmp_path, own_settings):
    """Each training adds its integrations to a copy of the facade's
    callbacks, so a second run's tracker writes only its own run."""
    m, _ = _train(tmp_path, "a")
    n_user = sum(len(v) for v in m.callbacks._callbacks.values())
    assert n_user == 0
    m.train(data=m.trainer.args["data"], epochs=1, batch=2, imgsz=64,
            project=str(tmp_path / "runs"), name="b", plots=False, warmup_epochs=0.0)
    a = (tmp_path / "runs" / "a" / "metrics.jsonl").read_text().splitlines()
    b = (tmp_path / "runs" / "b" / "metrics.jsonl").read_text().splitlines()
    assert len(a) == 4 and len(b) == 3
