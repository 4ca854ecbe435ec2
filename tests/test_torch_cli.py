"""The PyTorch port's command line (``yolo_ad_refine_tpu_torch/cfg/cli.py``):
each mode through ``entrypoint`` in this process on ``device=cpu`` with a
small model (five convs and Detect, or OBB) at imgsz 64 on a seeded
shapes set, and ``python -m yolo_ad_refine_tpu_torch`` in subprocesses:
``version``, and ``checks`` and ``settings`` under an import blocker that
refuses JAX. Everything is written under pytest's tmp_path (``settings``
under a HOME of its own)."""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from yolo_ad_refine_tpu_torch import __version__
from yolo_ad_refine_tpu_torch.cfg import cli
from yolo_ad_refine_tpu_torch.cfg.cli import entrypoint, parse_kv
from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
from yolo_ad_refine_tpu_torch.utils import benchmarks, settings, yaml_load, yaml_save

REPO = Path(__file__).resolve().parents[1]
TINY = {
    "nc": 3,
    "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [64, 3, 2]],
                 [-1, 1, "Conv", [64, 3, 2]]],
    "head": [[[2, 3, 4], 1, "Detect", ["nc"]]],
}
BLOCKER = """
import sys
class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "yolo_ad_refine_tpu"):
            raise ImportError(f"blocked import of {name}")
sys.meta_path.insert(0, Blocker())
from yolo_ad_refine_tpu_torch.cfg.cli import entrypoint
raise SystemExit(entrypoint(sys.argv[1:]))
"""


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`detect train` of the small model for one epoch; returns the paths."""
    tmp = tmp_path_factory.mktemp("cli")
    yaml_save(tmp / "tiny.yaml", TINY)
    yaml_save(tmp / "tiny_obb.yaml", {**TINY, "head": [[[2, 3, 4], 1, "OBB", ["nc", 1]]]})
    data = make_shapes_dataset(tmp / "ds", n_train=4, n_val=2, imgsz=64, seed=4)
    assert entrypoint(["detect", "train", f"model={tmp / 'tiny.yaml'}", f"data={data}",
                       "epochs=1", "batch=2", "imgsz=64", "device=cpu", "plots=False",
                       "workers=2", f"project={tmp / 'runs'}", "name=train"]) == 0
    return tmp, data, tmp / "runs" / "train"


def test_train_writes_the_run(trained):
    _, _, run = trained
    assert (run / "results.csv").read_text().count("\n") == 2
    assert (run / "weights" / "best" / "weights.pt").exists()
    assert yaml_load(run / "args.yaml")["imgsz"] == 64


def logged(monkeypatch, module) -> list:
    """The messages ``module`` logs with LOGGER.info."""
    msgs = []
    monkeypatch.setattr(module, "LOGGER", SimpleNamespace(info=lambda m: msgs.append(str(m))))
    return msgs


def test_val_on_best(trained, monkeypatch):
    tmp, data, run = trained
    msgs = logged(monkeypatch, cli)
    assert entrypoint(["detect", "val", f"model={run / 'weights' / 'best'}", f"data={data}",
                       "imgsz=64", "batch=2", "device=cpu"]) == 0
    assert msgs[0].startswith("results: ") and "'metrics/mAP50(B)'" in msgs[0]


def test_predict_saves(trained):
    tmp, _, run = trained
    src = tmp / "imgs"
    src.mkdir()
    for i in range(2):
        cv2.imwrite(str(src / f"im{i}.jpg"),
                    np.random.default_rng(i).integers(0, 256, (48, 64, 3), dtype=np.uint8))
    assert entrypoint(["predict", f"model={run / 'weights' / 'best'}", f"source={src}",
                       "imgsz=64", "conf=0.0", "device=cpu", "save_txt=True",
                       f"project={tmp / 'pred'}"]) == 0
    out = tmp / "pred" / "predict"
    assert sorted(p.name for p in out.glob("*.jpg")) == ["im0.jpg", "im1.jpg"]
    assert len(list((out / "labels").glob("*.txt"))) == 2


def test_task_comes_from_the_head(trained, capsys):
    """No task given: the OBB head decides (the JAX CLI would pass detect)."""
    tmp, _, _ = trained
    img = tmp / "one.jpg"
    cv2.imwrite(str(img), np.zeros((64, 64, 3), np.uint8))
    assert entrypoint(["predict", f"model={tmp / 'tiny_obb.yaml'}", f"source={img}",
                       "imgsz=64", "device=cpu", "save=False"]) == 0
    with pytest.raises(ValueError, match="task='detect' does not fit"):
        entrypoint(["detect", "predict", f"model={tmp / 'tiny_obb.yaml'}", f"source={img}",
                    "imgsz=64", "device=cpu"])


def test_tune_mode(trained):
    tmp, data, _ = trained
    assert entrypoint(["detect", "tune", f"model={tmp / 'tiny.yaml'}", f"data={data}",
                       "iterations=2", "epochs=1", "batch=2", "imgsz=64", "device=cpu",
                       "workers=2", f"project={tmp / 'tune_runs'}"]) == 0
    tune = tmp / "tune_runs" / "tune"
    assert (tune / "tune_results.csv").read_text().count("\n") == 3
    assert (tune / "best_hyperparameters.yaml").exists()


def test_benchmark_mode(trained, monkeypatch):
    tmp, _, run = trained
    msgs = logged(monkeypatch, benchmarks)
    assert entrypoint(["benchmark", f"model={run / 'weights' / 'best'}", "imgsz=64", "batch=2",
                       "device=cpu", f"save_dir={tmp / 'export'}"]) == 0
    assert [m.split(", 'ms_per_image'")[0] for m in msgs] == [
        f"{{'format': '{fmt}', 'status': 'ok'" for fmt in ("checkpoint", "torch_export",
                                                            "torchscript")]
    assert (tmp / "export" / "model_torch_export.pt2").exists()


def test_cfg_help_and_bad_arguments(capsys):
    assert entrypoint(["cfg"]) == 0
    assert "lr0:" in capsys.readouterr().out
    assert entrypoint(["help"]) == 0
    assert "yat-torch detect train" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="expected a mode"):
        entrypoint(["detect", "export"])
    with pytest.raises(SystemExit, match="not key=value"):
        entrypoint(["detect", "val", "imgsz"])
    assert parse_kv(["a=1", "b=x", "c=[1, 2]", "d=True"]) == {"a": 1, "b": "x", "c": [1, 2],
                                                            "d": True}


def test_settings_mode(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(settings, "_settings", settings.SettingsManager(tmp_path / "s.json"))
    assert entrypoint(["settings", "wandb=True"]) == 0
    assert "wandb: True" in capsys.readouterr().out
    assert yaml_load(tmp_path / "s.json")["wandb"] is True  # JSON is yaml
    with pytest.raises(TypeError, match="must be bool"):
        entrypoint(["settings", "wandb=1"])
    with pytest.raises(KeyError, match="unknown setting"):
        entrypoint(["settings", "nope=1"])
    assert entrypoint(["settings", "reset=True"]) == 0
    assert yaml_load(tmp_path / "s.json")["wandb"] is False


def test_settings_file_resets_on_a_schema_mismatch(tmp_path):
    f = tmp_path / "s.json"
    f.write_text('{"settings_version": "0.0.1"}')
    s = settings.SettingsManager(f)
    assert s["settings_version"] == "0.0.6" and set(yaml_load(f)) == set(s.defaults)
    assert str(settings.SETTINGS_FILE).endswith(".config/yolo_ad_refine_tpu_torch/settings.json")


def test_module_entry_point_version():
    out = subprocess.run([sys.executable, "-m", "yolo_ad_refine_tpu_torch", "version"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == __version__


@pytest.mark.parametrize("argv,want", [
    (["checks"], ["torch ", "kernel   deform_conv", "kernel   nms"]),
    (["settings", "runs_dir=/tmp/r"], ["runs_dir: /tmp/r", "sync: False"]),
])
def test_checks_and_settings_never_import_jax(tmp_path, argv, want):
    env = {**os.environ, "HOME": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", BLOCKER, *argv], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    for w in want:
        assert w in out.stdout
    if argv[0] == "checks":
        assert "cuda     not available" in out.stdout
    else:
        assert (tmp_path / ".config" / "yolo_ad_refine_tpu_torch" / "settings.json").exists()
