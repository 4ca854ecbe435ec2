"""The PyTorch port stands alone: no JAX, no flax, nothing of the JAX package;
and its entry points run on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "yolo_ad_refine_tpu")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        # exact package names: yolo_ad_refine_tpu_torch is not yolo_ad_refine_tpu
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
import yolo_ad_refine_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke  # its own imports; the port's are inside its phases
sys.path.insert(0, "tests")
import torch_jax_checkpoint  # chip_smoke's JAX-layout writer: the card has no JAX
import torch_parallel_worker  # chip_smoke's data-parallel ranks
import torch_dropout_masks  # chip_smoke's shared dropout masks
import examples_torch
examples = [m.name for m in pkgutil.iter_modules(examples_torch.__path__, "examples_torch.")]
for n in examples:
    importlib.import_module(n)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(" ".join(examples))
print(" ".join(names))
"""
EXAMPLES = ("action_recognition", "check_ckpt", "detect", "region_counter",
            "sahi_tiled_inference", "train11", "val")

# the train slice's, the bounded-DCN slice's, the training options', the OBB
# training and export slice's, the CLI / tune / benchmark / data-parallel
# slice's, the classify / YOLOv10 / YOLO-World slice's, the RT-DETR / ATSS
# slice's, the zoo / tracking slice's, the module library's, the SAM
# family's and the periphery's modules, each imported under the blocker above
TRAIN_SLICE_MODULES = (
    "__main__", "cfg.cli", "cfg.config", "data.augment", "data.build", "data.dataset",
    "data.synthetic", "engine.checkpoint", "engine.exporter", "engine.track", "engine.tuner",
    "engine.validator", "models.fastsam", "models.nas", "models.sam", "models.sam.model",
    "models.sam.modules", "models.sam.sam2", "models.sam.sam2_modules",
    "models.sam.tiny_encoder", "nn.attention", "nn.attention_zoo", "nn.conv_extras", "nn.dsan",
    "nn.transformer", "ops.anchors", "ops.deform", "ops.deform_mxu", "ops.deform_pallas",
    "ops.dscn", "ops.iou", "ops.lap", "parallel",
    "parallel.multihost", "train.atss", "train.classify", "train.loss", "train.obb",
    "train.optim", "train.rtdetr", "train.step", "train.tal", "train.trainer", "trackers",
    "trackers.bot_sort", "trackers.byte_tracker", "trackers.gmc", "trackers.kalman",
    "utils.autobatch", "utils.benchmarks", "utils.callbacks", "utils.checks", "utils.metrics",
    "utils.plotting", "utils.settings", "utils.text", "utils.triton",
    "data.annotator", "data.converter", "data.explorer", "data.loaders", "data.split_dota",
    "hub", "ops.native", "solutions", "solutions.ai_gym", "solutions.analytics",
    "solutions.base", "solutions.distance_calculator", "solutions.heatmap",
    "solutions.inference_app", "solutions.object_counter", "solutions.parking_manager",
    "solutions.queue_manager", "solutions.speed_estimator",
)


def test_port_imports_nothing_of_jax():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 40  # every module was imported
    missing = [m for m in TRAIN_SLICE_MODULES if f"yolo_ad_refine_tpu_torch.{m}" not in names]
    assert not missing, missing
    examples = set(out.stdout.strip().splitlines()[-2].split())
    assert examples == {f"examples_torch.{m}" for m in EXAMPLES}


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_script_imports_nothing_of_jax(name):
    """Every import of an example script, those inside its functions too
    (which run only when its main runs), is of neither JAX, flax, optax nor
    the JAX package."""
    import ast

    tree = ast.parse((REPO / "examples_torch" / f"{name}.py").read_text())
    roots = {a.name.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names}
    roots |= {(node.module or "").split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)}
    assert "yolo_ad_refine_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "optax", "yolo_ad_refine_tpu"}, roots


def test_importing_native_builds_nothing():
    """``ops/native.py`` compiles at first use, never at import: importing
    it, the loaders that use it and the CLI starts no compiler and loads no
    library."""
    code = ("import subprocess, torch\n"
            "def refuse(*a, **k):\n    raise AssertionError(f'a process at import: {a}')\n"
            "subprocess.run = subprocess.Popen = refuse\n"
            "import yolo_ad_refine_tpu_torch.ops.native as native\n"
            "import yolo_ad_refine_tpu_torch.data.loaders, yolo_ad_refine_tpu_torch.cfg.cli\n"
            "import yolo_ad_refine_tpu_torch.ops, yolo_ad_refine_tpu_torch.solutions\n"
            "print(len(native._libs))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0"]


def test_default_cfg_is_a_byte_identical_copy():
    ours = REPO / "yolo_ad_refine_tpu_torch" / "cfg" / "default.yaml"
    assert ours.read_bytes() == (REPO / "yolo_ad_refine_tpu" / "cfg" / "default.yaml").read_bytes()


def test_yolo_without_device_raises_when_cuda_is_absent(monkeypatch):
    from yolo_ad_refine_tpu_torch import YOLO

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        YOLO("yolo11-701-YOLO-AD-Refine.yaml")


@pytest.mark.parametrize("cfg", ["yolo11n-cls.yaml", "yolov10n.yaml", "yolov8s-worldv2.yaml",
                                 "rtdetr-l.yaml"])
def test_slice_models_without_device_raise_when_cuda_is_absent(monkeypatch, cfg):
    from yolo_ad_refine_tpu_torch import YOLO

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        YOLO(cfg)


@pytest.mark.parametrize("entry", ["SAM", "SAM2Predictor", "SAM2VideoPredictor", "FastSAM"])
def test_sam_family_without_device_raises_when_cuda_is_absent(monkeypatch, entry):
    from yolo_ad_refine_tpu_torch import FastSAM
    from yolo_ad_refine_tpu_torch.models.sam import SAM
    from yolo_ad_refine_tpu_torch.models.sam.sam2 import SAM2Predictor, SAM2VideoPredictor

    build = {"SAM": lambda: SAM("sam_test", img_size=128),
             "SAM2Predictor": lambda: SAM2Predictor("sam2_test"),
             "SAM2VideoPredictor": lambda: SAM2VideoPredictor("sam2_test"),
             "FastSAM": lambda: FastSAM("yolov8-seg.yaml")}[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


def test_classification_trainer_without_device_raises_when_cuda_is_absent(monkeypatch):
    from yolo_ad_refine_tpu_torch.train.classify import ClassificationTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClassificationTrainer({"model": "yolo11n-cls.yaml", "data": "x"})


def test_build_detection_model_without_device_raises_when_cuda_is_absent(monkeypatch):
    from yolo_ad_refine_tpu_torch.models.model import build_detection_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_detection_model("yolo11-701-YOLO-AD-Refine.yaml")


def test_trainer_without_device_raises_when_cuda_is_absent(monkeypatch, tmp_path):
    from yolo_ad_refine_tpu_torch.train.trainer import DetectionTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DetectionTrainer({"data": "x.yaml", "plots": False, "project": str(tmp_path)})


@pytest.mark.parametrize("override,error,match", [
    # classify trains through its own trainer, which YOLO(...).train hands it to
    ({"task": "classify"}, ValueError, "train/classify.py ClassificationTrainer"),
    # no such task: YOLOv10, YOLO-World and RT-DETR models are 'detect'
    ({"task": "world"}, ValueError, "YOLO-World and RT-DETR models are 'detect'"),
])
def test_trainer_raises_on_options_not_ported(override, error, match, tmp_path):
    from yolo_ad_refine_tpu_torch.train.trainer import DetectionTrainer

    args = {"data": "x.yaml", "plots": False, "project": str(tmp_path), "device": "cpu"}
    with pytest.raises(error, match=match):
        DetectionTrainer({**args, **override})


@pytest.mark.parametrize("args,call,error,match", [
    ({"task": "classify"}, {}, ValueError, "train/classify.py validate"),
    ({"task": "obb"}, {"backend": object()}, NotImplementedError, "ROADMAP Queue 1 item"),
    ({"task": "segment"}, {"backend": object()}, NotImplementedError, "ROADMAP Queue 1 item"),
    ({"task": "pose"}, {"backend": object()}, NotImplementedError, "ROADMAP Queue 1 item"),
])
def test_validator_raises_on_options_not_ported(args, call, error, match):
    from yolo_ad_refine_tpu_torch.engine.validator import DetectionValidator

    with pytest.raises(error, match=match):
        DetectionValidator(args)(model=None, **call)


def test_profile_predict_raises_when_cuda_is_absent(monkeypatch):
    from yolo_ad_refine_tpu_torch.engine import profile_predict

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_predict.main([])


@pytest.mark.parametrize("name,family", [
    ("dcn_fwd_kernel<float>", "K1 dcn_forward"),
    ("void (anonymous namespace)::dcn_bwd_kernel<__nv_bfloat16>", "K1 dcn_backward"),
    ("void (anonymous namespace)::dcn_separable_forward_kernel<float>(float const*)",
     "K2 dcn_separable_forward"),
    ("dcn_separable_backward_kernel<__nv_bfloat16>", "K2 dcn_separable_backward"),
    ("void (anonymous namespace)::dcn_window_forward_kernel<float>(float const*)",
     "K3 dcn_window_forward"),
    ("dcn_window_backward_kernel<float>", "K3 dcn_window_backward"),
    ("nms_reduce_kernel", "K4 nms_suppress"),
    ("void (anonymous namespace)::lap_kernel(float const*, unsigned char const*, int*)",
     "LAP linear_sum_assignment"),
    ("void (anonymous namespace)::nms_mask_kernel(float const*, float const*, int, int, long "
     "long, float, float, unsigned long long*)", "K4 nms_suppress"),
    ("void (anonymous namespace)::nms_rotated_reduce_kernel(unsigned long long const*)",
     "K5 nms_rotated"),
    ("void (anonymous namespace)::nms_rotated_mask_kernel(float const*, int)", "K5 nms_rotated"),
    ("void cudnn::bn_fw_inf_1C11_kernel_NCHW<float>", "normalisation"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32", "convolution"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"),
    ("some_unknown_kernel", "other"),
])
def test_profile_predict_kernel_family(name, family):
    from yolo_ad_refine_tpu_torch.engine.profile_predict import kernel_family

    assert kernel_family(name) == family


def test_profile_train_raises_when_cuda_is_absent(monkeypatch):
    from yolo_ad_refine_tpu_torch.engine import profile_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_train.main([])


def test_chip_smoke_fails_without_cuda():
    """No card: the script exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    (tmp_path / "chip_smoke.py").write_bytes((REPO / "chip_smoke.py").read_bytes())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
