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
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(" ".join(names))
"""

# the train slice's, the bounded-DCN slice's and the training options'
# modules, each imported under the blocker above
TRAIN_SLICE_MODULES = (
    "cfg.config", "data.augment", "data.build", "data.dataset", "data.synthetic",
    "engine.checkpoint", "engine.validator", "ops.anchors", "ops.deform", "ops.deform_mxu",
    "ops.deform_pallas", "ops.iou",
    "train.loss", "train.optim", "train.step", "train.tal", "train.trainer",
    "utils.autobatch", "utils.callbacks", "utils.checks", "utils.metrics", "utils.plotting",
)


def test_port_imports_nothing_of_jax():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 40  # every module was imported
    missing = [m for m in TRAIN_SLICE_MODULES if f"yolo_ad_refine_tpu_torch.{m}" not in names]
    assert not missing, missing


def test_default_cfg_is_a_byte_identical_copy():
    ours = REPO / "yolo_ad_refine_tpu_torch" / "cfg" / "default.yaml"
    assert ours.read_bytes() == (REPO / "yolo_ad_refine_tpu" / "cfg" / "default.yaml").read_bytes()


def test_yolo_without_device_raises_when_cuda_is_absent(monkeypatch):
    from yolo_ad_refine_tpu_torch import YOLO

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        YOLO("yolo11-701-YOLO-AD-Refine.yaml")


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


@pytest.mark.parametrize("override,item", [
    ({"fsdp": True}, "DDP/FSDP"), ({"task": "segment"}, "tasks"),
])
def test_trainer_raises_on_options_not_ported(override, item, tmp_path):
    from yolo_ad_refine_tpu_torch.train.trainer import DetectionTrainer

    args = {"data": "x.yaml", "plots": False, "project": str(tmp_path), "device": "cpu"}
    with pytest.raises(NotImplementedError, match=item):
        DetectionTrainer({**args, **override})


@pytest.mark.parametrize("args,call", [
    ({"task": "pose"}, {}), ({}, {"backend": object()}),
])
def test_validator_raises_on_options_not_ported(args, call):
    from yolo_ad_refine_tpu_torch.engine.validator import DetectionValidator

    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
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
