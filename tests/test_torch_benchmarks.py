"""The PyTorch port's benchmark harness (``utils/benchmarks.py``) on the CPU:
``benchmark`` gives an ``ok`` row with its ms per image for each of the
port's formats (checkpoint, torch_export, torchscript) and a ``skipped:``
row for a format the port cannot write; ``model_flops`` equals an analytic
count of a small model with the flagship's head (five convs and AYHead) at
imgsz 64: 2 FLOPs a multiply-add of every convolution, of the DCN
(2·B·H·W·9·C·Cout through the formula registered for ``yat_ad::``) and of
the DFL decode's expectation, the one matrix product. The JAX package's
XLA figure for the same model is printed beside it: XLA counts every
operation, the normalisations, activations and the DCN's sampling too.
``paper_report`` writes its report where the caller says."""

import numpy as np
import pytest
import torch
from torch import nn

from yolo_ad_refine_tpu.models.model import build_detection_model as jax_build_detection_model
from yolo_ad_refine_tpu.utils.benchmarks import model_flops as jax_model_flops
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
from yolo_ad_refine_tpu_torch.models.model import build_detection_model
from yolo_ad_refine_tpu_torch.nn.head import DyDCNv2
from yolo_ad_refine_tpu_torch.utils.benchmarks import model_flops, paper_report, time_callable
from yolo_ad_refine_tpu_torch.utils import yaml_save

TINY_AY = {
    "nc": 3,
    "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [128, 3, 2]],
                 [-1, 1, "Conv", [256, 3, 2]]],
    "head": [[[2, 3, 4], 1, "AYHead", ["nc"]]],
}
IMGSZ = 64


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def analytic_flops(model: nn.Module, imgsz: int) -> int:
    """2 FLOPs a multiply-add of each convolution and DCN the forward runs,
    from their shapes, and of the DFL decode (reg_max 16 bins, 4 sides, A
    anchors)."""
    total = []

    def conv(mod, args, out):
        total.append(2 * out.numel() * (mod.in_channels // mod.groups) * int(np.prod(mod.kernel_size)))

    def dcn(mod, args, out):
        total.append(2 * out.numel() * args[0].shape[1] * 9)

    hooks = [m.register_forward_hook(dcn if isinstance(m, DyDCNv2) else conv)
             for m in model.modules() if isinstance(m, (nn.Conv1d, nn.Conv2d, DyDCNv2))]
    assert not any(isinstance(m, nn.Linear) for m in model.modules())
    with torch.no_grad():
        y = model.eval()(torch.zeros(1, 3, imgsz, imgsz).contiguous(
            memory_format=torch.channels_last))[0]
    for h in hooks:
        h.remove()
    return sum(total) + 2 * y.shape[1] * 4 * 16


def test_model_flops_is_the_analytic_count():
    model = build_detection_model(TINY_AY, device="cpu", imgsz=IMGSZ)
    got = model_flops(model, IMGSZ)
    want = analytic_flops(model, IMGSZ)
    assert got * 1e9 == pytest.approx(want, rel=1e-12)
    xla = jax_model_flops(jax_build_detection_model(TINY_AY, imgsz=IMGSZ), IMGSZ)
    print(f"\nfive convs + AYHead at {IMGSZ}: FlopCounterMode {got:.6f} GFLOPs, "
          f"XLA cost analysis {xla:.6f} GFLOPs, XLA / port {xla / got:.3f}")
    assert model_flops(model, IMGSZ) == got  # the DCN formula registers once


def test_time_callable_runs_warmup_and_iterations():
    calls = []
    t = time_callable(lambda x: calls.append(x), torch.zeros(1), warmup=2, iters=5)
    assert len(calls) == 7 and t >= 0


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    yaml_save(tmp / "tiny.yaml", TINY_AY)
    return tmp, YOLO(str(tmp / "tiny.yaml"), device="cpu", imgsz=IMGSZ)


def test_benchmark_rows_for_the_ports_formats(tiny):
    tmp, model = tiny
    rows = model.benchmark(imgsz=IMGSZ, batch=2, save_dir=tmp / "export",
                           formats=("checkpoint", "torch_export", "torchscript", "onnx"))
    assert [r["format"] for r in rows] == ["checkpoint", "torch_export", "torchscript", "onnx"]
    for r in rows[:3]:
        assert r["status"] == "ok" and r["ms_per_image"] > 0, r
    assert rows[3]["status"].startswith("skipped: format 'onnx'")
    assert (tmp / "export" / "model_checkpoint" / "weights.pt").exists()
    assert (tmp / "export" / "model_torchscript.torchscript").exists()


def test_paper_report_writes_where_asked(tiny):
    tmp, model = tiny
    data = make_shapes_dataset(tmp / "ds", n_train=2, n_val=2, imgsz=IMGSZ, seed=6)
    results = paper_report(model, data, imgsz=IMGSZ, batch=2, save_path=tmp / "r" / "paper.txt")
    lines = (tmp / "r" / "paper.txt").read_text().splitlines()
    assert lines[1] == f"params: {model.model.num_params():,}"
    assert lines[2] == f"GFLOPs({IMGSZ}): {model_flops(model.model, IMGSZ):.2f}"
    assert lines[6] == f"mAP50: {results['metrics/mAP50(B)']:.4f}"
    assert len(lines) == 9 and lines[-1].startswith("fitness")
