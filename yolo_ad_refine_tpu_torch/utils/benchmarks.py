"""Benchmark harness: the export-format matrix and the paper report.

Counterpart of ``yolo_ad_refine_tpu/utils/benchmarks.py`` (reference
utils/benchmarks.py:49 and the root val.py paper report). The formats are
the port's (``engine/exporter.py``): checkpoint, torch_export (.pt2) and
torchscript, each reloaded through ``AutoBackend`` and timed on the
model's device, the card unless the model lives on the CPU.

GFLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over one eval
forward, where the JAX package reads XLA's cost analysis. The two count
differently: FlopCounterMode counts the products (convolutions, matrix
products, attention) at 2 FLOPs a multiply-add, and the DCN forward ops
(``yat_ad::``) through the formula registered here, 2·B·H·W·9·C·Cout;
XLA counts every floating-point operation of the program, normalisations,
activations and the DCN's sampling among them.
"""

from __future__ import annotations

import statistics
import time
from pathlib import Path

import torch

from yolo_ad_refine_tpu_torch.utils import LOGGER

DCN_FORWARD_OPS = ("dcn_forward", "dcn_separable_forward", "dcn_window_forward")


def dcn_flops(x_shape, offset_shape, mask_shape, weight_shape, radius, *args,
              out_shape=None, **kwargs) -> int:
    """A 3x3 DCN forward's FLOPs: 2 per multiply-add of its 9 sampled taps,
    2·B·H·W·9·C·Cout (x (B, C, H, W), weight (Cout, C, 3, 3))."""
    b, c, h, w = x_shape
    return 2 * b * h * w * 9 * c * weight_shape[0]


def register_dcn_flops() -> None:
    """Give FlopCounterMode the DCN forward ops' formula (once a process)."""
    from torch.utils import flop_counter

    from yolo_ad_refine_tpu_torch.engine.exporter import load_dcn_ops

    load_dcn_ops()
    for name in DCN_FORWARD_OPS:
        op = getattr(torch.ops.yat_ad, name)
        if op not in flop_counter.flop_registry:
            flop_counter.register_flop_formula(op)(dcn_flops)


@torch.no_grad()
def model_flops(model: torch.nn.Module, imgsz: int = 640) -> float:
    """GFLOPs of one eval forward of ``model`` on one imgsz² image, on the
    model's device and in its type (see the module docstring for what is
    counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    register_dcn_flops()
    p = next(model.parameters())
    x = torch.zeros((1, 3, imgsz, imgsz), dtype=p.dtype, device=p.device).contiguous(
        memory_format=torch.channels_last)
    training = model.training
    model.eval()
    counter = FlopCounterMode(display=False)
    with counter:
        model(x)
    model.train(training)
    return counter.get_total_flops() / 1e9


def time_callable(fn, x, warmup: int = 3, iters: int = 10) -> float:
    """Median wall time of ``fn(x)`` in seconds; each call ends in a
    synchronise of the card when ``x`` lives there."""
    cuda = isinstance(x, torch.Tensor) and x.device.type == "cuda"

    def call():
        out = fn(x)
        if cuda:
            torch.cuda.synchronize(x.device)
        return out

    for _ in range(warmup):
        call()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    return float(statistics.median(times))


def benchmark(yolo, imgsz: int = 640, batch: int = 1,
              formats: tuple = ("checkpoint", "torch_export", "torchscript"), data=None,
              verbose: bool = True, save_dir: str | Path = "runs/export") -> list[dict]:
    """Export ``yolo.model`` to each format under ``save_dir``, reload it
    through AutoBackend on the model's device and time a batch of
    ``batch`` images at ``imgsz``. A row per format: {format, status,
    ms_per_image, path}; a format the port cannot write gives a
    ``skipped:`` row, any other error a ``failed:`` row, as in the JAX
    package. ``data`` is accepted for the JAX CLI's commands and unused,
    as there."""
    from yolo_ad_refine_tpu_torch.engine.exporter import AutoBackend, Exporter, UnsupportedFormat

    model = yolo.model
    dev = next(model.parameters()).device
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 255, (batch, imgsz, imgsz, 3), generator=gen,
                      dtype=torch.uint8).float().to(dev)
    rows = []
    for fmt in formats:
        try:
            path = Exporter(model, imgsz=imgsz, batch=batch)(fmt, Path(save_dir) / f"model_{fmt}")
            backend = AutoBackend(path, device=dev)
            dt = time_callable(backend, x)
            rows.append({"format": fmt, "status": "ok", "ms_per_image": dt / batch * 1000,
                         "path": str(path)})
        except (UnsupportedFormat, ImportError) as e:
            rows.append({"format": fmt, "status": f"skipped: {e}"})
        except Exception as e:  # noqa: BLE001 - one format's failure is its row, as in JAX
            rows.append({"format": fmt, "status": f"failed: {type(e).__name__}: {e}"})
    if verbose:
        for r in rows:
            LOGGER.info(str(r))
    return rows


def paper_report(yolo, data, imgsz: int = 640, batch: int = 16,
                 save_path: str | Path = "paper_data.txt") -> dict:
    """val.py-style report (reference root val.py:28-98): params, GFLOPs,
    inference ms and FPS, P / R / mAP and fitness, written to
    ``save_path`` and logged. Returns the validation's results."""
    model = yolo.model
    results = yolo.val(data=data, imgsz=imgsz, batch=batch)
    gflops = model_flops(model, imgsz)
    infer_ms = results.get("inference_ms_per_image", 0.0)
    fps = 1000.0 / infer_ms if infer_ms else 0.0
    lines = [
        f"model: {yolo.overrides.get('model')}",
        f"params: {model.num_params():,}",
        f"GFLOPs({imgsz}): {gflops:.2f}",
        f"inference ms/img: {infer_ms:.2f}  FPS: {fps:.1f}",
        f"precision: {results['metrics/precision(B)']:.4f}",
        f"recall: {results['metrics/recall(B)']:.4f}",
        f"mAP50: {results['metrics/mAP50(B)']:.4f}",
        f"mAP50-95: {results['metrics/mAP50-95(B)']:.4f}",
        f"fitness(0.9*mAP50+0.1*mAP): {results['fitness']:.4f}",
    ]
    report = "\n".join(lines)
    Path(save_path).parent.mkdir(parents=True, exist_ok=True)
    Path(save_path).write_text(report + "\n")
    LOGGER.info(report)
    return results
