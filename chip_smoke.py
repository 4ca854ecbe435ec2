#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (yolo_ad_refine_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``yolo_ad_refine_tpu_torch/csrc``
(one nvcc per source, all started together), holds each kernel against its
plain PyTorch version at the shapes of the flagship's predict path, times
both, then serves 64 synthetic images through ``YOLO(...).predict`` with the
flagship YOLO-AD-Refine at imgsz 640 and checks that the path launched every
kernel and agrees with the same model on the CPU. Any failed phase raises
and the script exits non-zero. The last line is the device record
``{"ok": true, "device": {...}}``; the line before the card's name and power
limit, and the one before that the kernels' measurements. Without CUDA, or
without the package beside it, it fails before printing any result. Where
one predict batch's time goes is the job of
``python -m yolo_ad_refine_tpu_torch.engine.profile_predict``.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

FLAGSHIP = "yolo11-701-YOLO-AD-Refine.yaml"
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
FP32_FLOPS = 67e12           # fp32 outside the tensor cores, H100 SXM data sheet
LEVELS = (80, 40, 20)        # AYHead DCN maps at imgsz 640, C = Cout = 64
C = 64
K1_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 2e-2)}  # (atol, rtol)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` calls between CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dcn_inputs(b: int, s: int, dtype, gen, dev):
    import torch

    x = torch.randn(b, s, s, C, generator=gen).to(dev, dtype)
    off = (torch.randn(b, s, s, 18, generator=gen) * 4.0).to(dev)  # reaches well past 3 px
    mask = torch.rand(b, s, s, 9, generator=gen).to(dev)
    w = (torch.randn(3, 3, C, C, generator=gen) / math.sqrt(9 * C)).to(dev, dtype)
    return x, off, mask, w


def nchw(t):
    return t.permute(0, 3, 1, 2)  # contiguous NHWC -> channels_last NCHW view


def phase_k1(dev, gen):
    """DCNv2 forward kernel vs plain at the three level shapes; timing at B=32."""
    import torch

    from yolo_ad_refine_tpu_torch.ops.deform import deform_conv2d_plain, modulated_deform_conv2d

    max_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        atol, rtol = K1_TOL[name]
        for radius in (None, 3):
            for s in LEVELS:
                x, off, mask, w = dcn_inputs(8, s, dtype, gen, dev)
                got = modulated_deform_conv2d(nchw(x), nchw(off), nchw(mask),
                                              w.permute(3, 2, 0, 1), radius)
                want = deform_conv2d_plain(x, off, mask, w, radius)
                torch.cuda.synchronize()
                got = got.permute(0, 2, 3, 1).float()
                err = (got - want.float()).abs().max().item()
                torch.testing.assert_close(got, want.float(), atol=atol, rtol=rtol,
                                           msg=lambda m: f"K1 {name} radius={radius} {s}x{s}: {m}")
                max_err[name] = max(max_err.get(name, 0.0), err)
                log(f"K1 {name:8s} radius={str(radius):4s} B=8 {s}x{s}x{C}->{C}: "
                    f"max |kernel - plain| = {err:.3e} (atol {atol}, rtol {rtol})")

    # time the main path's work: one launch per level, B = 32, fp32
    ms = plain_ms = bound_ms = 0.0
    by_ops = True
    for s in LEVELS:
        x, off, mask, w = dcn_inputs(32, s, torch.float32, gen, dev)
        args = (nchw(x), nchw(off), nchw(mask), w.permute(3, 2, 0, 1))
        ms += cuda_time(lambda: modulated_deform_conv2d(*args), iters=20)
        plain_ms += cuda_time(lambda: deform_conv2d_plain(x, off, mask, w), iters=3, warmup=1)
        px = 32 * s * s
        nbytes = 4 * (px * (C + 18 + 9 + C) + 9 * C * C)
        # contraction 2*9*C*C, sampling 9*C*(4 mul + 4 add) + ~20 per tap for coords
        flops = px * (2 * 9 * C * C + 9 * C * 8 + 9 * 20)
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
        by_ops = by_ops and t_ops >= t_bytes
        bound_ms += max(t_bytes, t_ops)
    log(f"K1 fp32 B=32 three levels: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms")
    return {"max_abs_err": max_err["float32"], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if by_ops else "bytes"}


def nms_candidates(b: int, k: int, gen, dev):
    import torch

    cxy = torch.rand(b, k, 2, generator=gen) * 600
    wh = torch.rand(b, k, 2, generator=gen) * 120 + 4
    cls = torch.randint(0, 8, (b, k, 1), generator=gen).float() * 7680.0  # class offsets
    boxes = torch.cat([cxy - wh / 2, cxy + wh / 2], -1) + cls
    scores = (torch.rand(b, k, generator=gen) * 64).round() / 64  # many ties
    scores = scores.sort(dim=1, descending=True, stable=True).values
    return boxes.to(dev).contiguous(), scores.to(dev).contiguous()


def phase_k4(dev, gen):
    """NMS suppression kernel vs plain: exactly equal keep masks; timing."""
    import torch

    from yolo_ad_refine_tpu_torch.ops.nms import suppress, suppress_plain

    differ = 0  # keep-mask entries where kernel and plain disagree, over both checks
    for b, k in ((32, 2048), (3, 1000)):
        boxes, scores = nms_candidates(b, k, gen, dev)
        got = suppress(boxes, scores, 0.7, 0.001)
        want = suppress_plain(boxes, scores, 0.7, 0.001)
        n = int((got != want).sum())
        differ += n
        if n or not torch.equal(got, want):
            raise AssertionError(f"K4 keep mask differs from plain at B={b} K={k}: {n} entries")
        log(f"K4 B={b} K={k}: keep mask equal to plain ({int(got.sum())} kept)")
    boxes, scores = nms_candidates(32, 2048, gen, dev)
    ms = cuda_time(lambda: suppress(boxes, scores, 0.7, 0.001), iters=20)
    plain_ms = cuda_time(lambda: suppress_plain(boxes, scores, 0.7, 0.001), iters=3, warmup=1)
    keep = suppress(boxes, scores, 0.7, 0.001)
    k = 2048
    # work this data needs: each kept candidate's IoU against every later one
    idx = torch.arange(k, device=dev)
    pairs = int(((k - 1 - idx)[None, :] * keep).sum())
    flops = pairs * 15 + 32 * k * 3
    nbytes = 32 * k * (16 + 4 + 1)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    log(f"K4 B=32 K=2048: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {max(t_bytes, t_ops):.5f} ms ({pairs} IoU pairs)")
    return {"max_abs_err": float(differ), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_serving(dev):
    """The flagship's predict path on the card, then one 2-image batch
    against the same model on the CPU."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.engine.predictor import preprocess
    from yolo_ad_refine_tpu_torch.ops.deform import modulated_deform_conv2d
    from yolo_ad_refine_tpu_torch.ops.nms import suppress

    t0 = time.perf_counter()
    model = YOLO(FLAGSHIP, device=dev, imgsz=640, seed=0)
    log(f"serving: flagship built on {dev} in {time.perf_counter() - t0:.1f} s, "
        f"{model.model.num_params():,} parameters, strides {model.model.strides}")
    rng = np.random.default_rng(0)
    shapes = [(480, 640), (640, 480), (720, 1280), (360, 640), (1080, 1920), (512, 512),
              (300, 800), (640, 640)]
    imgs = [rng.integers(0, 256, (*shapes[i % len(shapes)], 3), dtype=np.uint8) for i in range(64)]
    model.predict(imgs[:32], conf=0.001, batch=32)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

    # three timed runs of the path: the host clock here varies from run to run
    seconds = []
    for _ in range(3):
        modulated_deform_conv2d.launches = 0
        suppress.launches = 0
        t0 = time.perf_counter()
        results = model.predict(imgs, conf=0.001, batch=32)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = {"dcn_forward": modulated_deform_conv2d.launches,
                    "nms_suppress": suppress.launches}
        if min(launches.values()) == 0:
            raise AssertionError(f"a kernel was not launched on the predict path: {launches}")
    dt = sorted(seconds)[1]
    log(f"serving: 64 images, batch 32, imgsz 640, fp32: {64 / dt:.1f} images/s, "
        f"{dt / 2 * 1e3:.1f} ms/batch (median of 3 runs: "
        + ", ".join(f"{64 / s:.1f}" for s in seconds)
        + " images/s; host clock, preprocess + forward + NMS + results)")
    log(f"serving: launches per run of the path: {launches}")
    if len(results) != 64:
        raise AssertionError(f"expected 64 results, got {len(results)}")
    for im, r in zip(imgs, results):
        d = r.boxes.data
        if not (0 < len(d) <= 300 and np.isfinite(d).all()):
            raise AssertionError(f"bad detections for an image of shape {im.shape}: {d.shape}")
        h, w = im.shape[:2]
        if (d[:, [0, 2]] < 0).any() or (d[:, [0, 2]] > w).any() or (d[:, [1, 3]] < 0).any() \
                or (d[:, [1, 3]] > h).any():
            raise AssertionError("detections outside their image")
    log(f"serving: {sum(len(r) for r in results)} detections, all finite and inside their images")

    # one 2-image batch against the same weights on the CPU (the reference)
    x, _ = preprocess(imgs[:2], 640, 2, torch.device(dev), torch.float32)
    with torch.inference_mode():
        y_gpu = model.model(x)[0].float().cpu()
        cpu_model = copy.deepcopy(model.model).cpu()
        y_cpu = cpu_model(x.cpu())[0]
    box_err = (y_gpu[..., :4] - y_cpu[..., :4]).abs().max().item()
    score_err = (y_gpu[..., 4:] - y_cpu[..., 4:]).abs().max().item()
    log(f"serving: card vs CPU on 2 images: max |box diff| {box_err:.3e} px (tol 5e-2), "
        f"max |score diff| {score_err:.3e} (tol 1e-3)")
    if not (y_gpu.shape == (2, 8400, 84) and torch.isfinite(y_gpu).all()):
        raise AssertionError(f"bad decoded predictions {tuple(y_gpu.shape)}")
    if box_err > 5e-2 or score_err > 1e-3:
        raise AssertionError("card and CPU predictions disagree")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from yolo_ad_refine_tpu_torch.utils import kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"Python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    report = kernels.build("deform_conv", "nms")
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (parallel nvcc): "
        + ", ".join(f"{n} {r['seconds']:.1f} s" for n, r in report.items()))
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    k1 = phase_k1(dev, gen)
    k4 = phase_k4(dev, gen)
    launches = phase_serving(dev)

    kernels_line = {"kernels": [
        {"name": "dcn_forward", "route": "cuda",
         "source": "yolo_ad_refine_tpu_torch/csrc/deform_conv.cu",
         "replaces": "yolo_ad_refine_tpu/ops/deform_mxu2.py:92",
         "launches": launches["dcn_forward"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None},
        {"name": "nms_suppress", "route": "cuda",
         "source": "yolo_ad_refine_tpu_torch/csrc/nms.cu",
         "replaces": "yolo_ad_refine_tpu/ops/nms_pallas.py:32",
         "launches": launches["nms_suppress"], "max_abs_err": k4["max_abs_err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": None},
    ]}
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
