#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (yolo_ad_refine_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``yolo_ad_refine_tpu_torch/csrc``
(one nvcc per source, all started together), holds each kernel (K1 DCN
forward and backward; K2, the separable DCN, and K3, the bounded-window
DCN, forward and backward; K4 NMS; K5 rotated NMS; the gather probe)
against its plain PyTorch version at the shapes of its paths and times
both; K1 also at the flagship's wider DCN of scales m, l (C = Cout = 256)
and x (384), where its backward runs in (C-chunk, Cout-chunk) pairs, and
K2 and K3 at 384, at radius 13 and at radius 31, where their forward reads
its samples' corners from global memory (its global mode), and their
backward at radius 3 (its window mode), 13, 31 and 200 (its global mode)
and at 384 channels at radius 3 and 31, held at the fp32 limit in fp32 and
bf16 (the backward is all fp32: with bf16 inputs on its fp64 sums, before
the wrapper rounds dx and dweight to bf16). The gather probe's path is
``engine/profile_gather.py``'s
run at bench_dcn.py's probe shapes. Then it drives
the paths through the user's entry points, each with the launch counts set
to 0 just before it and read just after, each DCN variant under its own
``YAT_DCN_IMPL`` (set for the phase and restored after it):

- serving: 64 synthetic images through ``YOLO(...).predict`` with the
  flagship YOLO-AD-Refine at imgsz 640, checked against the same model on
  the CPU;
- folder and video serving: the same shapes as 64 JPEGs in a directory and
  a 24-frame MJPG video, predicted from their paths with ``save``,
  ``save_txt``, ``save_conf`` and ``save_crop``: every label file against
  its results, and ``vid_stride``;
- training: ``YOLO(...).train`` on a synthetic shapes set written to a
  temporary directory (64 train, 16 val images), 1 epoch at batch 16,
  imgsz 640, bf16 autocast: 4 steps, the EMA validation through K1 fwd and
  K4, the checkpoints, and a reload of ``best``;
- serving on the bounded variants: 32 images at batch 32, imgsz 640, fp32
  under ``mxu`` (K2), ``pallas`` (K3) and ``mxu2`` (K1 at radius 3), each
  held against the CPU under the same variable;
- training on ``mxu`` and ``pallas``: the training path above, each step
  launching its variant's forward and backward kernel 3 times and no other
  DCN kernel; the ``pallas`` run's ``best`` is then reloaded with its
  dcn_offset_max raised to 11.5, which widens the radius to 13, and serves
  a batch through K3 at that radius;
- training at scale x (``yolo11x-701-YOLO-AD-Refine.yaml``): the training
  path above, whose DCN backward at C = Cout = 384 runs K1 bwd's wide path;
- OBB serving: 32 seeded images (1024² DOTA tiles and a few of 800² to
  1920×1080) through ``YOLO("yolo11n-obb.yaml", task="obb").predict`` at
  batch 16, imgsz 1024, checked against the same model on the CPU;
- OBB validation: ``.val`` of that model on a seeded DOTA-format set
  written to a temporary directory (16 tiles of 1024², 15 classes),
  checked against the same validation on the CPU;
- the training options of a user's yaml (``phase_training_options``):
  the flagship trained with ``multi_scale``, ``cache="ram"`` and the
  default ``plots`` (each step's drawn size, ms and K1 launches; the plot
  files), ``best`` validated with ``rect``, ``save_json`` and ``plots``
  on the card and on the CPU (the metrics and predictions.json held
  against each other), ``batch=-1`` (autobatch's probe peaks and pick, and
  a step at the picked batch within the memory budget), and the run's
  ``last`` written in the JAX package's layout and resumed from it for one
  more epoch (the restored state as written, the first step's fp32 loss
  against the same resume from the port's ``train.pt``);

and holds one fp32 train step on the card against the same step on the
CPU. Any failed phase raises and the script exits non-zero. The last line is
the device record ``{"ok": true, "device": {...}}``; the line before the
card's name and power limit, and the one before that the kernels'
measurements: ``launches`` from each kernel's main path (``main_path``: the
training run of its variant; K5: the OBB serving run) with each path's own
count under ``launches_by_path``; K1 fwd and bwd, K2 and K3 in fp32 with
their bf16 numbers under ``bfloat16``, each against the bound of its own
precision (K1's and the K2 / K3 forwards' fp32 against their 3xTF32
tensor-core route, K3's bf16 forward against bf16 products and K2's
against three bf16 products, the fastest exact route for its fp32 sample,
``bound_route``, with the fp32-core bound beside it as
``bound_ms_fp32_cores`` and K2's own 2xTF32 route as ``bound_ms_2xtf32``);
the K2 / K3 backwards against the fastest exact route of their products,
3xTF32 in fp32 and, with bf16 inputs, one bf16 product for g . W_t^T and
three for the fp32 sample against g (``bound_route`` "bf16+3xbf16"), with
the fp32-core bound beside it; ``ms`` is CUDA events around the wrapper's
call, as for every kernel, and K1's and the K2 / K3 forwards' and
backwards' ``device_ms`` the kernel's own device time from torch.profiler
(the K2 / K3 forwards in bf16 at batch 16, ``batch``); K4's and
K5's ``device_ms`` too, split into the mask kernel and the walk under
``parts``, and the same on a predict batch's candidates at conf 0.001 and
0.25 under ``predict_batch``. K4 and K5 are held against their plain
versions also at one candidate, max_nms 4096, a ragged last word past 64
words, a batch of 64, with no valid row, every row valid, unsorted scores
and a predict batch's candidates at both confs. Without CUDA, or without
the package beside it, it fails before printing any result.
Where one predict batch's time goes is the job of
``python -m yolo_ad_refine_tpu_torch.engine.profile_predict``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

FLAGSHIP = "yolo11-701-YOLO-AD-Refine.yaml"
FLAGSHIP_X = "yolo11x-701-YOLO-AD-Refine.yaml"  # the flagship at scale x: DCN at C = Cout = 384
OBB_CFG = "yolo11n-obb.yaml"  # scale n, nc 15 (DOTA v1), 1024 px DOTA tiles
OBB_IMGSZ = 1024
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
FP32_FLOPS = 67e12           # fp32 outside the tensor cores, H100 SXM data sheet
BF16_TC_FLOPS = 989e12       # bf16 on the tensor cores (fp32 accumulate), dense, data sheet
TF32_TC_FLOPS = 495e12       # TF32 on the tensor cores, dense, data sheet
LEVELS = (80, 40, 20)        # AYHead DCN maps at imgsz 640, C = Cout = 64
SERVING_SHAPES = [(480, 640), (640, 480), (720, 1280), (360, 640), (1080, 1920), (512, 512),
                  (300, 800), (640, 640)]  # the serving phases' image shapes
C = 64
WIDE = (256, 384)            # the flagship's DCN width at scales m / l and x (max(ch) // 2)
K1_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 2e-2)}  # (atol, rtol)
K1_BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # max |kernel - plain| / max |plain|
GRADS = ("dx", "doffset", "dmask", "dweight")
LEAF_TOL = 1e-3  # card vs CPU train step, relative norm of each gradient leaf


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


def dcn_inputs(b: int, s: int, dtype, gen, dev, c: int = C):
    import torch

    x = torch.randn(b, s, s, c, generator=gen).to(dev, dtype)
    off = (torch.randn(b, s, s, 18, generator=gen) * 4.0).to(dev)  # reaches well past 3 px
    mask = torch.rand(b, s, s, 9, generator=gen).to(dev)
    w = (torch.randn(3, 3, c, c, generator=gen) / math.sqrt(9 * c)).to(dev, dtype)
    return x, off, mask, w


def nchw(t):
    return t.permute(0, 3, 1, 2)  # contiguous NHWC -> channels_last NCHW view


def phase_k1(dev, gen):
    """DCNv2 forward kernel vs plain at the three level shapes; timing at B=32."""
    import torch

    from yolo_ad_refine_tpu_torch.engine.profile_dcn import device_ms
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

    # time the main path's work, one launch per level: fp32 at B = 32 (a
    # serving batch), bf16 at B = 16 (a train step under autocast)
    times = {}
    for dtype, b in ((torch.float32, 32), (torch.bfloat16, 16)):
        name = str(dtype).split(".")[1]
        ms = plain_ms = kernel_ms = 0.0
        routes = ("3xtf32", "fp32") if dtype == torch.float32 else ("bf16",)
        bound = {r: [0.0, True] for r in routes}  # ms, bound by the operations
        for s in LEVELS:
            x, off, mask, w = dcn_inputs(b, s, dtype, gen, dev)
            args = (nchw(x), nchw(off), nchw(mask), w.permute(3, 2, 0, 1))
            ms += cuda_time(lambda: modulated_deform_conv2d(*args), iters=20)
            kernel_ms += device_ms(lambda: modulated_deform_conv2d(*args))
            plain_ms += cuda_time(lambda: deform_conv2d_plain(x, off, mask, w), iters=3, warmup=1)
            for r in routes:
                t_bytes, t_ops = dcn_fwd_bound(b, s, x.element_size(), r)
                bound[r][0] += max(t_bytes, t_ops)
                bound[r][1] = bound[r][1] and t_ops >= t_bytes
        times[name] = {"max_abs_err": max_err[name], "ms": ms, "device_ms": kernel_ms,
                       "plain_ms": plain_ms, "bound_ms": bound[routes[0]][0],
                       "bound_by": "operations" if bound[routes[0]][1] else "bytes"}
        if dtype == torch.float32:
            times[name]["bound_ms_fp32_cores"] = bound["fp32"][0]
        log(f"K1 {name} B={b} three levels: kernel {ms:.4f} ms (device {kernel_ms:.4f} ms), "
            f"plain {plain_ms:.3f} ms, bound "
            f"{times[name]['bound_ms']:.4f} ms ({routes[0]}, {times[name]['bound_by']})"
            + (f", fp32-core bound {bound['fp32'][0]:.4f} ms" if "fp32" in bound else ""))
    return times


def products_ms(flops: float, route: str) -> float:
    """ms for GEMM-shaped products of ``flops`` on one route: "fp32" the
    fp32 cores, "bf16" the tensor cores in bf16, "3xtf32" three TF32
    products on the tensor cores (fp32 accuracy); for an fp32 sample against
    a bf16 weight (K2's bf16 forward), "3xbf16" the sample split into three
    bf16 parts, which hold its 24 bits exactly (the fastest exact route, its
    bound), and "2xtf32" two TF32 products (the kernel's route)."""
    return {"fp32": flops / FP32_FLOPS, "bf16": flops / BF16_TC_FLOPS,
            "3xtf32": 3 * flops / TF32_TC_FLOPS, "3xbf16": 3 * flops / BF16_TC_FLOPS,
            "2xtf32": 2 * flops / TF32_TC_FLOPS}[route] * 1e3


def dcn_fwd_bound(b: int, s: int, itemsize: int, route: str = "fp32",
                  c: int = C) -> tuple[float, float]:
    """(ms for the bytes, ms for the operations) of a DCN forward at one
    level and C = Cout = c: x, offset, mask and weight read once, out
    written once; the contraction 2*9*C*C a pixel on ``route``
    (``products_ms``), and sampling 9*C*(4 mul + 4 add) + ~20 per tap for
    coordinates on the fp32 cores."""
    px = b * s * s
    nbytes = itemsize * (px * 2 * c + 9 * c * c) + 4 * px * (18 + 9)
    products = px * 2 * 9 * c * c
    other = px * (9 * c * 8 + 9 * 20)
    t_ops = products_ms(products, route) + other / FP32_FLOPS * 1e3
    return nbytes / H100_BYTES_PER_S * 1e3, t_ops


def k1_bwd_work(b: int, s: int, itemsize: int, c: int = C) -> tuple[float, float, float]:
    """(bytes, product flops, other flops) K1 bwd must move and do at one
    level and C = Cout = c: x, offset, mask, weight and g read once, dx,
    doffset, dmask and dweight written once; per pixel and tap the two C x
    Cout products (g . W_t^T and the dW_t update, GEMM-shaped), and besides
    them the 4-corner sampling recompute, the corner dot products and the
    dx scatter (~24 flops a channel) and ~30 flops of coordinates."""
    px = b * s * s
    nbytes = (itemsize * px * (c + c + c) + 4 * px * (18 + 9) * 2
              + itemsize * 9 * c * c * 2)
    return nbytes, px * 9 * 4 * c * c, px * 9 * (24 * c + 30)


def grads_nhwc(got):
    """A backward wrapper's (dx, doffset, dmask, dweight) in the plain
    versions' NHWC / HWIO layouts."""
    return [got[0].permute(0, 2, 3, 1), got[1].permute(0, 2, 3, 1), got[2].permute(0, 2, 3, 1),
            got[3].permute(2, 3, 1, 0)]


def hold_grads(label: str, got, want, tol: float) -> tuple[list, float]:
    """Each gradient within ``tol`` of max |plain| (raises); returns the
    relative errors and the largest absolute one."""
    import torch

    rels, worst = [], 0.0
    for gname, a, e in zip(GRADS, got, want):
        a, e = a.float(), e.float()
        if a.shape != e.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{label} {gname}: bad output {tuple(a.shape)}")
        rel = ((a - e).abs().max() / e.abs().max()).item()
        rels.append(rel)
        if rel > tol:
            raise AssertionError(f"{label} {gname}: max |kernel - plain| / max |plain| = "
                                 f"{rel:.3e} > {tol}")
        worst = max(worst, (a - e).abs().max().item())
    return rels, worst


def phase_k1_bwd(dev, gen):
    """DCNv2 backward kernel vs plain (autograd of the plain forward) at the
    three level shapes; timing at B=16, the train batch."""
    import torch

    from yolo_ad_refine_tpu_torch.engine.profile_dcn import device_ms
    from yolo_ad_refine_tpu_torch.ops.deform import (
        dcn_backward, deform_conv2d_grads_plain, modulated_deform_conv2d)

    # the DCN on a CUDA tensor keeps the autograd graph (slice 1 lost it)
    x, off, mask, w = dcn_inputs(2, 20, torch.float32, gen, dev)
    ins = [t.requires_grad_() for t in (nchw(x), nchw(off), nchw(mask), w.permute(3, 2, 0, 1))]
    y = modulated_deform_conv2d(*ins)
    if y.grad_fn is None:
        raise AssertionError("modulated_deform_conv2d on the card returned no grad_fn")
    y.square().sum().backward()
    if not all(t.grad is not None and bool(t.grad.abs().sum() > 0) for t in ins):
        raise AssertionError("the DCN on the card gave no gradient to an input")
    log(f"K1 on the card: output has grad_fn {type(y.grad_fn).__name__}; all four inputs "
        "got gradients")

    def run(x, off, mask, w, g, radius):
        return dcn_backward(nchw(x), nchw(off), nchw(mask), w.permute(3, 2, 0, 1), nchw(g), radius)

    max_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for radius in (None, 3):
            for s in LEVELS:
                x, off, mask, w = dcn_inputs(8, s, dtype, gen, dev)
                g = torch.randn(8, s, s, C, generator=gen).to(dev, dtype)
                got = grads_nhwc(run(x, off, mask, w, g, radius))
                want = deform_conv2d_grads_plain(x, off, mask, w, g, radius)
                torch.cuda.synchronize()
                errs, worst = hold_grads(f"K1 bwd {name} radius={radius} {s}x{s}", got, want,
                                         K1_BWD_TOL[name])
                max_err[name] = max(max_err.get(name, 0.0), worst)
                log(f"K1 bwd {name:8s} radius={str(radius):4s} B=8 {s}x{s}x{C}->{C}: "
                    f"max |kernel - plain| / max |plain| = "
                    + ", ".join(f"{n} {e:.2e}" for n, e in zip(GRADS, errs))
                    + f" (tol {K1_BWD_TOL[name]})")

    # time the train step's work: one launch per level, B = 16
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        ms = plain_ms = kernel_ms = 0.0
        # the products on the kernel's route (bf16, or 3xTF32 for fp32), the
        # rest on the fp32 cores; fp32 also all on the fp32 cores, as before
        routes = ("3xtf32", "fp32") if dtype == torch.float32 else ("bf16",)
        bound = {r: [0.0, True] for r in routes}
        for s in LEVELS:
            x, off, mask, w = dcn_inputs(16, s, dtype, gen, dev)
            g = torch.randn(16, s, s, C, generator=gen).to(dev, dtype)
            ms += cuda_time(lambda: run(x, off, mask, w, g, None), iters=10)
            kernel_ms += device_ms(lambda: run(x, off, mask, w, g, None))
            plain_ms += cuda_time(lambda: deform_conv2d_grads_plain(x, off, mask, w, g), iters=3,
                                  warmup=1)
            nbytes, products, other = k1_bwd_work(16, s, x.element_size())
            t_bytes = nbytes / H100_BYTES_PER_S * 1e3
            for r in routes:
                t_ops = products_ms(products, r) + other / FP32_FLOPS * 1e3
                bound[r][0] += max(t_bytes, t_ops)
                bound[r][1] = bound[r][1] and t_ops >= t_bytes
        times[name] = {"max_abs_err": max_err[name], "ms": ms, "device_ms": kernel_ms,
                       "plain_ms": plain_ms, "bound_ms": bound[routes[0]][0],
                       "bound_by": "operations" if bound[routes[0]][1] else "bytes"}
        if dtype == torch.float32:
            times[name]["bound_ms_fp32_cores"] = bound["fp32"][0]
        log(f"K1 bwd {name} B=16 three levels: kernel {ms:.4f} ms (device {kernel_ms:.4f} ms), "
            f"plain {plain_ms:.3f} ms, "
            f"bound {times[name]['bound_ms']:.4f} ms ({routes[0]}, {times[name]['bound_by']})"
            + (f", fp32-core bound {bound['fp32'][0]:.4f} ms" if "fp32" in bound else ""))
    return times


BOUNDED = {  # YAT_DCN_IMPL value: its forward and backward entries, TPU kernel file
    "mxu": ("dcn_separable_forward", "dcn_separable_backward", "ops/deform_mxu.py"),
    "pallas": ("dcn_window_forward", "dcn_window_backward", "ops/deform_pallas.py"),
}


def bounded_inputs(b: int, s: int, dtype, gen, dev, radius: int, c: int = C):
    """DCN inputs whose offsets reach past ``radius`` (N(0, 4/3 radius)), with
    the y-offset of every other tap made integral."""
    x, off, mask, w = dcn_inputs(b, s, dtype, gen, dev, c)
    off = (off / 3.0 * radius).reshape(b, s, s, 9, 2)
    off[:, :, :, 0::2, 0] = off[:, :, :, 0::2, 0].round()
    return x, off.reshape(b, s, s, 18).contiguous(), mask, w


def hold_bounded_bwd(label: str, impl: str, got, x, off, mask, w, g, r: int):
    """K2 / K3 bwd against its plain version at the fp32 limit (K1_BWD_TOL
    fp32, 1e-4 of max |plain|) in fp32 and bf16, since both backwards are all
    fp32: the wrapper's outputs in fp32; with bf16 inputs the kernel's fp64
    sums (before the wrapper rounds dx and dweight to bf16) against the plain
    version on the bf16 values in fp32. The comparison's launch is not
    counted. Raises; returns the relative errors and the largest absolute."""
    import torch

    from yolo_ad_refine_tpu_torch.ops import deform_mxu, deform_pallas

    mod = deform_mxu if impl == "mxu" else deform_pallas
    grads_plain = getattr(mod, f"deform_conv2d_{impl}_grads_plain")
    tol = K1_BWD_TOL["float32"]
    if x.dtype == torch.float32:
        return hold_grads(label, got, grads_plain(x, off, mask, w, g, r), tol)
    sums = grads_nhwc(deform_pallas._backward(BOUNDED[impl][1], nchw(x), nchw(off), nchw(mask),
                                              w.permute(3, 2, 0, 1), nchw(g), r, rounded=False))
    return hold_grads(label, sums, grads_plain(x.float(), off, mask, w.float(), g.float(), r), tol)


def bwd_bound(b: int, s: int, itemsize: int, c: int = C) -> dict:
    """K2 / K3 bwd's bound at one level (batch b, C = Cout = c) on each route
    (ms, operation-bound): the two C x Cout products of ``k1_bwd_work`` on the
    fastest exact route of the inputs' type, the rest on the fp32 cores:
    fp32 3xTF32 for both; bf16 inputs one bf16 product for gs = g . W_t^T
    (bf16 x bf16) and three for dW_t += (m sample)^T g (the fp32 sample
    split into three bf16 parts, its 24 bits, against g); and all on the
    fp32 cores, the route the fp32-core backward took."""
    nbytes, products, other = k1_bwd_work(b, s, itemsize, c)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_other = other / FP32_FLOPS * 1e3
    fast = (products_ms(products, "3xtf32") if itemsize == 4 else
            products_ms(products / 2, "bf16") + products_ms(products / 2, "3xbf16"))
    res = {}
    cores = products_ms(products, "fp32") + t_other
    for route, t_ops in (("fast", fast + t_other), ("fp32", cores)):
        res[route] = (max(t_bytes, t_ops), t_ops >= t_bytes)
    return res


def phase_bounded(dev, gen, impl: str):
    """K2 (``mxu``) or K3 (``pallas``), forward and backward, against its
    plain version at the flagship's levels, radius 3, in fp32 and bf16
    (forward at B=32, backward at B=16), at radius 13 on the 80² map (B=8),
    at radius 31 on the 40² map (B=8; both global modes) and the backward at
    radius 200 on a 20² map (B=2); the forward with K1's limits, the
    backward at the fp32 limit in both dtypes (``hold_bounded_bwd``); then
    timed beside the plain version at those batches, each by its device
    time (torch.profiler) against the bound of its tensor-core products
    (forward: 3xTF32 in fp32; bf16 for K3's bf16; for K2's bf16 three bf16
    products, with the kernel's 2xTF32 beside it; backward: ``bwd_bound``)
    and of the fp32 cores. d offset must be 0 on the integral axis and
    beyond the radius."""
    import torch

    from yolo_ad_refine_tpu_torch.engine.profile_dcn import device_ms
    from yolo_ad_refine_tpu_torch.ops import deform_mxu, deform_pallas

    mod = deform_mxu if impl == "mxu" else deform_pallas
    fwd_name, bwd_name, _ = BOUNDED[impl]
    fwd, bwd = getattr(mod, fwd_name), getattr(mod, bwd_name)
    plain = getattr(mod, f"deform_conv2d_{impl}_plain")
    grads_plain = getattr(mod, f"deform_conv2d_{impl}_grads_plain")

    def run_fwd(x, off, mask, w, r):
        return fwd(nchw(x), nchw(off), nchw(mask), w.permute(3, 2, 0, 1), r)

    def run_bwd(x, off, mask, w, g, r):
        return bwd(nchw(x), nchw(off), nchw(mask), w.permute(3, 2, 0, 1), nchw(g), r)

    err = {"fwd": {}, "bwd": {}}
    times = {"fwd": {}, "bwd": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        atol, rtol = K1_TOL[name]
        cases = [(s, 3) for s in LEVELS] + [(LEVELS[0], 13), (LEVELS[1], 31), (LEVELS[2], 200)]
        for s, r in cases:
            if deform_pallas.window_fwd_launch(r, C, C, dtype, separable=impl == "mxu")[
                    "global"] != (r >= 31):
                raise AssertionError(f"{fwd_name} {name} r={r}: the plan's mode is not the "
                                     "expected one (global only past the window, from r=31)")
            if deform_pallas.window_bwd_launch(r, C, C, dtype)["global"] != (r > 3):
                raise AssertionError(f"{bwd_name} {name} r={r}: the plan's mode is not the "
                                     "expected one (the window at r=3, global from r=13)")
            e = None
            if r != 200:
                b = 32 if r == 3 else 8
                x, off, mask, w = bounded_inputs(b, s, dtype, gen, dev, r)
                got = run_fwd(x, off, mask, w, r).permute(0, 2, 3, 1).float()
                want = plain(x, off, mask, w, r).float()
                torch.cuda.synchronize()
                e = (got - want).abs().max().item()
                torch.testing.assert_close(got, want, atol=atol, rtol=rtol,
                                           msg=lambda m: f"{fwd_name} {name} r={r} {s}x{s}: {m}")
                err["fwd"][name] = max(err["fwd"].get(name, 0.0), e)
            b = 16 if r == 3 else 8 if r != 200 else 2
            x, off, mask, w = bounded_inputs(b, s, dtype, gen, dev, r)
            g = torch.randn(b, s, s, C, generator=gen).to(dev, dtype)
            got = grads_nhwc(run_bwd(x, off, mask, w, g, r))
            torch.cuda.synchronize()
            doff = got[1].reshape(b, s, s, 9, 2)
            if doff[:, :, :, 0::2, 0].any() or doff[off.reshape(b, s, s, 9, 2).abs() >= r].any():
                raise AssertionError(f"{bwd_name} {name} r={r}: d offset not 0 on an integral "
                                     "axis or beyond the radius")
            rels, worst = hold_bounded_bwd(f"{bwd_name} {name} r={r} {s}x{s}", impl, got,
                                           x, off, mask, w, g, r)
            err["bwd"][name] = max(err["bwd"].get(name, 0.0), worst)
            log(f"{impl} {name:8s} r={r:<3d} {s}x{s}x{C}->{C}: "
                + (f"fwd B={32 if r == 3 else 8} max |kernel - plain| {e:.3e} (atol {atol}, "
                   f"rtol {rtol}); " if e is not None else "")
                + f"bwd B={b} max |kernel - plain| / max |plain| "
                + ", ".join(f"{n} {v:.2e}" for n, v in zip(GRADS, rels))
                + f" (tol {K1_BWD_TOL['float32']}" + (", fp64 sums" if name == "bfloat16" else "")
                + ")")

        # the paths' work, radius 3: forward at B=32 (fp32, a serving batch) or
        # B=16 (bf16, a train step), backward at B=16, one launch a level
        for kind, b in (("fwd", 32 if dtype == torch.float32 else 16), ("bwd", 16)):
            ms = plain_ms = bound_ms = dev_ms = cores_ms = 0.0
            by_ops = True
            # the forward's products: 3xTF32 in fp32; bf16 x bf16 for K3's bf16
            # (the sample rounded to bf16); for K2's bf16 (the fp32 sample) the
            # bound is three bf16 products, the kernel takes 2xTF32
            route = "3xtf32" if dtype == torch.float32 else "bf16" if impl == "pallas" else "3xbf16"
            if kind == "bwd":
                route = "3xtf32" if dtype == torch.float32 else "bf16+3xbf16"
            own_ms = 0.0  # K2's bf16: the bound on the kernel's own 2xTF32 route
            for s in LEVELS:
                x, off, mask, w = bounded_inputs(b, s, dtype, gen, dev, 3)
                if kind == "fwd":
                    ms += cuda_time(lambda: run_fwd(x, off, mask, w, 3), iters=10)
                    dev_ms += device_ms(lambda: run_fwd(x, off, mask, w, 3), name=fwd_name)
                    plain_ms += cuda_time(lambda: plain(x, off, mask, w, 3), iters=3, warmup=1)
                    t_bytes, t_ops = dcn_fwd_bound(b, s, x.element_size(), route)
                    cores_ms += max(dcn_fwd_bound(b, s, x.element_size(), "fp32"))
                    own_ms += max(dcn_fwd_bound(b, s, x.element_size(), "2xtf32"))
                    by_ops = by_ops and t_ops >= t_bytes
                    bound_ms += max(t_bytes, t_ops)
                else:
                    g = torch.randn(b, s, s, C, generator=gen).to(dev, dtype)
                    ms += cuda_time(lambda: run_bwd(x, off, mask, w, g, 3), iters=10)
                    dev_ms += device_ms(lambda: run_bwd(x, off, mask, w, g, 3), name=bwd_name)
                    plain_ms += cuda_time(lambda: grads_plain(x, off, mask, w, g, 3), iters=3,
                                          warmup=1)
                    bnd = bwd_bound(b, s, x.element_size())
                    bound_ms += bnd["fast"][0]
                    by_ops = by_ops and bnd["fast"][1]
                    cores_ms += bnd["fp32"][0]
            times[kind][name] = {"max_abs_err": err[kind][name], "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms,
                                 "bound_by": "operations" if by_ops else "bytes", "batch": b,
                                 "device_ms": dev_ms, "bound_route": route,
                                 "bound_ms_fp32_cores": cores_ms}
            if route == "3xbf16":
                times[kind][name]["bound_ms_2xtf32"] = own_ms
            log(f"{fwd_name if kind == 'fwd' else bwd_name} {name} B={b} three levels r=3: kernel "
                f"{ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
                f"{bound_ms:.4f} ms ({times[kind][name]['bound_by']}, {route}; fp32-core bound "
                f"{cores_ms:.4f} ms)")
    return times


def phase_k1_wide(dev, gen):
    """K1 past the flagship-n width. Forward and backward against the plain
    versions at C = Cout = 256 (scales m, l) and 384 (x), the three levels
    at B=16 (a train step's), fp32 and bf16, radius None and 3, with K1's
    limits (the backward past 128 channels runs its wide path of chunk
    pairs); then both timed at 128 (scale s), 256 and 384 beside their
    bounds; and K2 and K3, forward and backward, at 384 on the 80² map
    (B=4, radius 3 and 31) against their plain versions, the backward at the
    fp32 limit in both dtypes (``hold_bounded_bwd``)."""
    import torch

    from yolo_ad_refine_tpu_torch.engine.profile_dcn import device_ms
    from yolo_ad_refine_tpu_torch.ops import deform_mxu, deform_pallas
    from yolo_ad_refine_tpu_torch.ops.deform import (
        dcn_backward, deform_conv2d_grads_plain, deform_conv2d_plain, modulated_deform_conv2d)

    err = {}
    for c in WIDE:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            atol, rtol = K1_TOL[name]
            for radius in (None, 3):
                for s in LEVELS:
                    x, off, mask, w = dcn_inputs(16, s, dtype, gen, dev, c)
                    g = torch.randn(16, s, s, c, generator=gen).to(dev, dtype)
                    args = (nchw(x), nchw(off), nchw(mask), w.permute(3, 2, 0, 1))
                    got = modulated_deform_conv2d(*args, radius).permute(0, 2, 3, 1).float()
                    want = deform_conv2d_plain(x, off, mask, w, radius).float()
                    torch.cuda.synchronize()
                    e_fwd = (got - want).abs().max().item()
                    torch.testing.assert_close(got, want, atol=atol, rtol=rtol, msg=lambda m: (
                        f"K1 {name} C={c} radius={radius} {s}x{s}: {m}"))
                    del got, want
                    label = f"K1 bwd {name} C={c} radius={radius} {s}x{s}"
                    got = grads_nhwc(dcn_backward(*args, nchw(g), radius))
                    want = deform_conv2d_grads_plain(x, off, mask, w, g, radius)
                    torch.cuda.synchronize()
                    rels, e_bwd = hold_grads(label, got, want, K1_BWD_TOL[name])
                    del got, want
                    key = (c, name)
                    err[key] = {"fwd": max(err.get(key, {}).get("fwd", 0.0), e_fwd),
                                "bwd": max(err.get(key, {}).get("bwd", 0.0), e_bwd)}
                    log(f"K1 wide {name:8s} C=Cout={c} radius={str(radius):4s} B=16 {s}x{s}: "
                        f"fwd max |kernel - plain| {e_fwd:.3e} (atol {atol}, rtol {rtol}); bwd max "
                        "|kernel - plain| / max |plain| " + ", ".join(
                            f"{n} {v:.2e}" for n, v in zip(GRADS, rels))
                        + f" (tol {K1_BWD_TOL[name]})")
    torch.cuda.empty_cache()

    times = {}
    for c in (128, *WIDE):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            route = "3xtf32" if dtype == torch.float32 else "bf16"
            t = {"fwd_ms": 0.0, "fwd_device_ms": 0.0, "fwd_bound_ms": 0.0, "bwd_ms": 0.0,
                 "bwd_device_ms": 0.0, "bwd_bound_ms": 0.0}
            for s in LEVELS:
                x, off, mask, w = dcn_inputs(16, s, dtype, gen, dev, c)
                g = torch.randn(16, s, s, c, generator=gen).to(dev, dtype)
                args = (nchw(x), nchw(off), nchw(mask), w.permute(3, 2, 0, 1))
                t["fwd_ms"] += cuda_time(lambda: modulated_deform_conv2d(*args), iters=10)
                t["fwd_device_ms"] += device_ms(lambda: modulated_deform_conv2d(*args), iters=5)
                t["bwd_ms"] += cuda_time(lambda: dcn_backward(*args, nchw(g)), iters=5)
                t["bwd_device_ms"] += device_ms(lambda: dcn_backward(*args, nchw(g)), iters=5)
                t["fwd_bound_ms"] += max(dcn_fwd_bound(16, s, x.element_size(), route, c))
                nbytes, products, other = k1_bwd_work(16, s, x.element_size(), c)
                t["bwd_bound_ms"] += max(nbytes / H100_BYTES_PER_S * 1e3,
                                         products_ms(products, route) + other / FP32_FLOPS * 1e3)
            if (c, name) in err:
                t.update(max_abs_err_fwd=err[(c, name)]["fwd"], max_abs_err_bwd=err[(c, name)]["bwd"])
            times[f"{c} {name}"] = t
            log(f"K1 C=Cout={c} {name} B=16 three levels: fwd {t['fwd_ms']:.4f} ms (device "
                f"{t['fwd_device_ms']:.4f}) against a {route} bound of {t['fwd_bound_ms']:.4f} ms; "
                f"bwd {t['bwd_ms']:.4f} ms (device {t['bwd_device_ms']:.4f}) against "
                f"{t['bwd_bound_ms']:.4f} ms")

    for impl, mod in (("mxu", deform_mxu), ("pallas", deform_pallas)):
        fwd_name, bwd_name, _ = BOUNDED[impl]
        plain = getattr(mod, f"deform_conv2d_{impl}_plain")
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            atol, rtol = K1_TOL[name]
            for r in (3, 31):  # the backward's window mode; both global modes
                x, off, mask, w = bounded_inputs(4, LEVELS[0], dtype, gen, dev, r, 384)
                g = torch.randn(4, LEVELS[0], LEVELS[0], 384, generator=gen).to(dev, dtype)
                args = (nchw(x), nchw(off), nchw(mask), w.permute(3, 2, 0, 1))
                got = getattr(mod, fwd_name)(*args, r).permute(0, 2, 3, 1).float()
                want = plain(x, off, mask, w, r).float()
                torch.cuda.synchronize()
                e = (got - want).abs().max().item()
                torch.testing.assert_close(got, want, atol=atol, rtol=rtol, msg=lambda m: (
                    f"{fwd_name} {name} C=384 r={r}: {m}"))
                del got, want
                got = grads_nhwc(getattr(mod, bwd_name)(*args, nchw(g), r))
                torch.cuda.synchronize()
                if got[1].reshape(4, LEVELS[0], LEVELS[0], 9, 2)[:, :, :, 0::2, 0].any():
                    raise AssertionError(f"{bwd_name} {name} C=384 r={r}: d offset not 0 on an "
                                         "integral axis")
                rels, _ = hold_bounded_bwd(f"{bwd_name} {name} C=384 r={r}", impl, got,
                                           x, off, mask, w, g, r)
                del got
                log(f"{impl} {name:8s} C=Cout=384 r={r:<2d} B=4 {LEVELS[0]}x{LEVELS[0]}: fwd max "
                    f"|kernel - plain| {e:.3e}; bwd max |kernel - plain| / max |plain| "
                    + ", ".join(f"{n} {v:.2e}" for n, v in zip(GRADS, rels))
                    + f" (tol {K1_BWD_TOL['float32']})")
                torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    return times


def phase_gather(dev):
    """The gather probe (``csrc/gather.cu``, the port of bench_dcn.py's
    Pallas probe): bit-equal to its plain version at the probe's shapes in
    bf16 and fp32 and on a batch of wrapped and out-of-range indices; then
    ``engine/profile_gather.py``'s run at batch 32 in both types, the
    probe's path, with the launch counts set to 0 just before it."""
    import torch

    from yolo_ad_refine_tpu_torch.engine.profile_gather import LEVELS as PROBE_LEVELS
    from yolo_ad_refine_tpu_torch.engine.profile_gather import probe_inputs, profile
    from yolo_ad_refine_tpu_torch.ops.gather import gather_rows, gather_rows_plain

    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        cases = [probe_inputs(32, h, w, dtype, dev) for h, w in PROBE_LEVELS]
        x, n = cases[-1][0], cases[-1][0].shape[1]
        cases.append((x, torch.randint(-2 * n, 2 * n, (32, 9 * n), dtype=torch.int32,
                                       generator=torch.Generator().manual_seed(1)).to(dev)))
        for x, idx in cases:
            got, want = gather_rows(x, idx), gather_rows_plain(x, idx)
            max_err = max(max_err, (got.float() - want.float()).abs().max().item())
            if not torch.equal(got, want):
                raise AssertionError(f"gather {dtype} {tuple(idx.shape)}: kernel differs from "
                                     "plain")
        log(f"gather {str(dtype).split('.')[1]}: bit-equal to plain at the probe's shapes (B=32, "
            f"80², 40², 20², C=64) and on indices in [-2N, 2N) ({int((want == 0).all(-1).sum())} "
            "rows of fill)")
    torch.cuda.synchronize()
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    res = {name: profile(32, getattr(torch, name), dev) for name in ("bfloat16", "float32")}
    res["max_abs_err"] = max_err
    launches = {k: f.launches for k, f in counters.items()}
    for name in ("bfloat16", "float32"):
        t = res[name]["total"]
        log(f"gather {name} B=32 three levels: kernel {t['ms']:.4f} ms (device "
            f"{t['device_ms']:.4f}), bound {t['bound_ms']:.4f} ms (bytes), torch.gather "
            f"{t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms")
    return res, launches


class dcn_env:
    """Set YAT_DCN_IMPL (and YAT_DCN_RADIUS) for one phase, and restore both."""

    def __init__(self, impl: str | None, radius: int | None = None):
        self.want = {"YAT_DCN_IMPL": impl, "YAT_DCN_RADIUS": None if radius is None else str(radius)}

    @staticmethod
    def _apply(values: dict):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.want}
        self._apply(self.want)

    def __exit__(self, *exc):
        self._apply(self.saved)


# (B, K) of the NMS kernels' further synthetic cases, beside a serving
# batch (K4, B = 32) or an OBB batch (K5, B = 16) at max_nms 2048: a ragged
# K, one candidate, max_nms 4096, a ragged last word past 64 words, and twice
# a serving batch
NMS_SHAPES = ((3, 1000), (1, 1), (2, 4096), (3, 4100), (64, 2048))
NMS_IOU = 0.7


def nms_variants(data, scores, gen):
    """(label, data, scores, conf) of the synthetic batch's cases: conf
    0.001; no valid row (conf 1.0, the top score); every row valid (conf
    -1); and unsorted scores with valid and invalid rows interleaved (the
    scores permuted along K, conf 0.5)."""
    import torch

    perm = torch.randperm(scores.shape[1], generator=gen).to(scores.device)
    return [("conf 0.001", data, scores, 0.001), ("no valid row", data, scores, 1.0),
            ("every row valid", data, scores, -1.0),
            ("unsorted, interleaved", data, scores[:, perm].contiguous(), 0.5)]


def phase_k4(dev, gen):
    """NMS suppression kernel vs plain: exactly equal keep masks on
    synthetic candidates (a serving batch under ``nms_variants``, the
    shapes of NMS_SHAPES) and on the candidates of one flagship predict
    batch at conf 0.001 and 0.25; timing, split into mask and walk."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.engine.profile_nms import (
        Impl, predict_candidates, synthetic_candidates, time_case)
    from yolo_ad_refine_tpu_torch.ops.nms import suppress, suppress_plain

    boxes, scores = synthetic_candidates(32, 2048, gen, dev)
    cases = [(f"synthetic, {v}", *rest) for v, *rest in nms_variants(boxes, scores, gen)]
    cases += [("synthetic, conf 0.001", *synthetic_candidates(b, k, gen, dev), 0.001)
              for b, k in NMS_SHAPES]
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (*SERVING_SHAPES[i % len(SERVING_SHAPES)], 3), dtype=np.uint8)
            for i in range(32)]
    real = predict_candidates(YOLO(FLAGSHIP, device=dev, imgsz=640, seed=0), imgs, 640,
                              (0.001, 0.25))
    cases += [(f"one flagship predict batch, conf {c}", *v, c) for c, v in real.items()]
    differ = 0  # keep-mask entries where kernel and plain disagree, over every case
    for label, bx, sc, conf in cases:
        got = suppress(bx, sc, NMS_IOU, conf)
        want = suppress_plain(bx, sc, NMS_IOU, conf)
        n = int((got != want).sum())
        differ += n
        b, k = sc.shape
        if n or not torch.equal(got, want):
            raise AssertionError(f"K4 keep mask differs from plain at B={b} K={k} ({label}): "
                                 f"{n} entries")
        log(f"K4 B={b} K={k} ({label}): keep mask equal to plain ({int(got.sum())} kept of "
            f"{int((sc > conf).sum())} valid)")
    t = time_case(Impl(), "K4", boxes, scores, 0.001)
    plain_ms = cuda_time(lambda: suppress_plain(boxes, scores, NMS_IOU, 0.001), iters=3, warmup=1)
    keep = t["keep"]
    b, k = scores.shape
    # work this data needs: each kept candidate's IoU against every later one
    idx = torch.arange(k, device=dev)
    pairs = int(((k - 1 - idx)[None, :] * keep).sum())
    flops = pairs * 15 + b * k * 3
    nbytes = b * k * (16 + 4 + 1)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    log(f"K4 B={b} K={k}: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f}: mask "
        f"{t['mask_ms']:.4f}, walk {t['walk_ms']:.4f}), plain {plain_ms:.3f} ms, "
        f"bound {max(t_bytes, t_ops):.5f} ms ({pairs} IoU pairs)")
    batch = {}
    for c, v in real.items():
        r = time_case(Impl(), "K4", *v, c)
        batch[f"conf {c}"] = {n: r[n] for n in ("ms", "device_ms", "mask_ms", "walk_ms")}
        log(f"K4 on the flagship predict batch's candidates at conf {c} "
            f"(B={v[1].shape[0]}, K={v[1].shape[1]}): kernel "
            f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}: mask {r['mask_ms']:.4f}, walk "
            f"{r['walk_ms']:.4f}), {r['kept']} kept of {r['valid']} valid")
    return {"max_abs_err": float(differ), "ms": t["ms"], "device_ms": t["device_ms"],
            "parts": {"mask_ms": t["mask_ms"], "walk_ms": t["walk_ms"]}, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "predict_batch": batch}


def obb_model(dev):
    """yolo11n-obb at imgsz 1024 with seeded weights. Its class biases take
    the flagship head's prior, sigmoid(b) = 0.01 (AYHead.bias_init), in
    place of Detect's (sigmoid(b) of about 5e-5 at nc 15), so that
    conf=0.001 hands NMS a full candidate set, as in the serving phase."""
    import torch

    from yolo_ad_refine_tpu_torch import YOLO

    t0 = time.perf_counter()
    model = YOLO(OBB_CFG, task="obb", device=dev, imgsz=OBB_IMGSZ, seed=0)
    with torch.no_grad():
        for seq in model.model.model[model.model.head_idx].cv3:
            seq[-1].bias.fill_(-math.log((1 - 0.01) / 0.01))
    log(f"OBB: {OBB_CFG} built on {dev} in {time.perf_counter() - t0:.1f} s, "
        f"{model.model.num_params():,} parameters, task {model.task}, strides "
        f"{model.model.strides}")
    return model


def obb_images(n: int, seed: int):
    """n seeded uint8 images: 1024² tiles, every 8th of another shape."""
    import numpy as np

    rng = np.random.default_rng(seed)
    others = [(800, 800), (1080, 1920), (1200, 1000), (960, 1280)]
    return [rng.integers(0, 256, (*(others[(i // 8) % 4] if i % 8 == 7 else (1024, 1024)), 3),
                         dtype=np.uint8) for i in range(n)]


def phase_k5(dev, gen, model):
    """Rotated NMS kernel vs plain: equal keep masks but for printed
    rounding ties (ops/nms.py:rotated_rounding_ties) on synthetic
    candidates (an OBB batch under ``nms_variants``, the shapes of
    NMS_SHAPES) and on the candidates of one OBB predict batch at conf 0.001
    and 0.25; timing, split into mask and walk."""
    import torch

    from yolo_ad_refine_tpu_torch.engine.profile_nms import (
        Impl, predict_candidates, synthetic_rotated_candidates, time_case)
    from yolo_ad_refine_tpu_torch.ops.nms import (
        rotated_rounding_ties, suppress_rotated, suppress_rotated_plain)

    rb, scores = synthetic_rotated_candidates(16, 2048, gen, dev)
    cases = [(f"synthetic, {v}", *rest) for v, *rest in nms_variants(rb, scores, gen)]
    cases += [("synthetic, conf 0.001", *synthetic_rotated_candidates(b, k, gen, dev), 0.001)
              for b, k in NMS_SHAPES]
    real = predict_candidates(model, obb_images(16, 3), OBB_IMGSZ, (0.001, 0.25), rotated=True)
    cases += [(f"one OBB predict batch, conf {c}", *v, c) for c, v in real.items()]
    differ = ties = 0
    for label, r, sc, conf in cases:
        got = suppress_rotated(r, sc, NMS_IOU, conf)
        want = suppress_rotated_plain(r, sc, NMS_IOU, conf)
        torch.cuda.synchronize()
        n = int((got != want).sum())
        t = rotated_rounding_ties(got, want, r, sc, NMS_IOU, conf)  # raises on a non-tie
        differ, ties = differ + n, ties + t
        b, k = sc.shape
        log(f"K5 B={b} K={k} ({label}): {int(got.sum())} kept of {int((sc > conf).sum())} "
            f"valid; {n} keep-mask entries differ from plain, {t} of them rounding ties "
            f"(probiou within 1e-5 of iou 0.7; each difference held against a replay of the "
            f"plain walk), the rest following from them")
    t = time_case(Impl(), "K5", rb, scores, 0.001)
    plain_ms = cuda_time(lambda: suppress_rotated_plain(rb, scores, NMS_IOU, 0.001), iters=3,
                         warmup=1)
    keep = t["keep"]
    b, k = scores.shape
    # work this data needs: each kept candidate's probiou against every later
    # one, ~40 operations a pair (log, exp, sqrt and division one each), and
    # ~20 a candidate for its Gaussian; rboxes and scores read, keep written
    idx = torch.arange(k, device=dev)
    pairs = int(((k - 1 - idx)[None, :] * keep).sum())
    flops = pairs * 40 + b * k * 20
    nbytes = b * k * (20 + 4 + 1)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    log(f"K5 B={b} K={k}: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f}: mask "
        f"{t['mask_ms']:.4f}, walk {t['walk_ms']:.4f}), plain {plain_ms:.3f} ms, "
        f"bound {max(t_bytes, t_ops):.5f} ms ({pairs} probiou pairs)")
    batch = {}
    for c, v in real.items():
        r = time_case(Impl(), "K5", *v, c)
        batch[f"conf {c}"] = {n: r[n] for n in ("ms", "device_ms", "mask_ms", "walk_ms")}
        log(f"K5 on the OBB predict batch's candidates at conf {c} "
            f"(B={v[1].shape[0]}, K={v[1].shape[1]}): kernel "
            f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}: mask {r['mask_ms']:.4f}, walk "
            f"{r['walk_ms']:.4f}), {r['kept']} kept of {r['valid']} valid")
    return {"max_abs_err": float(differ), "ms": t["ms"], "device_ms": t["device_ms"],
            "parts": {"mask_ms": t["mask_ms"], "walk_ms": t["walk_ms"]}, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "rounding_ties": ties,
            "predict_batch": batch}


def phase_obb_serving(model, dev):
    """The OBB predict path on the card at batch 16, imgsz 1024, fp32,
    conf 0.001, then one 2-image batch against the same model on the CPU."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch.engine.predictor import preprocess

    imgs = obb_images(32, 0)
    model.predict(imgs[:16], conf=0.001, batch=16)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    counters = kernel_counters()
    seconds = []
    for _ in range(3):
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        results = model.predict(imgs, conf=0.001, batch=16)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = {k: f.launches for k, f in counters.items()}
        if launches["nms_rotated"] != 2:
            raise AssertionError(f"K5 was not launched once a batch on the OBB predict path: "
                                 f"{launches}")
    dt = sorted(seconds)[1]
    log(f"OBB serving: 32 images, batch 16, imgsz {OBB_IMGSZ}, fp32: {32 / dt:.1f} images/s, "
        f"{dt / 2 * 1e3:.1f} ms/batch (median of 3 runs: "
        + ", ".join(f"{32 / s:.1f}" for s in seconds)
        + " images/s; host clock, preprocess + forward + NMS + results)")
    log(f"OBB serving: launches per run of the path: {launches}")
    if len(results) != 32:
        raise AssertionError(f"expected 32 results, got {len(results)}")
    for im, r in zip(imgs, results):
        d = r.obb.data
        if not (0 < len(d) <= 300 and len(r.boxes) == len(d) and np.isfinite(d).all()
                and np.isfinite(r.boxes.data).all()):
            raise AssertionError(f"bad OBB detections for an image of shape {im.shape}: {d.shape}")
    log(f"OBB serving: {sum(len(r) for r in results)} rotated detections, all finite")

    x, _ = preprocess(imgs[:2], OBB_IMGSZ, 2, torch.device(dev), torch.float32)
    with torch.inference_mode():
        y_gpu = model.model(x)[0].float().cpu()
        y_cpu = copy.deepcopy(model.model).cpu()(x.cpu())[0]
    nc = model.model.nc
    errs = {"box": (y_gpu[..., :4] - y_cpu[..., :4]).abs().max().item(),
            "score": (y_gpu[..., 4:4 + nc] - y_cpu[..., 4:4 + nc]).abs().max().item(),
            "angle": (y_gpu[..., 4 + nc:] - y_cpu[..., 4 + nc:]).abs().max().item()}
    log(f"OBB serving: card vs CPU on 2 images: max |box diff| {errs['box']:.3e} px (tol 5e-2), "
        f"max |score diff| {errs['score']:.3e}, max |angle diff| {errs['angle']:.3e} rad "
        "(tol 1e-3)")
    n_anchors = sum((OBB_IMGSZ // s) ** 2 for s in model.model.strides)  # 21504 at 1024
    if not (y_gpu.shape == (2, n_anchors, 4 + nc + 1) and torch.isfinite(y_gpu).all()):
        raise AssertionError(f"bad decoded OBB predictions {tuple(y_gpu.shape)}")
    if errs["box"] > 5e-2 or errs["score"] > 1e-3 or errs["angle"] > 1e-3:
        raise AssertionError("card and CPU OBB predictions disagree")
    return launches


def phase_obb_val(model, dev):
    """``.val`` of the OBB model on a seeded DOTA-format set of 16 tiles of
    1024² at batch 8: K5 once a batch, finite metrics, and the metrics
    within 1e-3 of the same validation on the CPU. Each tile is labelled
    with the model's own 3 best rotated detections: random labels would
    give mAP 0 on the card and the CPU alike and prove nothing."""
    import cv2
    import torch

    from yolo_ad_refine_tpu_torch.data.synthetic import make_dota_dataset
    from yolo_ad_refine_tpu_torch.engine.results import OBBoxes

    with tempfile.TemporaryDirectory(prefix="chip_smoke_obb_") as tmp:
        t0 = time.perf_counter()
        root = Path(tmp) / "dota"
        data = make_dota_dataset(root, n_val=16, imgsz=OBB_IMGSZ, seed=0)
        files = sorted((root / "val" / "images").glob("*.png"))
        for f, r in zip(files, model.predict([cv2.imread(str(f)) for f in files], conf=0.001,
                                             batch=16)):
            quads = OBBoxes(r.obb.data[:3], r.orig_shape).xyxyxyxy / OBB_IMGSZ
            (root / "val" / "labels" / f"{f.stem}.txt").write_text("".join(
                f"{int(c)} " + " ".join(f"{v:.6f}" for v in q.reshape(-1)) + "\n"
                for q, c in zip(quads, r.obb.cls[:3])))
        log(f"OBB val: DOTA-format set (16 tiles of {OBB_IMGSZ}², 15 classes) written and "
            f"labelled in {time.perf_counter() - t0:.1f} s")
        args = {"data": data, "imgsz": OBB_IMGSZ, "batch": 8, "conf": 0.001}
        counters = kernel_counters()
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        metrics = model.val(**args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        cpu = copy.deepcopy(model)
        cpu.model = cpu.model.cpu()
        t1 = time.perf_counter()
        want = cpu.val(**args)
        cpu_s = time.perf_counter() - t1
    log(f"OBB val: 16 images at batch 8 in {wall:.2f} s, {wall / 16 * 1e3:.1f} ms an image "
        f"(host clock, loader to metrics; the validator's own: "
        f"{metrics['speed_ms_per_image']:.1f} ms, of it inference + NMS "
        f"{metrics['inference_ms_per_image']:.1f} ms); launches {launches}")
    keys = ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
            "metrics/mAP50-95(B)", "fitness")
    log("OBB val: card " + ", ".join(f"{k} {metrics[k]:.6f}" for k in keys))
    log(f"OBB val: CPU ({cpu_s:.1f} s) " + ", ".join(f"{k} {want[k]:.6f}" for k in keys)
        + " (tol 1e-3)")
    if launches["nms_rotated"] != 2:
        raise AssertionError(f"K5 was not launched once a batch in the OBB validation: {launches}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite OBB val metrics {metrics}")
    if metrics["metrics/mAP50(B)"] <= 0.05 or any(abs(metrics[k] - want[k]) > 1e-3 for k in keys):
        raise AssertionError("the card's OBB val metrics are vacuous or disagree with the CPU's")
    return launches


def kernel_counters():
    """Every kernel wrapper, by the name of its entry in the kernels line."""
    from yolo_ad_refine_tpu_torch.ops import deform_mxu, deform_pallas
    from yolo_ad_refine_tpu_torch.ops.deform import dcn_backward, modulated_deform_conv2d
    from yolo_ad_refine_tpu_torch.ops.gather import gather_rows
    from yolo_ad_refine_tpu_torch.ops.nms import suppress, suppress_rotated

    return {"dcn_forward": modulated_deform_conv2d, "dcn_backward": dcn_backward,
            "dcn_separable_forward": deform_mxu.dcn_separable_forward,
            "dcn_separable_backward": deform_mxu.dcn_separable_backward,
            "dcn_window_forward": deform_pallas.dcn_window_forward,
            "dcn_window_backward": deform_pallas.dcn_window_backward,
            "nms_suppress": suppress, "nms_rotated": suppress_rotated, "gather_rows": gather_rows}


def dcn_kernels(impl: str | None) -> tuple[str, str]:
    """The (forward, backward) kernels DyDCNv2 runs under YAT_DCN_IMPL=impl."""
    return BOUNDED[impl][:2] if impl in BOUNDED else ("dcn_forward", "dcn_backward")


def phase_serving(dev):
    """The flagship's predict path on the card, then one 2-image batch
    against the same model on the CPU."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.engine.predictor import preprocess

    t0 = time.perf_counter()
    model = YOLO(FLAGSHIP, device=dev, imgsz=640, seed=0)
    log(f"serving: flagship built on {dev} in {time.perf_counter() - t0:.1f} s, "
        f"{model.model.num_params():,} parameters, strides {model.model.strides}")
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (*SERVING_SHAPES[i % len(SERVING_SHAPES)], 3), dtype=np.uint8)
            for i in range(64)]
    model.predict(imgs[:32], conf=0.001, batch=32)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

    # three timed runs of the path: the host clock here varies from run to run
    seconds = []
    counters = kernel_counters()
    for _ in range(3):
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        results = model.predict(imgs, conf=0.001, batch=32)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = {k: f.launches for k, f in counters.items()}
        if launches["dcn_forward"] == 0 or launches["nms_suppress"] == 0:
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


def phase_serving_variant(dev, impl: str):
    """The flagship's predict path under YAT_DCN_IMPL=impl: 32 images at
    batch 32, imgsz 640, fp32, which must launch the variant's forward
    kernel once a level and no other DCN kernel; then 2 images against the
    same model on the CPU under the same variable (its plain version), within
    the serving limits."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.engine.predictor import preprocess

    fwd_k = dcn_kernels(impl)[0]
    with dcn_env(impl):
        model = YOLO(FLAGSHIP, device=dev, imgsz=640, seed=0)
        rng = np.random.default_rng(5)
        imgs = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(32)]
        model.predict(imgs, conf=0.001, batch=32)  # warm-up
        torch.cuda.synchronize()
        counters = kernel_counters()
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        results = model.predict(imgs, conf=0.001, batch=32)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        dcn = {k: v for k, v in launches.items() if k.startswith("dcn_")}
        if dcn != {**{k: 0 for k in dcn}, fwd_k: 3} or launches["nms_suppress"] != 1:
            raise AssertionError(f"serving ({impl}) did not launch {fwd_k} alone once a level: "
                                 f"{launches}")
        if not all(0 < len(r) <= 300 and np.isfinite(r.boxes.data).all() for r in results):
            raise AssertionError(f"serving ({impl}): bad detections")
        x, _ = preprocess(imgs[:2], 640, 2, torch.device(dev), torch.float32)
        with torch.inference_mode():
            y_gpu = model.model(x)[0].float().cpu()
            y_cpu = copy.deepcopy(model.model).cpu()(x.cpu())[0]
    box_err = (y_gpu[..., :4] - y_cpu[..., :4]).abs().max().item()
    score_err = (y_gpu[..., 4:] - y_cpu[..., 4:]).abs().max().item()
    log(f"serving ({impl}): 32 images, batch 32, imgsz 640, fp32 in {dt * 1e3:.1f} ms "
        f"({32 / dt:.1f} images/s, host clock, one run); launches {dcn}; card vs CPU on 2 "
        f"images: max |box diff| {box_err:.3e} px (tol 5e-2), max |score diff| {score_err:.3e} "
        "(tol 1e-3)")
    if box_err > 5e-2 or score_err > 1e-3 or not torch.isfinite(y_gpu).all():
        raise AssertionError(f"serving ({impl}): card and CPU predictions disagree")
    return launches


def phase_folder_serving(dev):
    """The flagship served from a directory and a video file, the way its
    users serve image folders and camera recordings: 64 seeded JPEGs of the
    serving phase's 8 shapes and a 24-frame MJPG video at 1280x720, through
    ``YOLO.predict(source=<dir or file>, batch=32, imgsz=640, save=True,
    save_txt=True, save_conf=True, save_crop=True, project=<tmp>)``
    (conf 0.001, max_det 20). The run must launch K1 fwd and K4; every image
    and frame gets its label file, whose rows equal its results' boxes
    within 1e-3 (normalised); the video at vid_stride 3 gives 8 frames.
    images/s of the folder with and without the save options and of the
    same decoded images as numpy arrays are printed (host clock)."""
    import cv2
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import YOLO

    model = YOLO(FLAGSHIP, device=dev, imgsz=640, seed=0)
    counters = kernel_counters()
    opts = dict(batch=32, imgsz=640, conf=0.001, max_det=20)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_folder_") as tmp:
        root = Path(tmp)
        rng = np.random.default_rng(7)
        folder = root / "images"
        folder.mkdir()
        for i in range(64):
            h, w = SERVING_SHAPES[i % len(SERVING_SHAPES)]
            cv2.imwrite(str(folder / f"im{i:02d}.jpg"), rng.integers(0, 256, (h, w, 3), np.uint8))
        video = root / "clip.avi"
        vw = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"MJPG"), 24, (1280, 720))
        for _ in range(24):
            vw.write(rng.integers(0, 256, (720, 1280, 3), np.uint8))
        vw.release()
        t0 = time.perf_counter()
        decoded = [cv2.imread(str(f)) for f in sorted(folder.glob("*.jpg"))]
        decode_ms = (time.perf_counter() - t0) * 1e3
        jpeg_mb = sum(f.stat().st_size for f in folder.glob("*.jpg")) / 1e6
        model.predict(decoded[:32], **opts)  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()

        rate = {}
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        results = model.predict(source=str(folder), project=str(root / "runs"), save=True,
                                save_txt=True, save_conf=True, save_crop=True, **opts)
        torch.cuda.synchronize()
        rate["folder, save options"] = 64 / (time.perf_counter() - t0)
        launches = {k: f.launches for k, f in counters.items()}
        if launches["dcn_forward"] != 6 or launches["nms_suppress"] != 2:
            raise AssertionError(f"folder serving did not launch K1 fwd and K4 once a batch: "
                                 f"{launches}")
        for label, src in (("folder", str(folder)), ("numpy arrays", decoded)):
            t0 = time.perf_counter()
            model.predict(source=src, **opts)
            torch.cuda.synchronize()
            rate[label] = 64 / (time.perf_counter() - t0)
        run = root / "runs" / "predict"
        t0 = time.perf_counter()
        vres = model.predict(source=str(video), project=str(root / "runs"), save=True,
                             save_txt=True, save_conf=True, save_crop=True, **opts)
        torch.cuda.synchronize()
        rate["video, save options"] = 24 / (time.perf_counter() - t0)
        vrun = root / "runs" / "predict2"
        checked = rows = 0
        for out_dir, res, stems in ((run, results, [f"im{i:02d}" for i in range(64)]),
                                    (vrun, vres, [f"clip_{i}" for i in range(1, 25)])):
            if len(res) != len(stems):
                raise AssertionError(f"expected {len(stems)} results, got {len(res)}")
            for r, stem in zip(res, stems):
                f = out_dir / "labels" / f"{stem}.txt"
                got = np.loadtxt(f, ndmin=2)
                d = r.boxes
                if not (0 < len(d) == len(got) and (out_dir / f"{stem}.jpg").exists()):
                    raise AssertionError(f"{f}: {len(got)} rows for {len(d)} boxes, or no image")
                want = np.concatenate([d.cls[:, None], d.xywhn, d.conf[:, None]], 1)
                err = np.abs(got - want).max()
                if err > 1e-3:
                    raise AssertionError(f"{f}: rows differ from the results by {err:.2e}")
                checked, rows = checked + 1, rows + len(got)
        crops = len(list((run / "crops").rglob("*.jpg"))) + len(list((vrun / "crops").rglob("*.jpg")))
        stride = model.predict(source=str(video), vid_stride=3, **opts)
        if [r.path.rsplit("#", 1)[1] for r in stride] != [str(i) for i in range(3, 25, 3)]:
            raise AssertionError(f"vid_stride 3 gave frames {[r.path for r in stride]}")
    log(f"folder serving: 64 JPEGs (8 shapes) and a 24-frame 1280x720 MJPG video, batch 32, "
        f"imgsz 640: {checked} label files ({rows} rows) equal to their results within 1e-3, "
        f"{crops} crops, annotated images; vid_stride 3 gave frames 3..24 by 3; launches in the "
        f"folder run {launches}")
    log("folder serving: images/s (host clock, one run each): "
        + ", ".join(f"{k} {v:.1f}" for k, v in rate.items())
        + f"; cv2.imread of the 64 JPEGs ({jpeg_mb:.1f} MB of seeded noise, the costliest "
        f"content to decode) alone {decode_ms:.1f} ms on one host thread")
    return launches, rate


def phase_training(dev, impl: str | None = None, cfg: str = FLAGSHIP):
    """YOLO(cfg).train on the card under YAT_DCN_IMPL=impl: 1 epoch of 4
    steps at batch 16, imgsz 640, bf16, then the EMA validation, checkpoints
    and a reload of best. Each step launches the variant's forward and
    backward kernel 3 times each (one a level) and no other DCN kernel.
    ``cfg`` FLAGSHIP_X trains the flagship at scale x, whose DCN backward
    (C = Cout = 384) runs K1 bwd's wide path.
    Under ``pallas`` the reload also widens the radius: best's meta.yaml
    gets dcn_offset_max 11.5, the reloaded head must clip at 13, and one
    predict batch runs K3 at that radius."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset

    counters = kernel_counters()
    label = (impl or "auto") + ("" if cfg == FLAGSHIP else f", {cfg}")

    def counts():
        return {k: f.launches for k, f in counters.items()}

    with dcn_env(impl), tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t0 = time.perf_counter()
        data = make_shapes_dataset(Path(tmp) / "shapes", n_train=64, n_val=16, imgsz=640, seed=0)
        log(f"training ({label}): synthetic shapes set (64 train, 16 val, 640 px) written in "
            f"{time.perf_counter() - t0:.1f} s")
        model = YOLO(cfg, device=dev, imgsz=640, seed=0)
        log(f"training ({label}): {model.model.num_params():,} parameters, DCN at C = Cout = "
            f"{model.model.model[model.model.head_idx].DyDCNV2.conv.weight.shape[0]}")
        steps, grad_checks = [], []
        mark = {}

        def on_batch_start(trainer):
            torch.cuda.synchronize()
            mark["counts"], mark["t"] = counts(), time.perf_counter()
            if "end" in mark:
                steps[-1]["data_s"] = mark["t"] - mark["end"]

        def on_batch_end(trainer):
            torch.cuda.synchronize()
            mark["end"] = time.perf_counter()
            now = counts()
            steps.append({"s": mark["end"] - mark["t"],
                          **{k: now[k] - mark["counts"][k] for k in now}})
            mark["after_steps"] = now
            head = trainer.model.model[trainer.model.head_idx]
            if len(steps) == 1:  # accumulating: the grads are there until the 4th batch steps
                for name, p in (("DyDCNV2.conv.weight", head.DyDCNV2.conv.weight),
                                ("spatial_conv_offset.weight", head.spatial_conv_offset.weight)):
                    g = p.grad
                    ok = g is not None and bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0)
                    grad_checks.append((name, ok, 0.0 if g is None else g.norm().item()))

        model.add_callback("on_train_batch_start", on_batch_start)
        model.add_callback("on_train_batch_end", on_batch_end)
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        results = model.train(data=data, epochs=1, batch=16, imgsz=640, amp=True, plots=False,
                              project=str(Path(tmp) / "runs"), workers=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        trainer = model.trainer
        fwd_k, bwd_k = dcn_kernels(impl)
        others = [k for k in counters if k.startswith("dcn_") and k not in (fwd_k, bwd_k)]
        log(f"training ({label}): {len(steps)} steps + validation in {wall:.1f} s; "
            f"bf16 autocast: {trainer.amp_dtype is not None}; launches in the run: {launches}")
        if len(steps) != 4:
            raise AssertionError(f"expected 4 train steps, got {len(steps)}")
        for i, st in enumerate(steps):
            log(f"training ({label}): step {i + 1}: {st['s'] * 1e3:.1f} ms, launches "
                f"{fwd_k} {st[fwd_k]}, {bwd_k} {st[bwd_k]}"
                + (f", data wait after it {st['data_s'] * 1e3:.1f} ms" if "data_s" in st else ""))
            if st[fwd_k] != 3 or st[bwd_k] != 3 or any(st[k] for k in others):
                raise AssertionError(f"step {i + 1}: {fwd_k} / {bwd_k} launched {st[fwd_k]} / "
                                     f"{st[bwd_k]} times, expected 3 / 3, and the other DCN "
                                     f"kernels {[st[k] for k in others]}, expected none")
        if trainer.amp_dtype is None:
            raise AssertionError("training did not run in bf16 (the AMP canary failed)")
        for name, ok, norm in grad_checks:
            log(f"training ({label}): after step 1, |grad {name}| = {norm:.4e}")
            if not ok:
                raise AssertionError(f"gradient of {name} is missing, not finite or all zero")
        val = {k: launches[k] - mark["after_steps"][k] for k in launches}
        log(f"training ({label}): launches in the validations after the steps: {val}")
        if val[fwd_k] == 0 or val["nms_suppress"] == 0 or any(val[k] for k in others):
            raise AssertionError(f"the validation did not launch {fwd_k} and K4 alone")
        csv = (Path(results["save_dir"]) / "results.csv").read_text().splitlines()
        row = dict(zip(csv[0].split(","), csv[1].split(",")))
        losses = [float(row[k]) for k in ("train/box_loss", "train/cls_loss", "train/dfl_loss")]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"non-finite train losses {losses}")
        per_step = {k: steps[-1][k] for k in launches}
        ms = statistics.median(st["s"] for st in steps[1:]) * 1e3
        log(f"training ({label}): {ms:.1f} ms per train step (median of steps 2-4, host clock with a "
            f"synchronise), {16 / ms * 1e3:.1f} images/s at batch 16, imgsz 640, bf16")
        log(f"training ({label}): results.csv losses box {losses[0]:.4f} cls {losses[1]:.4f} "
            f"dfl {losses[2]:.4f}; mAP50 {results.get('metrics/mAP50(B)', 0.0):.4f}, "
            f"dcn_offset_max {row['train/dcn_offset_max']}")

        best = Path(results["save_dir"]) / "weights" / "best"
        reloaded = YOLO(str(best), device=dev)
        img = np.random.default_rng(1).integers(0, 256, (480, 640, 3), dtype=np.uint8)
        res = reloaded.predict([img], imgsz=640, conf=0.001)
        if not (len(res) == 1 and np.isfinite(res[0].boxes.data).all()):
            raise AssertionError("the reloaded best checkpoint did not predict")
        log(f"training ({label}): {best.name} reloaded ({reloaded.model.num_params():,} parameters) and "
            f"predicted {len(res[0])} boxes")
        extra = {} if impl != "pallas" else {"reload_r13_run": reload_widened(best, dev)}
    return launches, per_step, extra


def reload_widened(best: Path, dev) -> dict:
    """A copy of ``best`` whose meta.yaml says dcn_offset_max 11.5 reloads
    with the DCN radius widened to ceil(11.5) + 1 = 13 and serves one batch
    of 8 images through K3 at that radius; returns the launch counts."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.utils import yaml_load, yaml_save

    wide = best.parent / "best_offsets_11.5"
    shutil.copytree(best, wide)
    meta = yaml_load(wide / "meta.yaml")
    yaml_save(wide / "meta.yaml", {**meta, "dcn_offset_max": 11.5})
    model = YOLO(str(wide), device=dev)
    head = model.model.model[model.model.head_idx]
    if head.dcn_radius != 13 or head.DyDCNV2.radius != 13:
        raise AssertionError(f"dcn_offset_max 11.5 gave radius {head.dcn_radius} / "
                             f"{head.DyDCNV2.radius}, expected 13")
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(8)]
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    res = model.predict(imgs, imgsz=640, conf=0.001, batch=8)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    dcn = {k: v for k, v in launches.items() if k.startswith("dcn_")}
    if dcn != {**{k: 0 for k in dcn}, "dcn_window_forward": 3}:
        raise AssertionError(f"the widened reload did not run K3 alone, once a level: {dcn}")
    if not (len(res) == 8 and all(np.isfinite(r.boxes.data).all() for r in res)):
        raise AssertionError("the widened reload did not predict")
    log(f"reload: dcn_offset_max 11.5 -> DCN radius {head.dcn_radius:g}; 8 images served with "
        f"K3 at radius 13, {sum(len(r) for r in res)} boxes; launches {dcn}")
    return launches


def phase_step_card_vs_cpu(dev):
    """One fp32 SGD train step (TF32 off) at imgsz 256, batch 2, on the card
    and on the CPU from the same weights and batch: the loss within 1e-4
    relative and each gradient leaf within LEAF_TOL relative norm. Which
    leaves the limit binds is a property of the leaf: where the CPU's fp32
    gradient lies more than LEAF_TOL / 4 relative from the same step in
    fp64, its sum cancels (a conv bias ahead of a train-mode BatchNorm, a
    scalar gate) and fp32 rounding alone nears the limit. Such a leaf is
    held against the fp64 step instead: the card within 4 times the CPU
    fp32's own distance from it. The same card step with TF32 on is the
    lower-precision control: its readings are printed, not held. The card
    steps run with PyTorch's deterministic algorithms (cuDNN's included),
    as the CPU's do, so that their readings do not move from run to run
    with the order of a library's atomics; the ops that have no
    deterministic version are printed. K1 bwd keeps its sums in fp64 for
    the same reason. A second run of the fp32 card step gives each
    cancelling leaf's run-to-run spread; it is printed beside the leaf's
    reading and not held."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch.models.model import build_detection_model
    from yolo_ad_refine_tpu_torch.train.loss import DetectionLoss
    from yolo_ad_refine_tpu_torch.train.optim import ModelEMA, build_optimizer
    from yolo_ad_refine_tpu_torch.train.step import TrainStep, images_to_tensor

    r = np.random.default_rng(2)
    xy = r.uniform(0, 180, (2, 8, 2))
    boxes = np.concatenate([xy, xy + r.uniform(16, 70, (2, 8, 2))], -1).astype(np.float32)
    mask = (np.arange(8)[None, :, None] < np.array([[[6]], [[4]]])).astype(np.float32)
    batch = {"img": r.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8),
             "cls": r.integers(0, 3, (2, 8, 1)).astype(np.float32),
             "bboxes": boxes * mask, "mask": mask}
    base = build_detection_model(FLAGSHIP, nc=3, device="cpu", seed=3, imgsz=256)
    opt_kw = dict(optimizer="SGD", epochs=1, nb=1, batch=2, nbs=2, warmup_epochs=0.0, nc=3)

    def step(model):
        grads = {}
        for name, p in model.named_parameters():
            p.register_post_accumulate_grad_hook(
                lambda t, name=name: grads.__setitem__(name, t.grad.detach().double().cpu()))
        opt, _, _ = build_optimizer(model.named_parameters(), **opt_kw)
        m = TrainStep(model, DetectionLoss(nc=3, strides=(8, 16, 32)), opt, ModelEMA(model))(batch)
        return m["loss"].item(), grads

    loss_cpu, g_cpu = step(copy.deepcopy(base))
    m64 = copy.deepcopy(base).double().train()
    out = DetectionLoss(nc=3, strides=(8, 16, 32))(
        m64(images_to_tensor(batch["img"], "cpu").double()),
        *(torch.from_numpy(batch[k]).double() for k in ("cls", "bboxes", "mask")))
    out.total.backward()
    g64 = {n: p.grad.detach() for n, p in m64.named_parameters() if p.grad is not None}
    cpu_off = {n: (g - g64[n]).norm().item() for n, g in g_cpu.items()}
    cancels = {n for n, off in cpu_off.items() if off > LEAF_TOL / 4 * g64[n].norm().item()}

    def compare(label, loss, grads):
        """(loss rel, leaves over the limit, worst card / CPU distance from
        fp64 among the cancelling leaves), with the readings logged."""
        if set(grads) != set(g_cpu):
            raise AssertionError(f"{label}: card and CPU steps gave gradients to different "
                                 "parameters")
        rel = abs(loss - loss_cpu) / abs(loss_cpu)
        errs = sorted((((grads[n] - g).norm() / g.norm().clamp(min=1e-30)).item(), n)
                      for n, g in g_cpu.items() if n not in cancels)
        ratio = max(((grads[n] - g64[n]).norm().item() / max(cpu_off[n], 1e-30), n)
                    for n in cancels)
        over = [f"{n}: {e:.2e}" for e, n in errs if e > LEAF_TOL]
        margin = LEAF_TOL / max(errs[-1][0], 1e-30)
        log(f"{label}: loss {loss:.6f} vs CPU {loss_cpu:.6f} (rel {rel:.2e}, tol 1e-4); "
            f"{len(errs)} leaves held at {LEAF_TOL} relative norm: {len(over)} over, worst "
            + ", ".join(f"{n} {e:.2e}" for e, n in errs[:-4:-1])
            + f" (margin {margin:.2f}x); {len(cancels)} cancelling leaves "
            f"against fp64: worst |card - fp64| / |cpu - fp64| {ratio[0]:.2f} ({ratio[1]}, "
            "tol 4)")
        return rel, over, ratio[0]

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loss, grads = step(copy.deepcopy(base).to(dev))
        again = step(copy.deepcopy(base).to(dev))[1]
    log("card step, deterministic algorithms; ops without a deterministic version: "
        + ", ".join(sorted({str(w.message).split(" does not have")[0].split(" defaults to")[0]
                            for w in caught if "deterministic" in str(w.message)})))
    rel, over, ratio = compare("card vs CPU step, fp32", loss, grads)
    log("card step, cancelling leaves: |card - fp64| / |cpu - fp64| and, not held, the "
        "run-to-run spread |card - card again| / |cpu - fp64|: "
        + ", ".join(f"{n} {(grads[n] - g64[n]).norm().item() / max(cpu_off[n], 1e-30):.2f} "
                    f"{(grads[n] - again[n]).norm().item() / max(cpu_off[n], 1e-30):.2f}"
                    for n in sorted(cancels)))
    if rel > 1e-4:
        raise AssertionError("card and CPU train-step losses disagree")
    if over or ratio > 4:
        raise AssertionError(f"card and CPU gradients disagree: {over[:8]}, cancelling-leaf "
                             f"ratio {ratio:.2f}")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        compare("control, card step with TF32 on", *step(copy.deepcopy(base).to(dev)))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False


OPTIONS_FRACTION = 0.60  # autobatch_fraction, the default.yaml value
JSON_BOX_TOL, JSON_SCORE_TOL = 5e-2, 1e-3  # the serving limits, card vs CPU


class log_records:
    """Collect the port LOGGER's messages within a ``with`` block."""

    def __enter__(self):
        import logging

        from yolo_ad_refine_tpu_torch.utils import LOGGER

        class Handler(logging.Handler):
            def emit(self, record):
                messages.append(record.getMessage())

        messages: list[str] = []
        self.messages, self.handler, self.logger = messages, Handler(), LOGGER
        LOGGER.addHandler(self.handler)
        return messages

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def match_predictions(got: list, want: list) -> dict:
    """predictions.json of the card against the CPU's, image by image, each
    side's entries in their rank order. Held: the same images and the same
    number of entries an image, and rank by rank the whole entry (class,
    bbox within JSON_BOX_TOL, score within JSON_SCORE_TOL) down to the
    image's first tie, the first rank whose CPU score equals a neighbour's
    in the file's 5 decimals. Past a tie the two sides' NMS may keep
    different members of a group of equal candidates (a flat letterbox
    band gives many), and what it keeps then suppresses different others:
    there the entries are matched one to one by class, bbox and score
    within the limits, nearest rank first, and the count left without a
    match and the largest score difference by rank are returned, not
    held."""
    from collections import defaultdict

    def by_image(entries):
        out = defaultdict(list)
        for e in entries:
            out[e["image_id"]].append(e)
        return out

    def close(a, b):
        return (a["category_id"] == b["category_id"] and abs(a["score"] - b["score"]) <= JSON_SCORE_TOL
                and max(abs(x - y) for x, y in zip(a["bbox"], b["bbox"])) <= JSON_BOX_TOL)

    got, want = by_image(got), by_image(want)
    if sorted(got) != sorted(want):
        raise AssertionError(f"predictions.json: images {sorted(got)} vs {sorted(want)}")
    r = {"entries": 0, "held_by_rank": 0, "unmatched": 0, "max_bbox_diff": 0.0,
         "max_score_diff": 0.0, "tail_score_diff": 0.0}
    for image_id, ws in want.items():
        gs = got[image_id]
        if len(gs) != len(ws):
            raise AssertionError(f"predictions.json image {image_id}: {len(gs)} entries on the "
                                 f"card, {len(ws)} on the CPU")
        tie = next((i for i in range(len(ws)) if any(
            0 <= j < len(ws) and ws[j]["score"] == ws[i]["score"] for j in (i - 1, i + 1))),
            len(ws))
        used = set()
        for i, (g, w) in enumerate(zip(gs, ws)):
            if i < tie:
                if not close(g, w):
                    raise AssertionError(f"predictions.json image {image_id} rank {i}: card {g}, "
                                         f"CPU {w}")
                r["max_bbox_diff"] = max(r["max_bbox_diff"], max(
                    abs(x - y) for x, y in zip(g["bbox"], w["bbox"])))
                r["max_score_diff"] = max(r["max_score_diff"], abs(g["score"] - w["score"]))
                used.add(i)
                r["held_by_rank"] += 1
                continue
            r["tail_score_diff"] = max(r["tail_score_diff"], abs(g["score"] - w["score"]))
            j = next((j for j in sorted(range(tie, len(ws)), key=lambda j: abs(j - i))
                      if j not in used and close(g, ws[j])), None)
            if j is None:
                r["unmatched"] += 1
            else:
                used.add(j)
        r["entries"] += len(ws)
    return r


def phase_training_options(dev) -> dict:
    """A TPU user's training command on the card: the flagship at scale n
    (imgsz 640, synthetic shapes set, 128 train and 16 val images with
    height / width from 0.5 to 2) through the options of its yaml.

    1. ``YOLO(FLAGSHIP).train(epochs=1, batch=16, imgsz=640, amp=True,
       multi_scale=True, cache="ram")`` with the default ``plots``: each
       step's drawn size, ms and K1 launches; the plot files (or, without
       matplotlib, each plot's TryExcept warning).
    2. ``YOLO(best).val(rect=True, rect_buckets=4, save_json=True,
       plots=True, batch=8)`` in fp32 on the card and on the CPU, each val
       image labelled with best's own 3 best detections so that mAP is not
       0: mAP50 and mAP50-95 within 1e-3, predictions.json held by image
       and rank within JSON_BOX_TOL px and JSON_SCORE_TOL as far as its
       ties allow (``match_predictions``).
    3. ``batch=-1``: the trainer's autobatch on the card, then one train
       step at the batch it picked, whose peak must stay within the
       fraction of the card's memory.
    4. Phase 1's ``last`` written in the JAX package's layout
       (``tests/torch_jax_checkpoint.py``) and resumed with ``resume=``
       for one more epoch: start epoch, batch and EMA counts and every
       optimizer buffer as written, and the first resumed step's fp32 loss
       (deterministic algorithms) within 1e-4 relative of the same state
       resumed from the port's own ``train.pt``.
    Returns {path name: launches} for the kernels line and the numbers."""
    import gc
    import importlib.util

    import numpy as np
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_jax_checkpoint import write_jax_last
    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.data.dataset import YOLODataset
    from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
    from yolo_ad_refine_tpu_torch.train.trainer import DetectionTrainer
    from yolo_ad_refine_tpu_torch.utils.autobatch import step_peak_bytes

    counters = kernel_counters()

    def counts():
        return {k: f.launches for k, f in counters.items()}

    def zero():
        for f in counters.values():
            f.launches = 0

    out: dict = {"paths": {}}
    t_phase = time.perf_counter()
    with dcn_env(None), tempfile.TemporaryDirectory(prefix="chip_smoke_options_") as tmp:
        tmp = Path(tmp)
        data = make_shapes_dataset(tmp / "shapes", n_train=128, n_val=16, imgsz=640, seed=1,
                                   aspect_range=(0.5, 2.0))
        # 1. training with the options -------------------------------------------------
        model = YOLO(FLAGSHIP, device=dev, imgsz=640, seed=0)
        steps, mark = [], {}

        def on_batch_start(tr):
            torch.cuda.synchronize()
            mark.update(counts=counts(), t=time.perf_counter(), size=tr.batch["img"].shape[1])

        def on_batch_end(tr):
            torch.cuda.synchronize()
            now = counts()
            steps.append({"size": mark["size"], "ms": (time.perf_counter() - mark["t"]) * 1e3,
                          "first": all(st["size"] != mark["size"] for st in steps),
                          "fwd": now["dcn_forward"] - mark["counts"]["dcn_forward"],
                          "bwd": now["dcn_backward"] - mark["counts"]["dcn_backward"]})
            mark["after_steps"] = now

        model.add_callback("on_train_batch_start", on_batch_start)
        model.add_callback("on_train_batch_end", on_batch_end)
        zero()
        t0 = time.perf_counter()
        with log_records() as messages:
            results = model.train(data=data, epochs=1, batch=16, imgsz=640, amp=True,
                                  multi_scale=True, cache="ram", project=str(tmp / "runs"),
                                  workers=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = counts()
        trainer = model.trainer
        save_dir = Path(results["save_dir"])
        by_size: dict = {}
        for i, st in enumerate(steps):
            log(f"options, train: step {i + 1}: drawn size {st['size']}"
                f"{' (its first step)' if st['first'] else ''}, {st['ms']:.1f} ms, K1 fwd / bwd "
                f"launches {st['fwd']} / {st['bwd']}")
            k = by_size.setdefault(st["size"], {"steps": 0, "dcn_forward": 0, "dcn_backward": 0})
            k["steps"] += 1
            k["dcn_forward"] += st["fwd"]
            k["dcn_backward"] += st["bwd"]
        log(f"options, train: {len(steps)} steps + validation in {wall:.1f} s (bf16 autocast: "
            f"{trainer.amp_dtype is not None}); K1 launches by drawn size {by_size}; "
            f"launches in the run {run}")
        if len(steps) != 8 or any((st["fwd"], st["bwd"]) != (3, 3) for st in steps):
            raise AssertionError(f"expected 8 steps of 3 K1 fwd and 3 K1 bwd launches: {steps}")
        if any(st["size"] % 64 or not 320 <= st["size"] <= 960 for st in steps):
            raise AssertionError(f"multi_scale drew a size outside 320-960: {steps}")
        val = {k: run[k] - mark["after_steps"][k] for k in run}
        if val["dcn_forward"] == 0 or val["nms_suppress"] == 0:
            raise AssertionError(f"the EMA validation launched no K1 fwd or K4: {val}")
        missing = [f for f in ("train_batch0.jpg", "train_batch1.jpg", "train_batch2.jpg")
                   if not (save_dir / f).exists()]
        has_mpl = importlib.util.find_spec("matplotlib") is not None
        figures = ("results.png", "confusion_matrix.png", "PR_curve.png")
        if has_mpl:
            missing += [f for f in figures if not (save_dir / f).exists()]
        else:
            for name in ("plot_results", "plot_confusion_matrix", "plot_pr_curve"):
                if not any(m.startswith(f"{name} failed") for m in messages):
                    missing.append(f"{name}'s TryExcept warning")
        log(f"options, train: matplotlib imports: {has_mpl}; files in the run: "
            f"{sorted(p.name for p in save_dir.iterdir())}")
        if missing:
            raise AssertionError(f"plots missing: {missing}")
        out["paths"]["training_options_run"] = run
        out["step_ms_by_size"] = {s: [(round(st["ms"], 1), st["first"]) for st in steps
                                      if st["size"] == s] for s in sorted(by_size)}
        written = {"batches": trainer.optimizer.batches, "steps": trainer.optimizer.steps,
                   "ema_updates": trainer.ema.updates,
                   "state": {n: {k: v.detach().clone() for k, v in
                                 trainer.optimizer.opt.state[p].items()}
                             for n, p in trainer.model.named_parameters()}}
        jax_last = write_jax_last(tmp / "jax_last", model=trainer.model, ema=trainer.ema,
                                  optimizer=trainer.optimizer, epoch=0,
                                  best_fitness=trainer.best_fitness, names=trainer.data["names"],
                                  dcn_offset_max=trainer.dcn_offset_max_run,
                                  train_args=trainer.args)
        best = save_dir / "weights" / "best"
        del model, trainer
        gc.collect()
        torch.cuda.empty_cache()

        # 2. rect validation with save_json, card against CPU ---------------------------
        import cv2

        best_model = YOLO(str(best), device=dev)
        val_dir = tmp / "shapes" / "val"
        files = sorted((val_dir / "images").glob("*.jpg"))
        imgs = [cv2.imread(str(f)) for f in files]
        for f, im, r in zip(files, imgs, best_model.predict(imgs, imgsz=640, conf=0.001, batch=8)):
            h, w = im.shape[:2]
            (val_dir / "labels" / f"{f.stem}.txt").write_text("".join(
                f"{int(c)} {(x1 + x2) / 2 / w:.6f} {(y1 + y2) / 2 / h:.6f} "
                f"{(x2 - x1) / w:.6f} {(y2 - y1) / h:.6f}\n"
                for x1, y1, x2, y2, _, c in r.boxes.data[:3]))
        ds = YOLODataset(val_dir / "images", imgsz=640)
        plan = ds.set_rectangle(8, 4)
        buckets = sorted({tuple(int(v) for v in s) for s in ds.rect_shapes})
        log(f"options, rect val: 16 val images in {len(plan)} batches of buckets (h, w) "
            f"{buckets}, short sides {min(min(b) for b in buckets)} px and up")
        if min(min(b) for b in buckets) < 256 or len(buckets) < 2:
            raise AssertionError(f"the val buckets {buckets} are not rect or too narrow")
        args = dict(data=data, imgsz=640, batch=8, rect=True, rect_buckets=4, save_json=True,
                    plots=True)
        best_model.val(**{**args, "project": str(tmp / "warm")})  # cuDNN plans of the buckets
        torch.cuda.synchronize()
        zero()
        t0 = time.perf_counter()
        got = best_model.val(**{**args, "project": str(tmp / "val_card")})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rect_run = counts()
        cpu = YOLO(str(best), device="cpu")
        t1 = time.perf_counter()
        want = cpu.val(**{**args, "project": str(tmp / "val_cpu")})
        cpu_s = time.perf_counter() - t1
        keys = ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
                "metrics/mAP50-95(B)")
        log(f"options, rect val: card {wall:.2f} s, {wall / 16 * 1e3:.1f} ms an image (host "
            f"clock, loader to metrics; the validator's own {got['speed_ms_per_image']:.1f} ms, "
            f"of it inference + NMS {got['inference_ms_per_image']:.1f} ms); launches {rect_run}")
        log("options, rect val: card " + ", ".join(f"{k} {got[k]:.6f}" for k in keys))
        log(f"options, rect val: CPU ({cpu_s:.1f} s) " + ", ".join(f"{k} {want[k]:.6f}"
                                                                for k in keys) + " (tol 1e-3)")
        n_batches = len(plan)
        if rect_run["dcn_forward"] != 3 * n_batches or rect_run["nms_suppress"] != n_batches:
            raise AssertionError(f"rect val: expected {3 * n_batches} K1 fwd and {n_batches} K4 "
                                 f"launches: {rect_run}")
        if got["metrics/mAP50(B)"] <= 0.05 or any(abs(got[k] - want[k]) > 1e-3
                                                   for k in keys[2:]):
            raise AssertionError("rect val: the card's mAP is vacuous or disagrees with the CPU's")
        card_dir, cpu_dir = (next(d.iterdir()) for d in (tmp / "val_card", tmp / "val_cpu"))
        for f in ("predictions.json", "confusion_matrix.png", "PR_curve.png")[:1 + 2 * has_mpl]:
            if not (card_dir / f).exists():
                raise AssertionError(f"rect val wrote no {f}")
        m = match_predictions(json.loads((card_dir / "predictions.json").read_text()),
                              json.loads((cpu_dir / "predictions.json").read_text()))
        log(f"options, rect val: predictions.json, {m['entries']} entries; the "
            f"{m['held_by_rank']} before each image's first score tie held by rank: max |bbox "
            f"diff| {m['max_bbox_diff']:.3e} px (tol {JSON_BOX_TOL}), max |score diff| "
            f"{m['max_score_diff']:.3e} (tol {JSON_SCORE_TOL}); past the ties, not held: "
            f"{m['unmatched']} entries with no CPU entry within the limits, scores by rank "
            f"within {m['tail_score_diff']:.3e}")
        out["paths"]["rect_val_run"] = rect_run
        out["rect_val"] = {"buckets": buckets, "ms_per_image": wall / 16 * 1e3, **m}
        del best_model, cpu
        gc.collect()
        torch.cuda.empty_cache()

        # 3. autobatch ------------------------------------------------------------------
        ab = DetectionTrainer({"model": FLAGSHIP, "data": data, "batch": -1, "imgsz": 640,
                               "epochs": 1, "plots": False, "project": str(tmp / "ab")})
        ab._setup()
        a = ab.autobatch
        total = torch.cuda.get_device_properties(0).total_memory
        log("options, autobatch: probe peaks " + ", ".join(
            f"batch {b} {p / 2**30:.3f} GiB" for b, p in a["peaks"].items())
            + f"; base {a['base'] / 2**30:.3f} GiB, slope {a['slope'] / 2**20:.1f} MiB an image; "
            f"total_memory {total / 2**30:.2f} GiB x {a['fraction']} -> batch {a['batch']}")
        if ab.batch_size != a["batch"] or a["batch"] & (a["batch"] - 1) or a["limit"] != total:
            raise AssertionError(f"autobatch resolved batch {ab.batch_size} from {a}")
        peak = step_peak_bytes(ab.probe_step, a["batch"], torch.device(dev))
        log(f"options, autobatch: one train step at batch {a['batch']}: peak {peak / 2**30:.3f} "
            f"GiB, the fit {(a['base'] + a['slope'] * a['batch']) / 2**30:.3f} GiB, the budget "
            f"{a['fraction'] * total / 2**30:.3f} GiB")
        if peak > a["fraction"] * total:
            raise AssertionError("the autobatch batch's train step passes the memory budget")
        out["autobatch"] = {**{k: a[k] for k in ("batch", "base", "slope", "fraction")},
                            "peaks": {str(b): p for b, p in a["peaks"].items()},
                            "total_memory": total, "peak_at_batch": peak}
        del ab
        gc.collect()
        torch.cuda.empty_cache()

        # 4. resume from the JAX layout, and from train.pt ------------------------------
        def resume(src: Path, tag: str) -> dict:
            m = YOLO(FLAGSHIP, device=dev, imgsz=640, seed=5)  # other weights: resume replaces
            seen: dict = {}

            def on_start(tr):
                opt = tr.optimizer
                seen.update(start_epoch=tr.start_epoch, batches=opt.batches, steps=opt.steps,
                            ema_updates=tr.ema.updates,
                            state={n: {k: v.detach().clone() for k, v in opt.opt.state[p].items()}
                                   for n, p in tr.model.named_parameters()}, losses=[])
                step = tr.train_step

                def recorded(batch):
                    r = step(batch)
                    seen["losses"].append(r["loss"].item())
                    return r

                tr.train_step = recorded

            m.add_callback("on_train_start", on_start)
            zero()
            m.train(data=data, epochs=2, batch=16, imgsz=640, amp=False, resume=str(src),
                    val=False, project=str(tmp / f"resume_{tag}"), workers=8)
            torch.cuda.synchronize()
            seen["run"] = counts()
            return seen

        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                from_jax = resume(jax_last, "jax")
                from_pt = resume(save_dir / "weights" / "last", "pt")
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
        def restored(st: dict, got: dict) -> bool:
            """As written; a parameter that had no gradient (torch keeps no
            state for it) gets zero moments beside the step count."""
            if not st:
                return all(not bool(v.any()) for k, v in got.items() if k != "step")
            return set(st) == set(got) and all(torch.equal(v, got[k]) for k, v in st.items())

        diffs = [name for name, st in written["state"].items()
                 if not restored(st, from_jax["state"][name])]
        rel = abs(from_jax["losses"][0] - from_pt["losses"][0]) / abs(from_pt["losses"][0])
        log(f"options, resume: from the JAX layout at epoch {from_jax['start_epoch']}, "
            f"{from_jax['batches']} batches, {from_jax['steps']} optimizer steps, EMA updates "
            f"{from_jax['ema_updates']} (written: {written['batches']}, {written['steps']}, "
            f"{written['ema_updates']}); {len(written['state'])} parameters' optimizer buffers "
            f"({sorted(next(iter(written['state'].values())))}), {len(diffs)} not restored")
        log(f"options, resume: first step's fp32 loss from the JAX layout "
            f"{from_jax['losses'][0]:.8f}, from train.pt {from_pt['losses'][0]:.8f} (rel "
            f"{rel:.2e}, tol 1e-4); {len(from_jax['losses'])} steps; launches {from_jax['run']}")
        if (from_jax["start_epoch"], from_jax["batches"], from_jax["steps"],
                from_jax["ema_updates"]) != (1, written["batches"], written["steps"],
                                             written["ema_updates"]) or diffs:
            raise AssertionError(f"the JAX-layout resume did not restore what was written: "
                                 f"{diffs[:5]}")
        if rel > 1e-4 or len(from_jax["losses"]) != 8:
            raise AssertionError("the first resumed steps disagree between the two resumes")
        out["paths"]["resume_jax_run"] = from_jax["run"]
        out["resume_loss_rel"] = rel
    log(f"options: phase done in {time.perf_counter() - t_phase:.1f} s")
    return out


def main() -> int:
    # cuBLAS's fixed-workspace mode, under which its results repeat from run
    # to run, as the deterministic card step (phase_step_card_vs_cpu) asks
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    report = kernels.build("deform_conv", "deform_window", "gather", "nms")
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (parallel nvcc): "
        + ", ".join(f"{n} {r['seconds']:.1f} s" for n, r in report.items()))
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    with dcn_env(None):  # each phase sets the DCN variant it drives
        k1 = phase_k1(dev, gen)
        k1b = phase_k1_bwd(dev, gen)
        k1_wide = phase_k1_wide(dev, gen)
        k4 = phase_k4(dev, gen)
        bounded = {impl: phase_bounded(dev, gen, impl) for impl in BOUNDED}
        gather, gather_run = phase_gather(dev)
        paths = {"gather_probe_run": gather_run, "serving_run": phase_serving(dev)}
        paths["folder_serving_run"], folder_rates = phase_folder_serving(dev)
        for impl in ("mxu", "pallas", "mxu2"):
            paths[f"serving_{impl}_run"] = phase_serving_variant(dev, impl)
        for impl in (None, "mxu", "pallas"):
            tag = "" if impl is None else f"_{impl}"
            run, step, extra = phase_training(dev, impl)
            paths.update({f"training{tag}_run": run, f"training{tag}_step": step, **extra})
        run, step, _ = phase_training(dev, None, FLAGSHIP_X)
        paths.update({"training_x_run": run, "training_x_step": step})
        phase_step_card_vs_cpu(dev)
        paths.update(phase_training_options(dev)["paths"])
        obb = obb_model(dev)
        k5 = phase_k5(dev, gen, obb)
        paths["obb_serving_run"] = phase_obb_serving(obb, dev)
        paths["obb_val_run"] = phase_obb_val(obb, dev)

    def entry(name, source, replaces, measured, main_path, **extra):
        # launches: the count of the kernel's own main path, each path's beside it
        return {"name": name, "route": "cuda", "source": f"yolo_ad_refine_tpu_torch/csrc/{source}",
                "replaces": replaces if replaces.startswith("benchmarks/")
                else f"yolo_ad_refine_tpu/{replaces}", "launches": paths[main_path][name],
                "main_path": main_path,
                "launches_by_path": {p: c.get(name, 0) for p, c in paths.items()},
                **{k: measured[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by")},
                "library_ms": measured.get("library_ms"), **extra}

    bounded_entries = []
    for impl, (fwd_name, bwd_name, src) in BOUNDED.items():
        line = {"mxu": (91, 161), "pallas": (67, 122)}[impl]
        t = bounded[impl]
        bounded_entries += [
            entry(fwd_name, "deform_window.cu", f"{src}:{line[0]}", t["fwd"]["float32"],
                  f"training_{impl}_run", dtype="float32", bfloat16=t["fwd"]["bfloat16"],
                  **{k: t["fwd"]["float32"][k] for k in ("device_ms", "bound_route",
                                                         "bound_ms_fp32_cores", "batch")}),
            entry(bwd_name, "deform_window.cu", f"{src}:{line[1]}", t["bwd"]["float32"],
                  f"training_{impl}_run", dtype="float32", bfloat16=t["bwd"]["bfloat16"],
                  **{k: t["bwd"]["float32"][k] for k in ("device_ms", "bound_route",
                                                         "bound_ms_fp32_cores", "batch")})]
    kernels_line = {"kernels": [
        entry("dcn_forward", "deform_conv.cu", "ops/deform_mxu2.py:92", k1["float32"],
              "training_run", dtype="float32", bfloat16=k1["bfloat16"],
              device_ms=k1["float32"]["device_ms"],
              bound_ms_fp32_cores=k1["float32"]["bound_ms_fp32_cores"],
              by_width_b16={k: {n: v for n, v in t.items() if "fwd" in n}
                            for k, t in k1_wide.items()}),
        entry("dcn_backward", "deform_conv.cu", "ops/deform_mxu2.py:169", k1b["float32"],
              "training_run", dtype="float32", bfloat16=k1b["bfloat16"],
              device_ms=k1b["float32"]["device_ms"],
              bound_ms_fp32_cores=k1b["float32"]["bound_ms_fp32_cores"],
              by_width_b16={k: {n: v for n, v in t.items() if "bwd" in n}
                            for k, t in k1_wide.items()}),
        *bounded_entries,
        entry("nms_suppress", "nms.cu", "ops/nms_pallas.py:32", k4, "training_run",
              device_ms=k4["device_ms"], parts=k4["parts"], predict_batch=k4["predict_batch"]),
        entry("nms_rotated", "nms.cu", "ops/nms_pallas.py:81", k5, "obb_serving_run",
              device_ms=k5["device_ms"], parts=k5["parts"], predict_batch=k5["predict_batch"],
              rounding_ties=k5["rounding_ties"]),
        entry("gather_rows", "gather.cu", "benchmarks/bench_dcn.py:103", {
            "max_abs_err": gather["max_abs_err"], **gather["bfloat16"]["total"],
            "bound_by": "bytes"}, "gather_probe_run", dtype="bfloat16",
            float32={**gather["float32"]["total"], "bound_by": "bytes"},
            levels={n: gather[n]["levels"] for n in ("bfloat16", "float32")}),
    ]}
    for k in kernels_line["kernels"]:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was not launched on its main path {k['main_path']}")
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
