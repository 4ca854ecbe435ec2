"""Where one predict batch's time goes, on the card.

    python -m yolo_ad_refine_tpu_torch.engine.profile_predict [--batch 32] [--out FILE]
    python -m yolo_ad_refine_tpu_torch.engine.profile_predict --model yolo11n-obb.yaml \
        --imgsz 1024 --batch 16

Builds a model (the flagship YOLO-AD-Refine at imgsz 640 by default) with
seeded weights on ``cuda`` (fp32, TF32 off), letterboxes ``--batch``
synthetic uint8 images of mixed shapes and prints: the stage times of one
batch (preprocess, forward, NMS + readback, rotated for an OBB model; host
clock around work ended by a synchronise, median of 5);
the forward alone in fp32, with TF32 on, and in bf16; and, from
torch.profiler, the device's busy share of one ``YOLO.predict`` batch and its
device time by kernel family. A Detect or OBB head's class biases take the
flagship head's prior, sigmoid(b) = 0.01, as in ``chip_smoke.py``: with
seeded weights Detect's own prior leaves every score under conf 0.001, and
NMS would see no candidate. ``--out`` writes every kernel's device time as
JSON. Nothing here is checked: ``chip_smoke.py`` is the pass/fail run.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import time

import numpy as np
import torch

FLAGSHIP = "yolo11-701-YOLO-AD-Refine.yaml"
SHAPES = ((480, 640), (640, 480), (720, 1280), (360, 640), (1080, 1920), (512, 512),
          (300, 800), (640, 640))

# (family, substrings of the lower-cased kernel name), first match wins
_FAMILIES = (("K1 dcn_forward", ("dcn_fwd",)), ("K1 dcn_backward", ("dcn_bwd",)),
             *((f"{k} {n}", (n,)) for k, n in (
                 ("K2", "dcn_separable_forward"), ("K2", "dcn_separable_backward"),
                 ("K3", "dcn_window_forward"), ("K3", "dcn_window_backward"))),
             ("K5 nms_rotated", ("nms_rotated",)), ("K4 nms_suppress", ("nms_",)),
             ("LAP linear_sum_assignment", ("lap_kernel",)),
             ("normalisation", ("norm", "bn_fw")),
             ("layout change", ("nhwctonchw", "nchwtonhwc", "transpose")),
             ("convolution", ("conv", "fprop", "implicit", "winograd", "cudnn")),
             ("fft", ("fft",)), ("matmul", ("gemm", "gemv")), ("sort / scan", ("sort", "scan")),
             ("reduction", ("reduce",)), ("copy", ("copy", "memcpy", "memset")),
             ("elementwise", ("elementwise", "vectorized")))


def kernel_family(name: str) -> str:
    """Coarse family of a CUDA kernel from its (mangled) name."""
    low = name.lower()
    return next((fam for fam, keys in _FAMILIES if any(k in low for k in keys)), "other")


def _stage_ms(model, imgs, imgsz: int) -> np.ndarray:
    from yolo_ad_refine_tpu_torch.engine.predictor import preprocess
    from yolo_ad_refine_tpu_torch.ops.nms import non_max_suppression

    dev = next(model.parameters()).device
    t = [time.perf_counter()]
    with torch.inference_mode():
        x, _ = preprocess(imgs, imgsz, len(imgs), dev, torch.float32)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        y, _ = model(x)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        det, cnt, _ = non_max_suppression(y, conf_thres=0.001, iou_thres=0.7, nc=model.nc,
                                          rotated=model.task == "obb")
        det.cpu(), cnt.cpu()
        t.append(time.perf_counter())
    return np.diff(t) * 1e3


def _forward_ms(net, x, iters: int = 10) -> float:
    with torch.inference_mode():
        for _ in range(3):
            net(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            net(x)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default=FLAGSHIP, help="a model yaml (yolo11n-obb.yaml for OBB)")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write every kernel's device time here (JSON)")
    args = ap.parse_args(argv)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.engine.predictor import preprocess
    from yolo_ad_refine_tpu_torch.nn.head import Detect

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yolo = YOLO(args.model, device="cuda", imgsz=args.imgsz, seed=args.seed)
    m = yolo.model
    if isinstance(m.model[m.head_idx], Detect):
        with torch.no_grad():
            for seq in m.model[m.head_idx].cv3:
                seq[-1].bias.fill_(-math.log((1 - 0.01) / 0.01))
    rng = np.random.default_rng(args.seed)
    scale = args.imgsz / 640  # the mixed shapes, scaled with imgsz
    imgs = [rng.integers(0, 256, (*(int(v * scale) for v in SHAPES[i % len(SHAPES)]), 3),
                         dtype=np.uint8) for i in range(args.batch)]
    yolo.predict(imgs, conf=0.001, batch=args.batch)  # warm-up: kernel build, cuDNN plans

    _stage_ms(m, imgs, args.imgsz)
    pre, fwd, nms = np.median([_stage_ms(m, imgs, args.imgsz) for _ in range(5)], axis=0)
    print(f"{args.model}, task {m.task}: stages of one batch of {args.batch} at {args.imgsz}, "
          f"fp32 (ms, median of 5): "
          f"preprocess {pre:.3f}, forward {fwd:.3f}, nms + readback {nms:.3f}")

    x, _ = preprocess(imgs, args.imgsz, args.batch, torch.device("cuda"), torch.float32)
    fp32 = _forward_ms(m, x)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    tf32 = _forward_ms(m, x)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    bf16 = _forward_ms(copy.deepcopy(m).to(torch.bfloat16), x.to(torch.bfloat16))
    print(f"forward of {args.batch} at {args.imgsz} (ms, host clock, mean of 10): fp32 {fp32:.3f}, "
          f"TF32 on {tf32:.3f}, bf16 weights and inputs {bf16:.3f}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yolo.predict(imgs, conf=0.001, batch=args.batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda k: -k[1])
    busy_us = sum(us for _, us, _ in kernels)
    if busy_us == 0:
        print("the profiler saw no device time; stage times above only")
        return 0
    print(f"one predict batch {wall_us / 1e3:.3f} ms (host clock), device busy "
          f"{busy_us / 1e3:.3f} ms = {100 * busy_us / wall_us:.1f} %, idle "
          f"{100 * (1 - busy_us / wall_us):.1f} %")
    families: dict = {}
    for name, us, n in kernels:
        f = families.setdefault(kernel_family(name), [0.0, 0])
        f[0] += us
        f[1] += n
    for fam, (us, n) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        print(f"  {fam:16s} {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f} % of device time, "
              f"{n} launches")
    if args.out:
        with open(args.out, "w") as f:
            json.dump([{"name": n, "family": kernel_family(n), "device_us": us, "count": c}
                       for n, us, c in kernels], f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
