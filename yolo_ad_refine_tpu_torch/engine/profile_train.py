"""Where one train step's time goes, on the card.

    python -m yolo_ad_refine_tpu_torch.engine.profile_train [--batch 16] [--out FILE]

Writes the synthetic shapes set (16 batches of train images, 640 px) to a
temporary directory and runs ``YOLO(flagship, device="cuda").train`` on it
for one epoch at imgsz 640 with bf16 autocast and the default ``auto``
optimizer, as a user would, reading the trainer through its callbacks and
``TrainStep.on_phase``. It prints the phases of a step (data wait, upload
+ forward, loss, backward, optimizer and EMA; host clock around work ended
by a synchronise, mean over 8 steps after 3 of warm-up) and, from
torch.profiler over the next 4 steps run without those synchronises, the
device's busy share and its device time by kernel family. ``--out`` writes
every kernel's device time as JSON. Nothing here is checked:
``chip_smoke.py`` is the pass/fail run.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from yolo_ad_refine_tpu_torch.engine.profile_predict import FLAGSHIP, kernel_family

WARMUP, TIMED, PROFILED = 3, 8, 4


def _sync_time() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


class _StepClock:
    """Trainer callbacks that time the phases of the steps WARMUP ..
    WARMUP + TIMED - 1 and run torch.profiler over the PROFILED steps after."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.step = 0
        self.marks: list = []
        self.times: list = []
        self.prev_end = None
        self.accumulate = None
        self.wall_us = 0.0

    def on_train_start(self, trainer):
        self.train_step, self.accumulate = trainer.train_step, trainer.accumulate

    def on_train_batch_start(self, trainer):
        t = _sync_time()
        if WARMUP <= self.step < WARMUP + TIMED:
            self.marks = [self.prev_end, t]
            self.train_step.on_phase = lambda phase: self.marks.append(_sync_time())
        elif self.step == WARMUP + TIMED:
            self.train_step.on_phase = None
            self.prof.start()
            self.t0 = _sync_time()

    def on_train_batch_end(self, trainer):
        self.prev_end = t = _sync_time()
        if WARMUP <= self.step < WARMUP + TIMED:
            self.times.append(np.diff(self.marks) * 1e3)
        elif self.step == WARMUP + TIMED + PROFILED - 1:
            self.wall_us = (t - self.t0) * 1e6
            self.prof.stop()
        self.step += 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write every kernel's device time as JSON here")
    args = ap.parse_args(argv)

    from torch.autograd import DeviceType

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
    from yolo_ad_refine_tpu_torch.train.step import TrainStep
    from yolo_ad_refine_tpu_torch.utils import select_device

    dev = select_device("cuda")
    clock = _StepClock()
    with tempfile.TemporaryDirectory(prefix="profile_train_") as tmp:
        n_train = (WARMUP + TIMED + PROFILED + 1) * args.batch
        data = make_shapes_dataset(Path(tmp) / "shapes", n_train=n_train, n_val=args.batch,
                                   imgsz=640, seed=args.seed)
        model = YOLO(FLAGSHIP, device=dev, imgsz=640, seed=args.seed)
        for event in ("on_train_start", "on_train_batch_start", "on_train_batch_end"):
            model.add_callback(event, getattr(clock, event))
        model.train(data=data, epochs=1, batch=args.batch, imgsz=640, amp=True,
                    plots=False, val=False, seed=args.seed, project=str(Path(tmp) / "runs"))

    mean = np.mean(clock.times, axis=0)
    phases = ("data",) + TrainStep.PHASES
    print(f"train step, batch {args.batch}, imgsz 640, bf16 autocast, accumulate "
          f"{clock.accumulate} (ms, host clock, mean of {TIMED} steps): "
          + ", ".join(f"{p} {v:.3f}" for p, v in zip(phases, mean))
          + f"; total {mean.sum():.3f} ({args.batch / mean[1:].sum() * 1e3:.1f} images/s "
          "without the data wait)")
    print("optimizer + EMA per step (ms): " + ", ".join(f"{t[-1]:.3f}" for t in clock.times))

    # a user annotation's device span (Optimizer.step#Adam.step) covers
    # kernels counted on their own already
    kernels = sorted(((e.key, e.self_device_time_total, e.count) for e in clock.prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda k: -k[1])
    busy_us = sum(us for _, us, _ in kernels)
    if busy_us == 0:
        print("the profiler saw no device time; phase times above only")
        return 0
    wall_us = clock.wall_us
    print(f"{PROFILED} train steps {wall_us / 1e3:.3f} ms (host clock), device busy "
          f"{busy_us / 1e3:.3f} ms = {100 * busy_us / wall_us:.1f} %, idle "
          f"{100 * (1 - busy_us / wall_us):.1f} %")
    families: dict = {}
    for name, us, n in kernels:
        f = families.setdefault(kernel_family(name), [0.0, 0])
        f[0] += us
        f[1] += n
    for fam, (us, n) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        print(f"  {fam:16s} {us / PROFILED / 1e3:9.3f} ms a step {100 * us / busy_us:5.1f} % of "
              f"device time, {n / PROFILED:.0f} launches a step")
    if args.out:
        with open(args.out, "w") as f:
            json.dump([{"name": n, "family": kernel_family(n), "device_us": us, "count": c}
                       for n, us, c in kernels], f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
