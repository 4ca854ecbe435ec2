#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (yolo_ad_refine_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``yolo_ad_refine_tpu_torch/csrc``
(one nvcc per source, all started together), holds each kernel (K1 DCN
forward and backward; K2, the separable DCN, and K3, the bounded-window
DCN, forward and backward; K4 NMS; K5 rotated NMS; the gather probe; the
LAP of RT-DETR's matcher)
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
``YAT_DCN_IMPL`` (set for the phase and restored after it).

The kernels' own phases (the builds, K1-K5 and the probe) have the card to
themselves. The paths then run in two halves side by side, each in its own
process with its own launch counts: this one (serving, training, the OBB
and task phases, World, the zoo, RT-DETR, tracking, the periphery, the
SAM family, benchmark) and ``second_half``'s (the module library, export,
the command line, tune, the training options, the two ranks and the card
vs CPU step), which this process starts, feeds and waits for; a kernel
timed on a path of this half (``quiet_card``) stops the second half while
it is timed. The CPU sides of tracking's and the SAM family's holds run in
a third process at nice 19 beside the paths (``start_cpu_references``).
Host-clock rates of the paths are taken beside the other half's work. The
paths:

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
- OBB training (``phase_obb_training``): ``YOLO("yolo11n-obb.yaml")
  .train(task="obb")`` on a seeded DOTA-style set (64 train, 16 val tiles
  of 1024² with corner-quad labels), 1 epoch at batch 16 in bf16: 4 steps,
  the EMA validation and that of ``best`` through K5, a reload of
  ``best`` as an OBB model, and one fp32 OBB step held against the CPU;
- segment and pose (``phase_segment``, ``phase_pose``, after OBB
  training): ``YOLO("yolo11n-seg.yaml", task="segment")`` (nc 80) and
  ``YOLO("yolo11n-pose.yaml", task="pose")`` (nc 1, 17 keypoints) at 640,
  class 0 at P5 at the prior 0.3: 64 images served at batch 32, fp32,
  conf 0.25 (images/s, the mean kept, the masks' share of a batch), card
  vs CPU on 2 images (boxes and keypoints 5e-2 px, scores 1e-3, mask
  pixels flipped 2e-3); ``.val`` of 16 seeded polygon or keypoint images
  labelled with the model's own detections, card vs CPU at 1e-3; 1 epoch
  of ``.train`` on 64 / 16 images at batch 16, bf16 (4 steps), ``best``
  reloaded as the task's model, and one fp32 step of SegmentationLoss /
  PoseLoss against the CPU; K4 once a batch on each path;
- classification (``phase_classify``): yolo11n-cls (nc 1000) at 224, the
  forward + softmax of 64 images in fp32 against the CPU (probabilities
  1e-4, the same top-5), ``ClassificationTrainer`` for 1 epoch on a seeded
  class-folder set (4 colours x 32 images, 4 steps at batch 32) through
  ``YOLO.train``, and ``validate``'s top1 / top5 card vs CPU; no kernel;
- YOLOv10 (``phase_v10``): yolov10n at 640 through the task helpers
  above, NMS-free: serving (its selected rows, cut at conf), validation
  and 1 epoch of training with E2EDetectLoss, one fp32 step against the
  CPU; no K4 launch on any of them;
- YOLO-World (``phase_world``): yolov8s-worldv2 at 640 with
  ``set_classes(["person", "car", "dog"])``: serving 64 images at batch 32
  and validating 16, K4 once a batch on each (``world_serving_run``,
  ``world_val_run``) and held against its plain version on a serving and
  a validation batch's candidates over the 3-name vocabulary (the kernels
  line's K4 ``world_batches``); its training raises, as the JAX train
  step does;
- RT-DETR (``phase_rtdetr``, after ``phase_world``): rtdetr-l at 640
  served (64 images at batch 32, fp32, conf 0.25: no kernel, it is
  NMS-free) and validated (16 images, card vs CPU at 1e-3); trained 4
  bf16 steps at batch 16 with the denoising group (556 queries), the LAP
  kernel (``csrc/lap.cu``, the Hungarian matcher) once a step for the 7
  levels' 112 cost matrices and once in the EMA validation; the gradient
  of one training forward card vs CPU at 256, held in fp64 and in fp32
  (a decoder layer whose ReLU inputs the card's fp32 rounding puts on the
  other side of 0 may miss, while the card's flips against fp64 stay
  within 4 times the CPU's); the LAP kernel against
  its plain version on the step's matrices and on synthetic ones; the
  ATSS loss card vs CPU; a yolov10n TorchScript program validated
  through its sidecar's head kind against the model;
- the stock zoo (``phase_zoo``, after ``phase_rtdetr``): yolov8n,
  yolov5n, yolov3, yolov9c, yolov8n-seg and yolov8n-pose at 640, each
  parameter count held to the JAX model's, served as the task phases serve
  (64 images at batch 32, fp32, conf 0.25, K4 once a batch, card vs CPU),
  yolov8n-obb at 1024 as the OBB phase serves it (K5 once a batch),
  yolov9c validated on 16 self-labelled images against the CPU, and
  yolov9c and yolov3 trained 4 bf16 steps at batch 16 (yolov9c's fp32
  step held against the CPU at 256);
- tracking (``phase_track``): ``YOLO.track`` with the flagship at 640 over
  a seeded 1280x720 MJPG video of 48 frames, with ``bytetrack`` and
  ``botsort``: frames/s, the host's share of a frame, K4 once a frame (at
  B = 1, and held against its plain version on a frame's candidates), and
  the first 24 frames' track rows against the same track on the CPU
  (``hold_tracks``);
- the periphery (``phase_periphery``, after ``phase_track``): the folder
  serving phase's 64 JPEGs through ``LoadImagesNative`` (the C++ loader,
  libjpeg or, where the machine has none, nvJPEG; batch 32, 640, 8
  threads), each batch through the flagship's forward and the port's NMS
  (K1 fwd 3 and K4 1 a batch), every image against ``cv2.imread`` and the
  letterbox (mean < 2, p99 <= 12 grey levels; meta within 1e-6), with the
  images/s of this path beside ``predict(folder)`` and arrays; the
  solution apps (ObjectCounter, Heatmap, SpeedEstimator, QueueManager,
  DistanceCalculator, Analytics' counts) over ``phase_track``'s ByteTrack
  rows, ms a frame, and their counts over the frames held alike against
  the same apps fed the CPU's rows; ``Explorer`` embeddings of 40 images
  with the flagship at 256 (batch 16, the last padded) card vs CPU (1e-4
  of max |CPU|, ``get_similar`` order, SQL rows); ``auto_annotate`` of 16
  images with the flagship (box rows) and yolo11n-seg (polygon rows), K4
  once an image, every row against its results within 1e-3; and a 4000 x
  3000 DOTA scene split by ``split_images_and_labels`` (crop 1024, gap
  200) into 20 tiles served by yolo11n-obb at 1024, batch 16 (K5 once a
  batch), each kept label's iof >= 0.7;
- the module library (``phase_module_library``, after ``phase_track``): the
  flagship yaml with layer 10 swapped for the paper's ablation rows (the
  697 model, ``C2TSSA_DYT_Mona_EDFFN``; C2SFA, C2PSA_EDFFN,
  C2AdaptiveTSSA_Enhanced, C2ProgressiveTSSA_Fusion1) or with its
  ``fusion_mode`` set (weight, adaptive, concat, SDI), at scale n and 640,
  each parameter count held to the JAX model's, class 0 in AYHead's cv3
  at the prior 0.15 (or higher, where that keeps no row at conf 0.25):
  the 697 model served (64 images at batch 32, fp32, conf 0.25, K1 fwd 3
  and K4 once a batch, card vs CPU on 2), validated on 16
  self-labelled images (card vs CPU at 1e-3), trained 1 epoch (4 bf16
  steps at batch 16, K1 fwd and bwd 3 a step) and one fp32 step held
  against the CPU with the same dropout masks on both sides; the other
  eight served on 32 images and held against the CPU, the SDI flagship
  also trained 4 bf16 steps; the 28 attention rows and DSAN / DSA each
  alone at batch 8, 64 x 80 x 80 (CascadedGroupAttention at 7 x 7) card vs
  CPU with its ms, and each as a yaml row after row 10 served on 32 images
  (CascadedGroupAttention, which attends only a 7 x 7 map, not at P5);
- the SAM family (``phase_sam``, after ``phase_module_library``; fp32,
  seeded weights, each parameter count JAX's): ``SAM("sam_b")`` at 1024
  on a 1280x720 image (a point, two points with a background one, a box;
  ``generate(points_per_side=8)`` at the default thresholds and with
  every candidate scored), sam_l and sam_h (a point each), mobile_sam (a
  point, a box), ``SAM2Predictor`` for sam2_t / s / b / l (a point each),
  ``SAM2VideoPredictor("sam2_b")`` over a 16-frame 1280x720 video
  (frames/s), each held against the CPU (embeddings 1e-3 of max |CPU|,
  IoU and object logits 1e-3, mask pixels flipped 2e-3; the CPU sides
  run in the CPU-reference worker, ``start_cpu_references``, beside the
  earlier phases); FastSAM-s and -x
  (``yolov8s-seg`` / ``yolov8x-seg``, nc 1) at 1024 on 8 images in
  everything mode and with bbox and point prompts, K4 once a batch and
  held against its plain version on the batch's candidates, card vs CPU
  on 2 images; ``nas_postprocess`` on a (32, 8400) raw layout over 80
  classes (K4 once, rows equal to the CPU's) and ``NAS("yolo_nas_s")``
  raising ImportError;
- export and serving (``phase_export``): the flagship exported at batch
  32 through ``YOLO.export`` as ``torch_export`` and ``torchscript``, in
  fp32 and bf16 (``half=True``), and under ``YAT_DCN_IMPL=pallas``, each
  loaded by ``AutoBackend`` and run on 64 images against the eager model,
  its DCN kernel's launches read from the ``yat_ad::`` ops' counters, and
  ``DetectionValidator(backend=)`` over 20 images at batch 8 against the
  same validation through the model;
- data-parallel training (``phase_parallel``, after the training runs):
  two ranks of ``tests/torch_parallel_worker.py`` sharing the card over
  gloo with CUDA tensors train the flagship through ``YOLO.train`` with
  DDP and with FSDP2 (global batch 16, 640, bf16, 4 steps, rank 0's
  validation), each rank's K1 / K4 launches under ``launches_by_path``;
  then, in the same two ranks, one fp32 step of DDP and of FSDP2, and in
  a process of its own one NCCL rank's, held by ``phase_step_card_vs_cpu``
  at its limits;
- the command line (``phase_cli``): ``python -m yolo_ad_refine_tpu_torch``
  ``detect train`` (flagship, 1 epoch at batch 16, 640), ``val`` and
  ``predict`` on its ``best``, and ``checks`` (the card, four built
  kernels), in subprocesses;
- ``YOLO.tune`` (``phase_tune``): 2 iterations of that epoch, each held
  to have trained (the Tuner scores a failed one 0 and goes on) and to
  have launched K1 and K4; ``YOLO.benchmark`` (``phase_benchmark``): the three
  formats at batch 32, 640, ms per image, and ``model_flops`` at scale n
  and x;

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

import contextlib
import copy
import json
import math
import os
import pickle
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
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


T0 = float(os.environ.get("CHIP_SMOKE_T0") or time.time())  # the script's start, both halves
PART = os.environ.get("CHIP_SMOKE_PART", "")  # "B" in the second half's process


def log(msg: str) -> None:
    """``msg`` on standard output, after the script's elapsed seconds and,
    in the second half's process, its mark."""
    print(f"[{time.time() - T0:7.1f} s{' ' + PART if PART else ''}] {msg}", flush=True)


CPU_REF_THREADS = 3  # torch threads of the CPU-reference worker, which runs at nice 19
CPU_REFS: dict = {}  # the worker's "proc", "dir" and "jobs" [(function name, args)], while it runs


def start_cpu_references() -> None:
    """Start the CPU sides of the tracking phase's and the SAM family's
    holds (``track_cpu_side``, ``sam_cpu_side``, ``sam2_cpu_side``,
    ``video_cpu_side``), in the order the phases ask for them, in a worker
    process at nice 19 (``cpu_references``) while the paths run: they take
    most of the script's host CPU seconds and need nothing from the card.
    ``cpu_reference`` collects each; ``stop_cpu_references`` ends the
    worker."""
    folder = tempfile.TemporaryDirectory(prefix="chip_smoke_cpu_refs_")
    jobs = ([("track_cpu_side", (t,)) for t in ("bytetrack", "botsort")]
            + [("sam_cpu_side", (v,)) for v in SAM_COUNTS]
            + [("sam2_cpu_side", (v,)) for v in SAM2_COUNTS] + [("video_cpu_side", ())])
    (Path(folder.name) / "jobs.pkl").write_bytes(pickle.dumps(jobs))
    # what the worker prints goes to standard error: standard output is this script's record
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--cpu-references",
                             folder.name], stdin=subprocess.DEVNULL, stdout=sys.stderr.fileno())
    CPU_REFS.update(proc=proc, dir=folder, jobs=jobs)


def cpu_references(folder: str) -> int:
    """The CPU-reference worker: each job of ``folder``'s jobs.pkl in turn,
    its result pickled to ``<index>.pkl`` there, at nice 19 on
    ``CPU_REF_THREADS`` threads."""
    import torch

    os.nice(19)
    torch.set_num_threads(CPU_REF_THREADS)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    folder = Path(folder)
    for i, (name, args) in enumerate(pickle.loads((folder / "jobs.pkl").read_bytes())):
        part = folder / f"{i}.part"
        part.write_bytes(pickle.dumps(globals()[name](*args)))
        os.replace(part, folder / f"{i}.pkl")
    return 0


def stop_cpu_references() -> None:
    """End the CPU-reference worker, whatever it is doing."""
    proc = CPU_REFS.pop("proc", None)
    if proc is not None:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    if "dir" in CPU_REFS:
        CPU_REFS.pop("dir").cleanup()
    CPU_REFS.clear()


def cpu_reference(fn, *args) -> dict:
    """``fn(*args)``: the CPU side of a hold, from the CPU-reference worker
    where ``start_cpu_references`` gave it that job (the seconds waited for
    it under "waited_s"), else run here."""
    key = (fn.__name__, args)
    if "proc" not in CPU_REFS or key not in CPU_REFS["jobs"]:
        return fn(*args)
    path = Path(CPU_REFS["dir"].name) / f"{CPU_REFS['jobs'].index(key)}.pkl"
    t0 = time.perf_counter()
    while not path.exists():
        if CPU_REFS["proc"].poll() is not None and not path.exists():
            raise AssertionError(f"the CPU-reference worker exited {CPU_REFS['proc'].returncode} "
                                 f"before {fn.__name__}{args}: its log is on standard error")
        time.sleep(0.1)
    out = pickle.loads(path.read_bytes())
    path.unlink()
    out["waited_s"] = time.perf_counter() - t0
    return out


def cpu_wait_note(ref: dict) -> str:
    """Where the CPU side ran, for a hold's log line."""
    if "waited_s" not in ref:
        return ", in this process"
    return f", in the CPU-reference worker, waited for {ref['waited_s']:.1f} s"


def as_numpy(v):
    """A tensor on any device, or an array, as a numpy array."""
    import numpy as np

    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


SECOND: dict = {}  # the second half's "proc", "result" file and "tmp" dir, while it runs
QUIET_DRAIN_S = 0.5  # s for what the stopped second half queued on the card to drain


def start_second_half() -> None:
    """Start ``second_half`` in a process of its own, in a session of its
    own so that ``quiet_card`` and ``stop_second_half`` reach the processes
    it starts too. It sets up, then waits for ``tell_second_half("go")``."""
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_second_")
    result = Path(tmp.name) / "second_half.pkl"
    env = {**os.environ, "CHIP_SMOKE_T0": repr(T0), "CHIP_SMOKE_PART": "B"}
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--second-half",
                             str(result)], stdin=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)
    SECOND.update(proc=proc, result=result, tmp=tmp)


def tell_second_half(line: str) -> None:
    """A line on the second half's standard input."""
    SECOND["proc"].stdin.write(line + "\n")
    SECOND["proc"].stdin.flush()


def check_second_half() -> None:
    """Raise where the second half has exited with a failure."""
    proc = SECOND.get("proc")
    if proc is not None and proc.poll() not in (None, 0):
        raise AssertionError(f"the second half's phases failed (exit {proc.returncode}): its log "
                             "is above, marked B")


def join_second_half() -> dict:
    """Wait for the second half; raise where it failed, else return its
    result ({"paths": {path: launches}})."""
    proc = SECOND["proc"]
    t0 = time.perf_counter()
    proc.stdin.close()
    proc.wait()
    check_second_half()
    with open(SECOND["result"], "rb") as f:
        out = pickle.load(f)
    log(f"the second half ended; waited for it {time.perf_counter() - t0:.1f} s")
    SECOND.pop("tmp").cleanup()
    SECOND.clear()
    return out


def stop_second_half() -> None:
    """End the second half and every process it started, whatever they do."""
    proc = SECOND.pop("proc", None)
    if proc is not None and proc.poll() is None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    if "tmp" in SECOND:
        SECOND.pop("tmp").cleanup()
    SECOND.clear()


@contextlib.contextmanager
def quiet_card():
    """Hold the second half and its processes stopped while a kernel's time
    is taken here, so that the card runs this process's work alone."""
    proc = SECOND.get("proc")
    live = proc is not None and proc.poll() is None
    if live:
        os.killpg(proc.pid, signal.SIGSTOP)
        time.sleep(QUIET_DRAIN_S)
    try:
        yield
    finally:
        if live:
            os.killpg(proc.pid, signal.SIGCONT)


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
    b, k = scores.shape
    bound = k4_bound(t["keep"])
    log(f"K4 B={b} K={k}: kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f}: mask "
        f"{t['mask_ms']:.4f}, walk {t['walk_ms']:.4f}), plain {plain_ms:.3f} ms, "
        f"bound {bound['bound_ms']:.5f} ms ({bound['pairs']} IoU pairs)")
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
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"], "predict_batch": batch}


def k4_bound(keep) -> dict:
    """K4's least time for a keep mask (B, K): the work this data needs,
    each kept candidate's IoU against every later one (15 operations a
    pair, 3 a candidate), against the bytes (boxes, scores, keep) once."""
    import torch

    b, k = keep.shape
    idx = torch.arange(k, device=keep.device)
    pairs = int(((k - 1 - idx)[None, :] * keep).sum())
    t_bytes = b * k * (16 + 4 + 1) / H100_BYTES_PER_S * 1e3
    t_ops = (pairs * 15 + b * k * 3) / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "pairs": pairs,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def obb_model(dev, cfg: str = OBB_CFG):
    """yolo11n-obb (or ``cfg``) at imgsz 1024 with seeded weights. Its class biases take
    the flagship head's prior, sigmoid(b) = 0.01 (AYHead.bias_init), in
    place of Detect's (sigmoid(b) of about 5e-5 at nc 15), so that
    conf=0.001 hands NMS a full candidate set, as in the serving phase."""
    import torch

    from yolo_ad_refine_tpu_torch import YOLO

    t0 = time.perf_counter()
    model = YOLO(cfg, task="obb", device=dev, imgsz=OBB_IMGSZ, seed=0)
    with torch.no_grad():
        for seq in model.model.model[model.model.head_idx].cv3:
            seq[-1].bias.fill_(-math.log((1 - 0.01) / 0.01))
    log(f"OBB: {cfg} built on {dev} in {time.perf_counter() - t0:.1f} s, "
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


def phase_obb_serving(model, dev, label: str = "OBB"):
    """The OBB predict path on the card at batch 16, imgsz 1024, fp32,
    conf 0.001, then one 2-image batch against the same model on the CPU;
    ``label`` heads the log lines."""
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
    log(f"{label} serving: 32 images, batch 16, imgsz {OBB_IMGSZ}, fp32: {32 / dt:.1f} images/s, "
        f"{dt / 2 * 1e3:.1f} ms/batch (median of 3 runs: "
        + ", ".join(f"{32 / s:.1f}" for s in seconds)
        + " images/s; host clock, preprocess + forward + NMS + results)")
    log(f"{label} serving: launches per run of the path: {launches}")
    if len(results) != 32:
        raise AssertionError(f"expected 32 results, got {len(results)}")
    for im, r in zip(imgs, results):
        d = r.obb.data
        if not (0 < len(d) <= 300 and len(r.boxes) == len(d) and np.isfinite(d).all()
                and np.isfinite(r.boxes.data).all()):
            raise AssertionError(f"bad OBB detections for an image of shape {im.shape}: {d.shape}")
    log(f"{label} serving: {sum(len(r) for r in results)} rotated detections, all finite")

    x, _ = preprocess(imgs[:2], OBB_IMGSZ, 2, torch.device(dev), torch.float32)
    with torch.inference_mode():
        y_gpu = model.model(x)[0].float().cpu()
        y_cpu = copy.deepcopy(model.model).cpu()(x.cpu())[0]
    nc = model.model.nc
    errs = {"box": (y_gpu[..., :4] - y_cpu[..., :4]).abs().max().item(),
            "score": (y_gpu[..., 4:4 + nc] - y_cpu[..., 4:4 + nc]).abs().max().item(),
            "angle": (y_gpu[..., 4 + nc:] - y_cpu[..., 4 + nc:]).abs().max().item()}
    log(f"{label} serving: card vs CPU on 2 images: max |box diff| {errs['box']:.3e} px "
        "(tol 5e-2), "
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


def phase_obb_training(dev) -> dict:
    """``YOLO(yolo11n-obb).train(task="obb")`` on the card: a seeded
    DOTA-style set of 64 train and 16 val tiles of 1024² labelled with
    corner quads, 1 epoch at batch 16 in bf16 (4 steps), the EMA validation
    and that of ``best`` through K5, and a reload of ``best`` as an OBB
    model. Then one fp32 OBB step (deterministic algorithms) against the
    CPU at ``phase_step_card_vs_cpu``'s limits. Returns {path: launches}."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.data.synthetic import make_dota_dataset
    from yolo_ad_refine_tpu_torch.models.model import build_detection_model
    from yolo_ad_refine_tpu_torch.train.obb import OBBLoss

    counters = kernel_counters()

    def counts():
        return {k: f.launches for k, f in counters.items()}

    with dcn_env(None), tempfile.TemporaryDirectory(prefix="chip_smoke_obb_train_") as tmp:
        t0 = time.perf_counter()
        data = make_dota_dataset(Path(tmp) / "dota", n_val=16, n_train=64, imgsz=OBB_IMGSZ,
                                 seed=5)
        log(f"OBB training: DOTA-style set (64 train, 16 val tiles of {OBB_IMGSZ}², corner "
            f"quads) written in {time.perf_counter() - t0:.1f} s")
        model = obb_model(dev)
        steps, mark = [], {}

        def on_batch_start(tr):
            torch.cuda.synchronize()
            mark.update(counts=counts(), t=time.perf_counter())
            if len(steps) == 0 and tr.batch["bboxes"].shape[-1] != 5:
                raise AssertionError(f"OBB batch boxes {tr.batch['bboxes'].shape}, expected 5 "
                                     "columns (xywhr)")

        def on_batch_end(tr):
            torch.cuda.synchronize()
            now = counts()
            steps.append({"ms": (time.perf_counter() - mark["t"]) * 1e3,
                          **{k: now[k] - mark["counts"][k] for k in now}})
            mark["after_steps"] = now

        model.add_callback("on_train_batch_start", on_batch_start)
        model.add_callback("on_train_batch_end", on_batch_end)
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        results = model.train(data=data, epochs=1, batch=16, imgsz=OBB_IMGSZ, amp=True,
                              plots=False, project=str(Path(tmp) / "runs"), workers=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = counts()
        trainer = model.trainer
        val = {k: run[k] - mark["after_steps"][k] for k in run}
        ms = statistics.median(st["ms"] for st in steps[1:])
        log(f"OBB training: {len(steps)} steps + validations in {wall:.1f} s; bf16 autocast "
            f"{trainer.amp_dtype is not None}; steps " + ", ".join(f"{st['ms']:.1f}" for st in steps)
            + f" ms; {ms:.1f} ms a step (median of steps 2-4, host clock with a synchronise), "
            f"{16 / ms * 1e3:.1f} images/s at batch 16, imgsz {OBB_IMGSZ}")
        log(f"OBB training: launches in the run {run}; in the validations after the steps {val}")
        if len(steps) != 4 or trainer.amp_dtype is None:
            raise AssertionError(f"expected 4 bf16 OBB steps, got {len(steps)} "
                                 f"(amp {trainer.amp_dtype})")
        if any(st[k] for st in steps for k in run) or val["nms_rotated"] != 2 or \
                any(val[k] for k in run if k != "nms_rotated"):
            raise AssertionError("the OBB run did not launch K5 once in each of its two "
                                 f"validations and nothing else: steps {steps}, validations {val}")
        csv = (Path(results["save_dir"]) / "results.csv").read_text().splitlines()
        row = dict(zip(csv[0].split(","), csv[1].split(",")))
        losses = [float(row[k]) for k in ("train/box_loss", "train/cls_loss", "train/dfl_loss",
                                          "val/box_loss", "val/cls_loss", "val/dfl_loss")]
        log(f"OBB training: results.csv train box / cls / dfl {losses[:3]}, val {losses[3:]}; "
            f"mAP50 {results.get('metrics/mAP50(B)', 0.0):.4f}")
        if not all(math.isfinite(v) and v > 0 for v in losses):
            raise AssertionError(f"OBB losses not finite and positive: {losses}")
        best = Path(results["save_dir"]) / "weights" / "best"
        reloaded = YOLO(str(best), device=dev)
        img = np.random.default_rng(1).integers(0, 256, (OBB_IMGSZ, OBB_IMGSZ, 3), dtype=np.uint8)
        res = reloaded.predict([img], imgsz=OBB_IMGSZ, conf=0.001)
        if reloaded.task != "obb" or res[0].obb is None or not np.isfinite(res[0].obb.data).all():
            raise AssertionError("best did not reload and predict as an OBB model")
        log(f"OBB training: {best.name} reloaded as task {reloaded.task}, "
            f"{len(res[0])} rotated boxes on one tile")

    r = np.random.default_rng(4)
    xy, wh = r.uniform(48, 208, (2, 8, 2)), r.uniform(12, 60, (2, 8, 2))
    mask = (np.arange(8)[None, :, None] < np.array([[[6]], [[4]]])).astype(np.float32)
    boxes = np.concatenate([xy, wh, r.uniform(0, np.pi / 2, (2, 8, 1))], -1).astype(np.float32)
    batch = {"img": r.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8),
             "cls": r.integers(0, 15, (2, 8, 1)).astype(np.float32),
             "bboxes": boxes * mask, "mask": mask}
    base = build_detection_model(OBB_CFG, device="cpu", seed=3, imgsz=256)
    hold_step_card_vs_cpu("OBB card vs CPU step", dev, base, batch,
                          lambda: OBBLoss(nc=15, strides=(8, 16, 32)))
    return {"obb_training_run": run, "obb_training_ms_per_step": ms}


# the task helpers' models, full width: scale n, YOLO-World at s (its published size)
TASK_CFGS = {"segment": "yolo11n-seg.yaml", "pose": "yolo11n-pose.yaml", "v10": "yolov10n.yaml",
             "world": "yolov8s-worldv2.yaml",
             # the stock zoo (phase_zoo): the task helpers take a model key too
             **{k: f"{k}.yaml" for k in ("yolov8n", "yolov5n", "yolov3", "yolov9c",
                                        "yolov8n-seg", "yolov8n-pose")}}
ZOO_TASKS = {"yolov8n-seg": "segment", "yolov8n-pose": "pose"}
TASK_IMGSZ = 640
WORLD_NAMES = ["person", "car", "dog"]  # the vocabulary set_classes gives the World model


def model_task(task: str) -> str:
    """The YOLO task of a task helper's model: YOLOv10, YOLO-World and the
    zoo's detectors detect."""
    return ZOO_TASKS.get(task, task if task in ("segment", "pose") else "detect")


def k4_per_run(task: str) -> int:
    """K4's launches on 64 served images at batch 32, or 16 validated at
    batch 8: once a batch, and none for YOLOv10, which selects without NMS."""
    return 0 if task == "v10" else 2


def logit(p: float) -> float:
    return -math.log((1 - p) / p)


def task_dataset(task: str):
    """The seeded set writer of a task helper, called as (root, n_val=,
    n_train=, imgsz=, seed=): polygons, 17-keypoint figures, or the shapes
    set (YOLOv10, YOLO-World)."""
    from yolo_ad_refine_tpu_torch.data import synthetic

    if model_task(task) in ("segment", "pose"):
        return {"segment": synthetic.make_segment_dataset,
                "pose": synthetic.make_pose_dataset}[model_task(task)]
    return lambda root, n_train=0, **kw: synthetic.make_shapes_dataset(
        root, n_train=max(n_train, 1), **kw)
MASK_FLIP_TOL = 2e-3  # share of mask pixels card vs CPU may flip (tests/test_torch_segment.py)


def task_model(task: str, dev):
    """yolo11n-seg (nc 80), yolo11n-pose (nc 1, 17 keypoints), yolov10n (nc
    80) or yolov8s-worldv2 (the 80-name placeholder vocabulary, then
    ``set_classes(WORLD_NAMES)``) at 640 with seeded weights. Seeded Detect
    heads score every anchor of a level alike (about 1e-5); class 0's bias
    at the P5 level takes the prior 0.3 and every other class bias 0.01
    (v10: in both branches, the one-to-one's selecting), so that at conf
    0.25 the NMS keeps tens of detections an image out of the 400 P5
    candidates, as in a served batch, and a multi-label validation ranks
    those same rows first. WorldDetect has one bias a level for every
    class: 0.3 at P5, 0.01 elsewhere."""
    import torch

    from yolo_ad_refine_tpu_torch import YOLO

    t0 = time.perf_counter()
    model = YOLO(TASK_CFGS[task], task=model_task(task), device=dev, imgsz=TASK_IMGSZ, seed=0)
    head = model.model.model[model.model.head_idx]
    with torch.no_grad():
        if task == "world":
            for i, contrast in enumerate(head.cv4):
                contrast.bias.fill_(logit(0.3 if i == 2 else 0.01))
        else:
            for cv3 in (head.cv3, *((head.cv3_one2one,) if task == "v10" else ())):
                for seq in cv3:
                    seq[-1].bias.fill_(logit(0.01))
                cv3[2][-1].bias[0] = logit(0.3)
    if task == "world":
        model.set_classes(WORLD_NAMES)
    log(f"{task}: {TASK_CFGS[task]} built on {dev} in {time.perf_counter() - t0:.1f} s, "
        f"{model.model.num_params():,} parameters, strides {model.model.strides}, "
        f"{model.model.n_scores} score columns")
    return model


def task_serving(task: str, model, dev) -> dict:
    """The task's predict path on the card: 64 images of the serving shapes
    at batch 32, 640, fp32, conf 0.25, three timed runs, K4 once a batch
    (YOLOv10: never, its rows are selected without NMS); the masks' share
    of a batch (``engine/predictor.py segment_masks`` on one batch's NMS
    output, timed alone with a synchronise); then 2 images card vs CPU: the
    decoded boxes, scores (YOLO-World: a column per name of its vocabulary)
    and keypoints (v10: the one-to-one decode, anchor by anchor, before the
    selection), and the masks of 32 fixed anchors from each side's
    prototypes and coefficients."""
    kind = model_task(task)
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch.engine.predictor import preprocess, segment_masks
    from yolo_ad_refine_tpu_torch.nn.head import decode_detections
    from yolo_ad_refine_tpu_torch.ops.nms import non_max_suppression

    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (*SERVING_SHAPES[i % len(SERVING_SHAPES)], 3), dtype=np.uint8)
            for i in range(64)]
    model.predict(imgs[:32], conf=0.25, batch=32)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    counters = kernel_counters()
    seconds = []
    for _ in range(3):
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        results = model.predict(imgs, conf=0.25, batch=32)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = {k: f.launches for k, f in counters.items()}
        if launches["nms_suppress"] != k4_per_run(task) or any(
                v for k, v in launches.items() if k != "nms_suppress"):
            raise AssertionError(f"{task} serving did not launch K4 {k4_per_run(task)} times "
                                 f"(once a batch, v10 never) and nothing else: {launches}")
    dt = sorted(seconds)[1]
    kept = [len(r) for r in results]
    log(f"{task} serving: 64 images, batch 32, imgsz {TASK_IMGSZ}, fp32, conf 0.25: "
        f"{64 / dt:.1f} images/s, {dt / 2 * 1e3:.1f} ms/batch (median of 3 runs: "
        + ", ".join(f"{64 / s:.1f}" for s in seconds) + " images/s; host clock, preprocess + "
        f"forward + NMS + {'masks + ' if kind == 'segment' else ''}results); kept "
        f"{np.mean(kept):.1f} an image (min {min(kept)}, max {max(kept)}); launches {launches}")
    if not all(0 < k <= 300 for k in kept):
        raise AssertionError(f"{task} serving: an image kept no detection or too many: {kept}")
    for r in results:
        extra = {"segment": r.masks, "pose": r.keypoints}.get(kind, r.boxes)
        if extra is None or len(extra) != len(r) or not np.isfinite(r.boxes.data).all():
            raise AssertionError(f"{task} serving: bad results for an image of {r.orig_shape}")
        if task == "world" and not set(r.boxes.cls.tolist()) <= set(range(len(WORLD_NAMES))):
            raise AssertionError(f"world serving: classes outside the vocabulary {r.boxes.cls}")
        if kind == "segment" and r.masks.data.shape != (len(r), *r.orig_shape):
            raise AssertionError(f"segment serving: masks {r.masks.data.shape}")
        if kind == "pose" and not (r.keypoints.data.shape == (len(r), 17, 3)
                                   and np.isfinite(r.keypoints.data).all()):
            raise AssertionError(f"pose serving: keypoints {r.keypoints.data.shape}")
    out = {"run": launches, "images_per_s": 64 / dt, "ms_per_batch": dt / 2 * 1e3,
           "kept_mean": float(np.mean(kept))}
    if kind == "segment":
        cover = float(np.mean([r.masks.data.mean() for r in results if len(r)]))
        out["mask_mb_per_batch"] = sum(r.masks.data.nbytes for r in results) / 2 / 2**20
        x, metas = preprocess(imgs[:32], TASK_IMGSZ, 32, torch.device(dev), torch.float32)
        with torch.inference_mode():
            y, feats = model.model(x)
            det, cnt, extras = non_max_suppression(y, conf_thres=0.25, iou_thres=0.7,
                                                   nc=model.model.nc)
            cnt = cnt.cpu().numpy()
            shapes = [im.shape[:2] for im in imgs[:32]]
            ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                segment_masks(feats[2], extras, det, cnt, metas, shapes, TASK_IMGSZ)
                ms.append((time.perf_counter() - t0) * 1e3)
        out["masks_ms_per_batch"] = sorted(ms)[1]
        log(f"segment serving: the masks of a batch ({int(cnt.sum())} kept rows, proto to "
            f"original-size bool masks on the card and their copy to the host) "
            f"{out['masks_ms_per_batch']:.1f} ms (median of 3: "
            + ", ".join(f"{v:.1f}" for v in ms)
            + f"), {out['masks_ms_per_batch'] / out['ms_per_batch'] * 100:.1f} % of the "
            f"{out['ms_per_batch']:.1f} ms batch; the kept masks hold "
            f"{out['mask_mb_per_batch']:.0f} MiB of bool a batch on the host, mask pixels set "
            f"{cover * 100:.2f} %")

    x, metas = preprocess(imgs[:2], TASK_IMGSZ, 2, torch.device(dev), torch.float32)
    strides = model.model.strides
    with torch.inference_mode():
        y_gpu, f_gpu = model.model(x)
        cpu = copy.deepcopy(model.model).cpu()
        y_cpu, f_cpu = cpu(x.cpu())
        if task == "v10":  # the decode the selection reads, anchor by anchor
            y_gpu, y_cpu = (decode_detections(f["one2one"], strides, model.model.nc)
                            for f in (f_gpu, f_cpu))
    y_gpu = y_gpu.float().cpu()
    nc = model.model.n_scores
    errs = {"box": (y_gpu[..., :4] - y_cpu[..., :4]).abs().max().item(),
            "score": (y_gpu[..., 4:4 + nc] - y_cpu[..., 4:4 + nc]).abs().max().item()}
    if kind == "pose":
        k = (y_gpu[..., 4 + nc:] - y_cpu[..., 4 + nc:]).reshape(2, -1, 17, 3).abs()
        errs["keypoint"], errs["visibility"] = k[..., :2].max().item(), k[..., 2].max().item()
    elif kind == "segment":
        errs["coefficient"] = (y_gpu[..., 4 + nc:] - y_cpu[..., 4 + nc:]).abs().max().item()
        errs["mask_pixels_flipped"] = anchor_mask_flips(
            (y_gpu, f_gpu), (y_cpu, f_cpu), nc, metas, imgs, TASK_IMGSZ, "segment serving")
    log(f"{task} serving: card vs CPU on 2 images: " + ", ".join(
        f"max |{k} diff| {v:.3e}" if k != "mask_pixels_flipped" else
        f"mask pixels flipped (32 anchors an image) {v:.3e}" for k, v in errs.items())
        + f" (tol boxes and keypoints 5e-2 px, scores, coefficients and visibility 1e-3, "
        f"mask pixels flipped {MASK_FLIP_TOL})")
    n_anchors = sum((TASK_IMGSZ // s) ** 2 for s in strides)
    width = 4 + nc + {"segment": 32, "pose": 51}.get(kind, 0)
    if not (y_gpu.shape == (2, n_anchors, width) and torch.isfinite(y_gpu).all()):
        raise AssertionError(f"bad decoded {task} predictions {tuple(y_gpu.shape)}")
    lim = {"box": 5e-2, "score": 1e-3, "keypoint": 5e-2, "visibility": 1e-3,
           "coefficient": 1e-3, "mask_pixels_flipped": MASK_FLIP_TOL}
    if any(v > lim[k] for k, v in errs.items()):
        raise AssertionError(f"card and CPU {task} predictions disagree: {errs}")
    return out


def anchor_mask_flips(card, cpu, nc: int, metas, imgs, imgsz: int, label: str) -> float:
    """The largest share of mask pixels that differ between the card's and
    the CPU's masks of 32 fixed anchors an image: each side's (decoded
    predictions, features) from its own prototypes and coefficients, both
    at the CPU's boxes, scaled to the original images."""
    import torch

    from yolo_ad_refine_tpu_torch.ops.masks import process_mask, scale_masks

    y_cpu = cpu[0]
    anchors = torch.arange(0, y_cpu.shape[1], y_cpu.shape[1] // 32)[:32]
    flips = []
    for j, (ratio, pad) in enumerate(metas):
        boxes = y_cpu[j, anchors, :4]
        boxes = torch.cat([boxes[:, :2] - boxes[:, 2:] / 2, boxes[:, :2] + boxes[:, 2:] / 2], 1)
        m = [scale_masks(process_mask(f[2][j], yy[j, anchors, 4 + nc:].to(f[2].device),
                                      boxes.to(f[2].device), (imgsz, imgsz)),
                         pad, ratio[0], imgs[j].shape[:2]).cpu()
             for yy, f in (card, cpu)]
        flips.append((m[0] != m[1]).float().mean().item())
        if not m[1].any():
            raise AssertionError(f"{label}: the held anchors' masks are empty")
    return max(flips)


def task_val(task: str, model, dev) -> dict:
    """``.val`` of the task's model on a seeded set of 16 images of 640² at
    batch 8 (polygons, 17-keypoint figures, or for YOLOv10 and YOLO-World
    the shapes set), each image labelled with the model's own detections
    at conf 0.25 (the first 20 for those two): K4 once a batch (v10:
    never), finite metrics, and the (B) and (M) / (P) metrics within 1e-3
    of the same validation on the CPU. The seeded head scores its ~70 kept rows alike,
    so the AP is about the share of them labelled: pose labels them all
    (boxes and keypoints); segment, whose ~70 masks overlap in one index
    mask (0.035 mAP50(M) so labelled, measured on one H100), labels the first 3
    rows' contours and validates with ``max_det=3``."""
    import cv2
    kind = model_task(task)
    import numpy as np
    import torch

    tag = {"segment": "M", "pose": "P"}.get(kind, "B")
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{task}_val_") as tmp:
        root = Path(tmp) / task
        data = task_dataset(task)(root, n_val=16, imgsz=TASK_IMGSZ, seed=0)
        files = sorted((root / "val" / "images").glob("*.jpg"))
        for f, r in zip(files, model.predict([cv2.imread(str(f)) for f in files], conf=0.25,
                                             batch=16)):
            if kind == "segment":
                rows = [f"{int(c)} " + " ".join(f"{v:.6f}" for v in (p / TASK_IMGSZ).reshape(-1))
                        for c, p in zip(r.boxes.cls[:3], r.masks.xy[:3]) if len(p) >= 3]
            elif kind != "pose":
                rows = [f"{int(c)} " + " ".join(f"{v:.6f}" for v in b.clip(0, 1))
                        for b, c in zip(r.boxes.xywhn[:20], r.boxes.cls[:20])]
            else:
                rows = ["0 " + " ".join(f"{v:.6f}" for v in (*b.clip(0, 1), *np.concatenate(
                    [k.clip(0, 1), np.full((17, 1), 2.0)], -1).reshape(-1)))
                        for b, k in zip(r.boxes.xywhn, r.keypoints.xyn)]
            (root / "val" / "labels" / f"{f.stem}.txt").write_text("\n".join(rows) + "\n")
        args = {"data": data, "imgsz": TASK_IMGSZ, "batch": 8, "conf": 0.001,
                "max_det": 3 if kind == "segment" else 300}
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
    keys = tuple(dict.fromkeys((
        "metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)",
        f"metrics/mAP50({tag})", f"metrics/mAP50-95({tag})", "fitness")))
    log(f"{task} val: 16 images at batch 8 in {wall:.2f} s, {wall / 16 * 1e3:.1f} ms an image "
        f"(host clock, loader to metrics; the validator's own {metrics['speed_ms_per_image']:.1f} "
        f"ms, of it inference + NMS{' + mask IoU' if kind == 'segment' else ''} "
        f"{metrics['inference_ms_per_image']:.1f} ms); launches {launches}")
    log(f"{task} val: card " + ", ".join(f"{k} {metrics[k]:.6f}" for k in keys))
    log(f"{task} val: CPU ({cpu_s:.1f} s) " + ", ".join(f"{k} {want[k]:.6f}" for k in keys)
        + " (tol 1e-3)")
    if launches["nms_suppress"] != k4_per_run(task):
        raise AssertionError(f"K4 was not launched {k4_per_run(task)} times (once a batch, v10 "
                             f"never) in the {task} validation: {launches}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite {task} val metrics {metrics}")
    if metrics[f"metrics/mAP50({tag})"] <= 0.05 or any(abs(metrics[k] - want[k]) > 1e-3
                                                       for k in keys):
        raise AssertionError(f"the card's {task} val metrics are vacuous or disagree with the "
                             "CPU's")
    return {"run": launches, "ms_per_image": wall / 16 * 1e3}


def task_training(task: str, dev, hold_step: bool = True) -> dict:
    """``YOLO(yolo11n-seg | yolo11n-pose | yolov10n).train()`` on the card: a
    seeded set of 64 train and 16 val images of 640², 1 epoch at batch 16
    in bf16 (4 steps), the EMA validation and that of ``best`` through K4
    (v10: no K4, and E2EDetectLoss), and a reload of ``best`` as the task's
    model. Then, with ``hold_step``, one fp32 step of the task's loss
    (deterministic algorithms) against the CPU at ``phase_step_card_vs_cpu``'s
    limits. ``task`` may be a zoo model's key (``TASK_CFGS``): yolov9c and
    yolov3 train with DetectionLoss."""
    kind = model_task(task)
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.data.build import collate
    from yolo_ad_refine_tpu_torch.data.dataset import YOLODataset, check_det_dataset
    from yolo_ad_refine_tpu_torch.models.model import build_detection_model
    from yolo_ad_refine_tpu_torch.train.loss import DetectionLoss, E2EDetectLoss
    from yolo_ad_refine_tpu_torch.train.pose import PoseLoss
    from yolo_ad_refine_tpu_torch.train.segment import SegmentationLoss

    counters = kernel_counters()

    def counts():
        return {k: f.launches for k, f in counters.items()}

    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{task}_train_") as tmp:
        t0 = time.perf_counter()
        data = task_dataset(task)(Path(tmp) / task, n_val=16, n_train=64, imgsz=TASK_IMGSZ,
                                  seed=5)
        log(f"{task} training: seeded set (64 train, 16 val images of {TASK_IMGSZ}²) written "
            f"in {time.perf_counter() - t0:.1f} s")
        model = YOLO(TASK_CFGS[task], task=model_task(task), device=dev, imgsz=TASK_IMGSZ, seed=0)
        steps, mark = [], {}

        def on_batch_start(tr):
            torch.cuda.synchronize()
            mark.update(counts=counts(), t=time.perf_counter())

        def on_batch_end(tr):
            torch.cuda.synchronize()
            now = counts()
            steps.append({"ms": (time.perf_counter() - mark["t"]) * 1e3,
                          **{k: now[k] - mark["counts"][k] for k in now}})
            mark["after_steps"] = now

        model.add_callback("on_train_batch_start", on_batch_start)
        model.add_callback("on_train_batch_end", on_batch_end)
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        results = model.train(data=data, epochs=1, batch=16, imgsz=TASK_IMGSZ, amp=True,
                              plots=False, project=str(Path(tmp) / "runs"), workers=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = counts()
        trainer = model.trainer
        val = {k: run[k] - mark["after_steps"][k] for k in run}
        ms = statistics.median(st["ms"] for st in steps[1:])
        log(f"{task} training: {len(steps)} steps + validations in {wall:.1f} s; bf16 autocast "
            f"{trainer.amp_dtype is not None}; steps " + ", ".join(f"{st['ms']:.1f}" for st in steps)
            + f" ms; {ms:.1f} ms a step (median of steps 2-4, host clock with a synchronise), "
            f"{16 / ms * 1e3:.1f} images/s at batch 16, imgsz {TASK_IMGSZ}; launches in the run "
            f"{run}, in the validations after the steps {val}")
        if len(steps) != 4 or trainer.amp_dtype is None:
            raise AssertionError(f"expected 4 bf16 {task} steps, got {len(steps)}")
        if any(st[k] for st in steps for k in run) or \
                val["nms_suppress"] != (0 if task == "v10" else 2) or \
                any(val[k] for k in run if k != "nms_suppress"):
            raise AssertionError(f"the {task} run did not launch K4 once in each of its two "
                                 f"validations (v10: never) and nothing else: steps {steps}, "
                                 f"validations {val}")
        csv = (Path(results["save_dir"]) / "results.csv").read_text().splitlines()
        row = dict(zip(csv[0].split(","), csv[1].split(",")))
        losses = [float(row[k]) for k in ("train/box_loss", "train/cls_loss", "train/dfl_loss",
                                          "val/box_loss", "val/cls_loss", "val/dfl_loss")]
        tag = {"segment": "M", "pose": "P"}.get(kind, "B")
        log(f"{task} training: results.csv train box / cls / dfl {losses[:3]}, val {losses[3:]}; "
            f"mAP50(B) {results.get('metrics/mAP50(B)', 0.0):.4f}, mAP50({tag}) "
            f"{results.get(f'metrics/mAP50({tag})', float('nan')):.4f}")
        if not all(math.isfinite(v) and v > 0 for v in losses) or \
                not math.isfinite(results[f"metrics/mAP50({tag})"]):
            raise AssertionError(f"{task} losses or metrics not finite: {losses}, {results}")
        best = Path(results["save_dir"]) / "weights" / "best"
        reloaded = YOLO(str(best), device=dev)
        if reloaded.task != model_task(task):
            raise AssertionError(f"best reloaded as {reloaded.task}, not {model_task(task)}")
        # one collated batch of 2 at 256 for the fp32 step against the CPU
        info = check_det_dataset(data)
        kw = ({"kpt_shape": data["kpt_shape"], "flip_idx": data["flip_idx"]}
              if kind == "pose" else {})
        ds = YOLODataset(info["val"], imgsz=256, augment=False, nc=len(info["names"]),
                         max_boxes=16, task=model_task(task), **kw)
        batch = collate([ds.get_sample(i) for i in range(2)], 16)
    nc = len(info["names"])
    base = build_detection_model(TASK_CFGS[task], nc=nc, device="cpu", seed=3, imgsz=256)
    make_loss = {"segment": lambda: SegmentationLoss(nc=nc, strides=(8, 16, 32)),
                 "pose": lambda: PoseLoss(nc=nc, strides=(8, 16, 32)),
                 "v10": lambda: E2EDetectLoss(nc=nc, strides=(8, 16, 32))}.get(
        task if task == "v10" else kind, lambda: DetectionLoss(nc=nc, strides=(8, 16, 32)))
    if not hold_step:
        return {"run": run, "ms_per_step": ms}
    hold_step_card_vs_cpu(f"{task} card vs CPU step", dev, base,
                          {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}, make_loss)
    return {"run": run, "ms_per_step": ms}


def phase_task(task: str, dev) -> dict:
    """The segment or pose slice on the card: serving, validation and
    training (``task_serving``, ``task_val``, ``task_training``). Returns
    {"paths": {path: launches}, ...the measurements}."""
    model = task_model(task, dev)
    serving = task_serving(task, model, dev)
    val = task_val(task, model, dev)
    del model
    training = task_training(task, dev)
    return {"paths": {f"{task}_serving_run": serving["run"], f"{task}_val_run": val["run"],
                      f"{task}_training_run": training["run"]},
            "serving": serving, "val_ms_per_image": val["ms_per_image"],
            "ms_per_step": training["ms_per_step"]}


def phase_segment(dev) -> dict:
    """yolo11n-seg served, validated and trained on the card (``phase_task``)."""
    return phase_task("segment", dev)


def phase_pose(dev) -> dict:
    """yolo11n-pose served, validated and trained on the card (``phase_task``)."""
    return phase_task("pose", dev)


def phase_v10(dev) -> dict:
    """yolov10n (NMS-free) served, validated and trained on the card
    (``phase_task``), none of it launching K4."""
    return phase_task("v10", dev)


def k4_on_world(model, dev) -> dict:
    """K4 held against its plain version on one World serving batch's
    candidates (32 images, single-label at conf 0.25, as the predictor
    selects them) and one validation batch's (8 images, multi-label at conf
    0.001 over the 3 names, as the validator does): equal keep masks, and
    the kernel's and the plain version's times on each."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch.engine.profile_nms import Impl, predict_candidates, time_case
    from yolo_ad_refine_tpu_torch.ops.nms import suppress, suppress_plain

    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (*SERVING_SHAPES[i % len(SERVING_SHAPES)], 3), dtype=np.uint8)
            for i in range(32)]
    cases = {"serving conf 0.25": (*predict_candidates(model, imgs, TASK_IMGSZ, (0.25,))[0.25],
                                   0.25),
             "val conf 0.001": (*predict_candidates(model, imgs[:8], TASK_IMGSZ, (0.001,),
                                                    multi_label=True)[0.001], 0.001)}
    out = {}
    for label, (bx, sc, conf) in cases.items():
        got, want = suppress(bx, sc, NMS_IOU, conf), suppress_plain(bx, sc, NMS_IOU, conf)
        if not torch.equal(got, want):
            raise AssertionError(f"K4 keep mask differs from plain on the World {label} batch: "
                                 f"{int((got != want).sum())} entries")
        with quiet_card():
            r = time_case(Impl(), "K4", bx, sc, conf)
            plain_ms = cuda_time(lambda: suppress_plain(bx, sc, NMS_IOU, conf), iters=3,
                                 warmup=1)
        b, k = sc.shape
        bound = k4_bound(got)
        out[label] = {"B": b, "K": k, "ms": r["ms"], "device_ms": r["device_ms"],
                      "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
                      "bound_by": bound["bound_by"], "kept": r["kept"], "valid": r["valid"]}
        log(f"K4 on the World {label} batch's candidates (B={b}, K={k}): keep mask equal to "
            f"plain; kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain "
            f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.5f} ms ({bound['pairs']} IoU "
            f"pairs), {r['kept']} kept of {r['valid']} valid")
    return out


def phase_world(dev) -> dict:
    """yolov8s-worldv2 at 640 with ``set_classes(WORLD_NAMES)``: served
    (``task_serving``: 64 images at batch 32, fp32, K4 once a batch, card vs
    CPU), K4 held against its plain version on a serving and a validation
    batch's candidates (``k4_on_world``), validated (``task_val``: 16
    images at batch 8, K4 once a batch, card vs CPU at 1e-3), and its
    training held to raise, as the JAX train step does (it passes the graph
    no text embeddings)."""
    model = task_model("world", dev)
    serving = task_serving("world", model, dev)
    k4 = k4_on_world(model, dev)
    val = task_val("world", model, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_world_train_") as tmp:
        data = task_dataset("world")(Path(tmp) / "ds", n_val=2, n_train=2, imgsz=TASK_IMGSZ)
        try:
            model.train(data=data, epochs=1, batch=2, imgsz=TASK_IMGSZ, plots=False,
                        project=str(Path(tmp) / "runs"))
        except ValueError as e:
            if "C2fAttn needs text embeddings" not in str(e):
                raise
            log(f"world training raises, as the JAX train step does: {e}")
        else:
            raise AssertionError("YOLO-World training ran; the JAX train step raises on it")
    return {"paths": {"world_serving_run": serving["run"], "world_val_run": val["run"]},
            "serving": serving, "val_ms_per_image": val["ms_per_image"], "k4": k4}


RTDETR_CFG, RTDETR_IMGSZ = "rtdetr-l.yaml", 640  # nc 80, nq 300, 6 decoder layers
LAP_TOL = 1e-3  # |kernel - plain| of a matrix's optimal cost (fp32 sums of up to 128 terms)


def rtdetr_model(dev):
    """rtdetr-l at 640 with seeded weights; the decoder's score heads at
    the class prior 0.01, and the last layer's class 0 shifted so that a
    tenth of the queries of two seeded images score over 0.25: at conf
    0.25 tens of the 300 queries an image are kept, as in a served
    batch. The encoder's selection keeps its seeded scores."""
    import torch

    from yolo_ad_refine_tpu_torch import YOLO

    t0 = time.perf_counter()
    model = YOLO(RTDETR_CFG, device=dev, imgsz=RTDETR_IMGSZ, seed=0)
    head = model.model.model[model.model.head_idx]
    with torch.no_grad():
        for h in head.dec_score_head:
            h.bias.fill_(logit(0.01))
        x = torch.rand(2, 3, RTDETR_IMGSZ, RTDETR_IMGSZ,
                       generator=torch.Generator().manual_seed(0)).to(dev)
        cls0 = model.model(x)[1][1][-1][..., 0].float().flatten()  # the last layer's logits
        head.dec_score_head[-1].bias[0] += logit(0.25) - torch.quantile(cls0, 0.9).item()
    log(f"rtdetr: {RTDETR_CFG} built on {dev} in {time.perf_counter() - t0:.1f} s, "
        f"{model.model.num_params():,} parameters, nq {head.nq}, {head.ndl} decoder layers")
    return model


def tie_encoder_scores(model):
    """``model`` (a DetectionModel) with its encoder score head constant:
    every anchor ties, so the selection is the first nq anchors in index
    order on every device (``lax.top_k``'s tie order, the port's stable
    sort). Seeded weights leave groups of exactly tied scores (anchors of
    equal features) that may straddle the 300th place, where the last bit
    of a card or CPU convolution decides which are selected; a card-vs-CPU
    hold compares the same queries only with the selection fixed."""
    import torch

    head = model.model[model.head_idx].enc_score_head
    with torch.no_grad():
        head.weight.zero_()
        head.bias.fill_(0.0)
    return model


def rtdetr_serving(model, dev) -> dict:
    """The RT-DETR predict path on the card: 64 images of the serving
    shapes at batch 32, 640, fp32, conf 0.25, three timed runs, no kernel
    launched (it is NMS-free: ``rtdetr_rows``); then 2 images card vs CPU,
    the normalised boxes in pixels and the scores of the 300 queries, on
    a copy whose selection is fixed (``tie_encoder_scores``)."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch.engine.predictor import preprocess

    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (*SERVING_SHAPES[i % len(SERVING_SHAPES)], 3), dtype=np.uint8)
            for i in range(64)]
    model.predict(imgs[:32], conf=0.25, batch=32)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    counters = kernel_counters()
    seconds = []
    for _ in range(3):
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        results = model.predict(imgs, conf=0.25, batch=32)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = {k: f.launches for k, f in counters.items()}
        if any(launches.values()):
            raise AssertionError(f"rtdetr serving launched a kernel (it is NMS-free): {launches}")
    dt = sorted(seconds)[1]
    kept = [len(r) for r in results]
    log(f"rtdetr serving: 64 images, batch 32, imgsz {RTDETR_IMGSZ}, fp32, conf 0.25: "
        f"{64 / dt:.1f} images/s, {dt / 2 * 1e3:.1f} ms/batch (median of 3 runs: "
        + ", ".join(f"{64 / s:.1f}" for s in seconds) + " images/s; host clock, preprocess + "
        f"forward + decode + results); kept {np.mean(kept):.1f} an image (min {min(kept)}, "
        f"max {max(kept)}); launches {launches} (K4 0: no NMS)")
    if not all(0 < k <= 300 for k in kept) or not all(np.isfinite(r.boxes.data).all()
                                                      for r in results):
        raise AssertionError(f"rtdetr serving: an image kept no query, or bad rows: {kept}")
    x, _ = preprocess(imgs[:2], RTDETR_IMGSZ, 2, torch.device(dev), torch.float32)
    tied = tie_encoder_scores(copy.deepcopy(model.model))
    with torch.inference_mode():
        y_gpu = tied(x)[0].float().cpu()
        y_cpu = tied.cpu()(x.cpu())[0]
    errs = {"box_px": ((y_gpu[..., :4] - y_cpu[..., :4]).abs().max() * RTDETR_IMGSZ).item(),
            "score": (y_gpu[..., 4:] - y_cpu[..., 4:]).abs().max().item()}
    log(f"rtdetr serving: card vs CPU on 2 images: max |box diff| {errs['box_px']:.3e} px, "
        f"max |score diff| {errs['score']:.3e} (tol 5e-2 px, 1e-3)")
    if y_gpu.shape != (2, 300, 84) or not torch.isfinite(y_gpu).all():
        raise AssertionError(f"bad RT-DETR eval output {tuple(y_gpu.shape)}")
    if errs["box_px"] > 5e-2 or errs["score"] > 1e-3:
        raise AssertionError(f"card and CPU RT-DETR outputs disagree: {errs}")
    return {"run": launches, "images_per_s": 64 / dt, "ms_per_batch": dt / 2 * 1e3,
            "kept_mean": float(np.mean(kept))}


def label_with_own_rows(model, root: Path, n: int = 20) -> None:
    """Each val image of the set at ``root`` labelled with the model's own
    first ``n`` rows at conf 0.25, so that a validation reads mAP above 0."""
    import cv2

    files = sorted((root / "val" / "images").glob("*.jpg"))
    for f, r in zip(files, model.predict([cv2.imread(str(f)) for f in files], conf=0.25,
                                         batch=16)):
        rows = [f"{int(c)} " + " ".join(f"{v:.6f}" for v in b.clip(0, 1))
                for b, c in zip(r.boxes.xywhn[:n], r.boxes.cls[:n])]
        (root / "val" / "labels" / f"{f.stem}.txt").write_text("\n".join(rows) + "\n")


def rtdetr_val(model, dev) -> dict:
    """``.val`` of rtdetr-l on 16 seeded shapes images of 640² at batch 8,
    each labelled with the model's own first 20 rows: no kernel (no NMS,
    no val loss through the facade), finite metrics within 1e-3 of the
    same validation on the CPU."""
    import torch

    from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset

    with tempfile.TemporaryDirectory(prefix="chip_smoke_rtdetr_val_") as tmp:
        root = Path(tmp) / "ds"
        data = make_shapes_dataset(root, n_train=1, n_val=16, imgsz=RTDETR_IMGSZ, seed=0)
        label_with_own_rows(model, root)
        args = {"data": data, "imgsz": RTDETR_IMGSZ, "batch": 8, "conf": 0.001}
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
    keys = ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
            "metrics/mAP50-95(B)", "fitness")
    log(f"rtdetr val: 16 images at batch 8 in {wall:.2f} s, {wall / 16 * 1e3:.1f} ms an image "
        f"(host clock, loader to metrics; the validator's own {metrics['speed_ms_per_image']:.1f}"
        f" ms, of it inference + decode {metrics['inference_ms_per_image']:.1f} ms); launches "
        f"{launches}")
    log("rtdetr val: card " + ", ".join(f"{k} {metrics[k]:.6f}" for k in keys))
    log(f"rtdetr val: CPU ({cpu_s:.1f} s) " + ", ".join(f"{k} {want[k]:.6f}" for k in keys)
        + " (tol 1e-3)")
    if any(launches.values()) or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"rtdetr val launched a kernel or gave non-finite metrics: "
                             f"{launches}, {metrics}")
    if metrics["metrics/mAP50(B)"] <= 0.05 or any(abs(metrics[k] - want[k]) > 1e-3
                                                  for k in keys):
        raise AssertionError("the card's rtdetr val metrics are vacuous or disagree with the CPU's")
    return {"run": launches, "ms_per_image": wall / 16 * 1e3}


def rtdetr_training(dev) -> dict:
    """``YOLO("rtdetr-l.yaml").train()`` on the card: a seeded shapes set of
    64 train and 16 val images of 640², 1 epoch at batch 16 in bf16 (4
    steps), each step with a denoising group (max_boxes 128: ndn 256, T 556
    queries) and one launch of the LAP kernel for the 7 levels' 112 cost
    matrices; the EMA validation's val loss launches it once more, the
    validation of ``best`` not at all. The LAP's share of a step is CUDA
    events around each of its calls. Then one training gradient card vs
    CPU (``rtdetr_step_card_vs_cpu``). Returns the run's launches, the step's
    ms, and the first step's cost matrices."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.data.build import collate
    from yolo_ad_refine_tpu_torch.data.dataset import YOLODataset, check_det_dataset
    from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
    from yolo_ad_refine_tpu_torch.models.model import build_detection_model
    from yolo_ad_refine_tpu_torch.train import rtdetr as R

    counters = kernel_counters()

    def counts():
        return {k: f.launches for k, f in counters.items()}

    lap = R.linear_sum_assignment
    lap_events, captured, in_step = [], {}, [False]

    def timed_lap(cost, mask=None, **kw):
        if not in_step[0]:
            return lap(cost, mask, **kw)
        captured.setdefault("cost", cost.detach().float().clone())
        captured.setdefault("mask", mask.detach().clone())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = lap(cost, mask, **kw)
        end.record()
        lap_events.append((start, end))
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_rtdetr_train_") as tmp:
        data = make_shapes_dataset(Path(tmp) / "ds", n_train=64, n_val=16, imgsz=RTDETR_IMGSZ,
                                   seed=5)
        model = YOLO(RTDETR_CFG, device=dev, imgsz=RTDETR_IMGSZ, seed=0)
        steps, mark = [], {}

        def on_batch_start(tr):
            torch.cuda.synchronize()
            in_step[0] = True
            mark.update(counts=counts(), t=time.perf_counter(), lap=len(lap_events))

        def on_batch_end(tr):
            torch.cuda.synchronize()
            in_step[0] = False
            now = counts()
            lap_ms = sum(s.elapsed_time(e) for s, e in lap_events[mark["lap"]:])
            steps.append({"ms": (time.perf_counter() - mark["t"]) * 1e3, "lap_ms": lap_ms,
                          **{k: now[k] - mark["counts"][k] for k in now}})
            mark["after_steps"] = now

        model.add_callback("on_train_batch_start", on_batch_start)
        model.add_callback("on_train_batch_end", on_batch_end)
        for f in counters.values():
            f.launches = 0
        R.linear_sum_assignment = timed_lap
        try:
            t0 = time.perf_counter()
            results = model.train(data=data, epochs=1, batch=16, imgsz=RTDETR_IMGSZ, amp=True,
                                  plots=False, project=str(Path(tmp) / "runs"), workers=8)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            R.linear_sum_assignment = lap
        run = counts()
        trainer = model.trainer
        val = {k: run[k] - mark["after_steps"][k] for k in run}
        ms = statistics.median(st["ms"] for st in steps[1:])
        lap_ms = statistics.median(st["lap_ms"] for st in steps[1:])
        t_queries = trainer.loss_fn.dn_cfg.ndn + trainer.loss_fn.nq
        log(f"rtdetr training: {len(steps)} steps + validations in {wall:.1f} s; bf16 autocast "
            f"{trainer.amp_dtype is not None}; {t_queries} queries a step (ndn "
            f"{trainer.loss_fn.dn_cfg.ndn}); steps " + ", ".join(f"{st['ms']:.1f}" for st in steps)
            + f" ms; {ms:.1f} ms a step (median of steps 2-4, host clock with a synchronise), "
            f"{16 / ms * 1e3:.1f} images/s at batch 16, imgsz {RTDETR_IMGSZ}; the LAP kernel "
            f"{lap_ms:.3f} ms a step (CUDA events, median of steps 2-4; "
            + ", ".join(f"{st['lap_ms']:.3f}" for st in steps) + f" ms), {lap_ms / ms * 100:.2f} % "
            f"of the step; launches in the run {run}, in the validations after the steps {val}")
        if len(steps) != 4 or trainer.amp_dtype is None or t_queries != 556:
            raise AssertionError(f"expected 4 bf16 RT-DETR steps of 556 queries, got "
                                 f"{len(steps)}, {t_queries}")
        if any(st[k] != (k == "linear_sum_assignment") for st in steps for k in run) or \
                any(val[k] != (k == "linear_sum_assignment") for k in run):
            raise AssertionError(f"the RT-DETR run did not launch the LAP kernel once a step and "
                                 f"once in the EMA validation, and nothing else: steps {steps}, "
                                 f"validations {val}")
        csv = (Path(results["save_dir"]) / "results.csv").read_text().splitlines()
        row = dict(zip(csv[0].split(","), csv[1].split(",")))
        losses = [float(row[k]) for k in ("train/box_loss", "train/cls_loss", "train/dfl_loss",
                                          "val/box_loss", "val/cls_loss", "val/dfl_loss")]
        log(f"rtdetr training: results.csv train giou / cls / l1 {losses[:3]}, val {losses[3:]}; "
            f"mAP50(B) {results.get('metrics/mAP50(B)', 0.0):.4f}")
        if not all(math.isfinite(v) and v > 0 for v in losses):
            raise AssertionError(f"rtdetr losses not finite: {losses}")
        reloaded = YOLO(str(Path(results["save_dir"]) / "weights" / "best"), device=dev)
        if reloaded.model.head_kind != "rtdetr":
            raise AssertionError("rtdetr best did not reload as an RT-DETR model")
        info = check_det_dataset(data)
        ds = YOLODataset(info["val"], imgsz=256, augment=False, nc=3, max_boxes=16)
        batch = collate([ds.get_sample(i) for i in range(2)], 16)
    batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    base = tie_encoder_scores(build_detection_model(RTDETR_CFG, nc=3, device="cpu", seed=3,
                                                    imgsz=256))
    cfg = R.make_dn_config(16)
    dn = R.make_cdn_group(*(torch.from_numpy(batch[k]) for k in ("cls", "bboxes", "mask")),
                          torch.Generator().manual_seed(4), nc=3, imgsz=256.0, cfg=cfg,
                          attn_blocked=torch.from_numpy(R.build_dn_attn_blocked(cfg, 300)))
    step = rtdetr_step_card_vs_cpu(dev, base, batch, dn)
    return {"run": run, "ms_per_step": ms, "lap_ms_per_step": lap_ms, "cost": captured["cost"],
            "mask": captured["mask"], "step": step}


def rtdetr_step_card_vs_cpu(dev, base, batch: dict, dn: dict) -> dict:
    """The gradient of one RT-DETR training forward and loss: ``base``
    (rtdetr-l at 256, its selection fixed by ``tie_encoder_scores``) on
    ``batch`` (2 images, converted to [0, 1] once on the CPU: the card's
    ``x / 255`` multiplies by the reciprocal, an ulp off the CPU's division)
    with the denoising group ``dn`` injected, on the card and on the CPU
    from the same weights, in fp64 and in fp32 (TF32 off, deterministic
    algorithms), the card's with the CPU's matches (how many GT slots its
    own LAP would have matched otherwise is printed). Held in both: the
    loss within 1e-4 relative. In fp64: each leaf within LEAF_TOL relative
    norm (a leaf's norm floored at 1e-6 of the largest leaf's: leaves whose
    gradient cancels to ~0, a bias before a norm). In fp32:
    ``phase_step_card_vs_cpu``'s rule (a leaf whose CPU fp32 gradient lies
    more than LEAF_TOL / 4 from fp64 is held against fp64, the card within
    4 times the CPU's distance; every other leaf within LEAF_TOL of the
    CPU's). The seeded decoder's ReLUs (FFN, box and position MLPs) take
    pre-activations within fp32 rounding of 0 to either side, and a box
    head's gradient comes from a few matched queries, so one flipped unit
    moves a whole leaf. A leaf that misses the rule therefore passes only
    if it is the weight or bias of a layer feeding a decoder ReLU whose
    inputs the card's fp32 forward puts on the other side of 0 than the
    CPU's, and the card's fp32 forward puts at most 4 times as many of the
    decoder's ReLU inputs on the other side of 0 than the fp64 forward as
    the CPU's fp32 forward does (the rule's factor for a cancelling leaf);
    the ReLU inputs are compared only when a leaf misses."""
    import torch

    from yolo_ad_refine_tpu_torch.nn.transformer import MLP, DeformableDecoderLayer
    from yolo_ad_refine_tpu_torch.train import rtdetr as R
    from yolo_ad_refine_tpu_torch.train.step import images_to_tensor

    img = images_to_tensor(batch["img"], "cpu")
    targets = [torch.from_numpy(batch[k]) for k in ("cls", "bboxes", "mask")]

    def forward(model):
        d = next(model.parameters())
        return model.train()(img.to(d.device, d.dtype),
                             dn={k: v.to(d.device) for k, v in dn.items()})

    def grads_of(model):
        d = next(model.parameters()).device
        out = R.RTDETRLoss(nc=base.nc, nq=300, imgsz=256, max_boxes=16)(
            forward(model), *(t.to(d) for t in targets))
        out.total.backward()
        return out.total.item(), {n: p.grad.detach().double().cpu()
                                  for n, p in model.named_parameters() if p.grad is not None}

    def relu_inputs(model) -> dict:
        """{layer name: its outputs} of every layer that feeds a ReLU of
        the decoder (FFN, box and position MLPs; the position MLP runs once
        a decoder layer), one forward."""
        outs = {}
        for name, m in model.named_modules():
            layers = ([(f"{name}.layers.{i}", lay) for i, lay in enumerate(m.layers[:-1])]
                      if isinstance(m, MLP) else [(f"{name}.linear1", m.linear1)]
                      if isinstance(m, DeformableDecoderLayer) else [])
            for n, layer in layers:
                layer.register_forward_hook(
                    lambda mod, i, o, n=n: outs.setdefault(n, []).append(o.detach().cpu()))
        with torch.no_grad():
            forward(model)
        return outs

    def flips(a: dict, b: dict) -> dict:
        """{layer: how many of its ReLU inputs lie on the other side of 0
        in ``b`` than in ``a``}."""
        return {n: sum(int(((x > 0) != (y > 0)).sum()) for x, y in zip(a[n], b[n])) for n in a}

    # the CPU's matches, replayed in the card's: a match is a discontinuity
    # of the loss, and with the selection fixed many queries have tied
    # costs, whose assignment the last bit of an fp32 cost decides
    lap, state = R.linear_sum_assignment, {}

    def cpu_matches(cost, mask=None, **kw):
        got = lap(cost, mask, **kw)
        if cost.device.type == "cpu":
            state["cpu"] = got
            return got
        state["differ"] = int((got.cpu() != state["cpu"]).sum())
        return state["cpu"].to(got.device)

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    R.linear_sum_assignment = cpu_matches
    out, cpu_grads = {}, {}
    try:
        for dtype in (torch.float64, torch.float32):
            tag = "fp64" if dtype == torch.float64 else "fp32"
            loss_cpu, g_cpu = grads_of(copy.deepcopy(base).to(dtype))
            cpu_grads[tag] = g_cpu
            state["differ"] = 0
            loss, g = grads_of(copy.deepcopy(base).to(dev, dtype))
            rel = abs(loss - loss_cpu) / abs(loss_cpu)
            head = (f"rtdetr card vs CPU gradient, {tag}: the card's own LAP would have matched "
                    f"{state['differ']} of {state['cpu'].numel()} GT slots otherwise (the CPU's "
                    f"replayed); loss {loss:.9f} vs CPU {loss_cpu:.9f} (rel {rel:.2e}, tol 1e-4); ")
            if tag == "fp64":
                top = max(v.norm().item() for v in g_cpu.values())
                errs = sorted((((g[n] - w).norm() / max(w.norm().item(), 1e-6 * top)).item(), n)
                              for n, w in g_cpu.items())
                over = [f"{n}: {e:.2e}" for e, n in errs if e > LEAF_TOL]
                out[tag] = {"loss_rel": rel, "worst_leaf": errs[-1][0], "over": len(over)}
                log(head + f"{len(errs)} leaves, {len(over)} over {LEAF_TOL} relative norm, "
                    "worst " + ", ".join(f"{n} {e:.2e}" for e, n in errs[:-4:-1]))
                if rel > 1e-4 or over:
                    raise AssertionError(f"rtdetr card vs CPU gradient (fp64) disagrees: loss "
                                         f"rel {rel:.2e}, leaves {over[:8]}")
                continue
            g64 = cpu_grads["fp64"]
            off = {n: (w - g64[n]).norm().item() for n, w in g_cpu.items()}
            cancels = {n for n in g_cpu if off[n] > LEAF_TOL / 4 * g64[n].norm().item()}
            held = [(((g[n] - w).norm() / w.norm().clamp(min=1e-30)).item(), n)
                    for n, w in g_cpu.items() if n not in cancels]
            ratio = [((g[n] - g64[n]).norm().item() / max(off[n], 1e-30), n) for n in cancels]
            missed = sorted([(e, n) for e, n in held if e > LEAF_TOL]
                            + [(r, n) for r, n in ratio if r > 4], reverse=True)
            flipped, n_flips, vs_fp64, n_inputs = {}, 0, {"card": 0, "cpu": 0}, 0
            if missed:
                card_in, cpu_in, fp64_in = (relu_inputs(copy.deepcopy(base).to(*to)) for to in
                                            ((dev,), ("cpu",), ("cpu", torch.float64)))
                flipped = flips(card_in, cpu_in)
                n_flips = sum(flipped.values())
                vs_fp64 = {"card": sum(flips(card_in, fp64_in).values()),
                           "cpu": sum(flips(cpu_in, fp64_in).values())}
                n_inputs = sum(x.numel() for v in card_in.values() for x in v)
            unexplained = [n for _, n in missed if not flipped.get(n.rsplit(".", 1)[0])]
            out[tag] = {"loss_rel": rel, "missed": [n for _, n in missed],
                        "relu_flips": n_flips, "relu_flips_vs_fp64": vs_fp64,
                        "relu_inputs": n_inputs,
                        "relu_flips_by_layer": {n.rsplit(".", 1)[0]: flipped.get(
                            n.rsplit(".", 1)[0], 0) for _, n in missed}}
            log(head + f"{len(held)} leaves held at {LEAF_TOL}, worst {max(held, default=(0.0,))[0]:.2e}; "
                f"{len(cancels)} cancelling leaves, worst card / CPU distance from fp64 "
                f"{max(ratio, default=(0.0,))[0]:.2f} (tol 4); missed on {len(missed)}: "
                + ", ".join(f"{n} {v:.3g}" for v, n in missed[:6])
                + "; their layers' ReLU inputs on the other side of 0 than the CPU's fp32: "
                + ", ".join(f"{n} {k}" for n, k in out[tag]["relu_flips_by_layer"].items())
                + f"; the decoder's {n_flips} of {n_inputs:,}; against the fp64 forward the "
                f"card's fp32 flips {vs_fp64['card']}, the CPU's {vs_fp64['cpu']} (tol 4 times "
                "the CPU's)")
            if rel > 1e-4 or unexplained or vs_fp64["card"] > 4 * vs_fp64["cpu"]:
                raise AssertionError(f"rtdetr card vs CPU gradient (fp32) disagrees: loss rel "
                                     f"{rel:.2e}, leaves missed with no flipped ReLU input "
                                     f"{unexplained[:8]}, ReLU inputs flipped against fp64 "
                                     f"{vs_fp64}")
    finally:
        R.linear_sum_assignment = lap
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    return out


def lap_bound(cost, mask, scans) -> dict:
    """The LAP's bound: the valid rows' costs (the only ones it solves) and
    the uint8 row masks read once, col4row and the scan counts written
    once, over the HBM rate, against
    its reduced-cost passes this run's data needed (each Dijkstra scan
    reads N costs and does 4 fp32 operations a column: two subtractions, an
    addition, a comparison) over the fp32 rate; the larger, and what it
    is."""
    b, m, n = cost.shape
    valid = int((mask > 0).sum())
    nbytes = valid * n * 4 + mask.numel() + b * m * 4 + b * 4
    ops = float(scans.sum()) * n * 4
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "scans": int(scans.sum())}


def phase_lap(training: dict, dev) -> dict:
    """The LAP kernel against its plain version on the training step's own
    112 cost matrices (16 images x 7 levels, 128 GT slots x 300 queries)
    and on synthetic ones of the same shape, every matrix with 1 to 128
    valid rows: equal assignments and scan counts (the two run the same
    fp32 operations in the same order), each matrix's optimal cost equal,
    the columns distinct. Timed: the kernel (CUDA events) and the plain
    version (host clock, the copy to the host included). Returns the
    kernels line's measurements of the step's matrices, the synthetic ones
    under ``synthetic``."""
    import torch

    from yolo_ad_refine_tpu_torch.ops.lap import linear_sum_assignment, linear_sum_assignment_plain

    g = torch.Generator().manual_seed(7)
    b, m, n = training["cost"].shape
    syn_cost = (torch.randn(b, m, n, generator=g) * 3.0).to(dev)
    rows = torch.randint(1, m + 1, (b, 1), generator=g)
    syn_mask = (torch.arange(m)[None] < rows).float()
    syn_mask = syn_mask[:, torch.randperm(m, generator=g)].to(dev)  # valid rows anywhere
    out = {}
    for label, cost, mask in (("step", training["cost"], training["mask"]),
                              ("synthetic", syn_cost, syn_mask)):
        got, scans = linear_sum_assignment(cost, mask, return_scans=True)
        t0 = time.perf_counter()
        want, want_scans = linear_sum_assignment_plain(cost, mask, return_scans=True)
        plain_ms = (time.perf_counter() - t0) * 1e3
        valid = (mask > 0).cpu()
        c = cost.float().cpu()
        picked = torch.gather(c, 2, got.long().cpu()[..., None])[..., 0] * valid
        best = torch.gather(c, 2, want.long().cpu()[..., None])[..., 0] * valid
        cost_err = (picked.sum(1) - best.sum(1)).abs().max().item()
        distinct = all(len(set(r.tolist())) == m for r in got.cpu())
        if not (torch.equal(got.cpu(), want.cpu()) and torch.equal(scans.cpu(), want_scans)) \
                or cost_err > LAP_TOL or not distinct:
            raise AssertionError(f"LAP kernel disagrees with its plain version on the {label} "
                                 f"matrices: {int((got.cpu() != want.cpu()).sum())} rows, cost "
                                 f"{cost_err:.2e}, distinct {distinct}")
        with quiet_card():
            ms = cuda_time(lambda: linear_sum_assignment(cost, mask), iters=20)
        bound = lap_bound(cost, mask, want_scans)
        out[label] = {"B": b, "M": m, "N": n, "valid_rows": int(valid.sum()),
                      "max_abs_err": cost_err, "ms": ms, "plain_ms": plain_ms, **bound,
                      "library_ms": None}
        log(f"LAP on the {label} matrices ({b} of {m} x {n}, {int(valid.sum())} valid rows, "
            f"{bound['scans']} Dijkstra scans): assignments and scans equal to plain, optimal "
            f"cost |diff| {cost_err:.2e}; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms (host), "
            f"bound {bound['bound_ms']:.5f} ms ({bound['bound_by']})")
    return {**out["step"], "synthetic": out["synthetic"]}


def atss_card_vs_cpu(dev) -> dict:
    """``DetectionLoss(assigner="atss")`` on one flagship train-mode forward's
    maps (scale n, 256, batch 2, 3 classes): the card against the CPU on
    the same maps, the total and components within 1e-4 relative and the
    gradient on the maps within 1e-3 relative norm."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch.models.model import build_detection_model
    from yolo_ad_refine_tpu_torch.train.loss import DetectionLoss
    from yolo_ad_refine_tpu_torch.train.step import images_to_tensor

    r = np.random.default_rng(3)
    xy = r.uniform(0, 180, (2, 8, 2))
    boxes = np.concatenate([xy, xy + r.uniform(16, 70, (2, 8, 2))], -1).astype(np.float32)
    mask = (np.arange(8)[None, :, None] < np.array([[[6]], [[4]]])).astype(np.float32)
    t = [torch.from_numpy(a) for a in (r.integers(0, 3, (2, 8, 1)).astype(np.float32),
                                       boxes * mask, mask)]
    model = build_detection_model(FLAGSHIP, nc=3, device=dev, seed=3, imgsz=256).train()
    img = images_to_tensor(r.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8), dev)
    with torch.no_grad():
        maps = [f.float() for f in model(img)]
    out = {}
    for where in (dev, "cpu"):
        leaves = [f.detach().to(where).requires_grad_() for f in maps]
        loss = DetectionLoss(nc=3, strides=(8, 16, 32), assigner="atss")(
            leaves, *(a.to(where) for a in t))
        loss.total.backward()
        out[where] = (loss.total.item(), loss.components.cpu(), [f.grad.cpu() for f in leaves])
    (lc, cc, gc), (lp, cp, gp) = out[dev], out["cpu"]
    rel = abs(lc - lp) / abs(lp)
    comp = ((cc - cp).abs() / cp.abs().clamp(min=1e-12)).max().item()
    grad = max(((a - b).norm() / b.norm().clamp(min=1e-30)).item() for a, b in zip(gc, gp))
    log(f"ATSS loss card vs CPU on a flagship step's maps: total {lc:.6f} vs {lp:.6f} (rel "
        f"{rel:.2e}), components rel {comp:.2e} (tol 1e-4), map gradients rel norm {grad:.2e} "
        f"(tol 1e-3)")
    if rel > 1e-4 or comp > 1e-4 or grad > 1e-3 or not math.isfinite(lc):
        raise AssertionError("the ATSS loss on the card disagrees with the CPU's")
    return {"total_rel": rel, "grad_rel": grad}


def repairs_on_card(dev) -> dict:
    """The repaired export path on the card: yolov10n (``task_model``'s
    seeded priors) exported as TorchScript at batch 8 in fp32, its sidecar's
    head kind "v10", and ``DetectionValidator(backend=)`` over 16 images
    labelled with the model's own rows against the same validation through
    the model (1e-3); and whether the tensorboard package imports here and
    the trainer's TensorBoard integration writes its event file."""
    import importlib.util

    import torch

    from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
    from yolo_ad_refine_tpu_torch.engine.exporter import AutoBackend
    from yolo_ad_refine_tpu_torch.engine.validator import DetectionValidator

    model = task_model("v10", dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_repairs_") as tmp:
        root = Path(tmp) / "ds"
        data = make_shapes_dataset(root, n_train=1, n_val=16, imgsz=TASK_IMGSZ, seed=2)
        label_with_own_rows(model, root)
        path = model.export(format="torchscript", imgsz=TASK_IMGSZ, batch=8, half=False,
                            path=str(Path(tmp) / "v10"))
        backend = AutoBackend(path, device=dev)
        args = {"imgsz": TASK_IMGSZ, "batch": 8, "conf": 0.001, "data": data}
        want = DetectionValidator(dict(args))(model=model.model)
        got = DetectionValidator(dict(args))(backend=backend)
        keys = ("metrics/mAP50(B)", "metrics/mAP50-95(B)", "metrics/precision(B)",
                "metrics/recall(B)", "fitness")
        log(f"v10 backend validation (TorchScript, sidecar head {backend.head!r}, "
            f"{backend.n_scores} scores): " + ", ".join(f"{k} {got[k]:.6f} vs model {want[k]:.6f}"
                                                        for k in keys) + " (tol 1e-3)")
        if backend.head != "v10" or want["metrics/mAP50(B)"] <= 0.05 or any(
                abs(got[k] - want[k]) > 1e-3 for k in keys):
            raise AssertionError("v10 backend validation is vacuous or disagrees with the model's")
        tb = importlib.util.find_spec("tensorboard") is not None
        events = 0
        if tb:  # the trainer's TensorBoard integration, fed one epoch
            from types import SimpleNamespace

            from yolo_ad_refine_tpu_torch.utils.callbacks import tensorboard_callbacks

            hooks = tensorboard_callbacks(tmp)
            trainer = SimpleNamespace(current_epoch=0, last_epoch_scalars={"train/box_loss": 1.0})
            hooks["on_fit_epoch_end"](trainer)
            hooks["on_train_end"](trainer)
            events = len(list(Path(tmp).glob("events.out.tfevents.*")))
        log(f"tensorboard: {'imports' if tb else 'absent'} on this machine; the trainer's "
            f"integration wrote {events} event file(s)")
        torch.cuda.synchronize()
    return {"tensorboard": tb}


def phase_rtdetr(dev) -> dict:
    """rtdetr-l at 640 on the card (``rtdetr_model``): served
    (``rtdetr_serving``), validated (``rtdetr_val``) and trained
    (``rtdetr_training``), the LAP kernel held against its plain version
    (``phase_lap``), the ATSS loss card vs CPU (``atss_card_vs_cpu``) and
    the repaired export path (``repairs_on_card``). Returns {"paths":
    {path: launches}, "lap": the LAP's measurements, ...}."""
    model = rtdetr_model(dev)
    serving = rtdetr_serving(model, dev)
    val = rtdetr_val(model, dev)
    del model
    training = rtdetr_training(dev)
    lap = phase_lap(training, dev)
    atss = atss_card_vs_cpu(dev)
    repairs = repairs_on_card(dev)
    return {"paths": {"rtdetr_serving_run": serving["run"], "rtdetr_val_run": val["run"],
                      "rtdetr_training_run": training["run"]},
            "serving": serving, "val_ms_per_image": val["ms_per_image"],
            "ms_per_step": training["ms_per_step"], "lap_ms_per_step": training["lap_ms_per_step"],
            "lap": lap, "atss": atss, "repairs": repairs}


CLS_CFG, CLS_IMGSZ = "yolo11n-cls.yaml", 224  # nc 1000 for the forward


ZOO_SERVING = ("yolov8n", "yolov5n", "yolov3", "yolov9c", "yolov8n-seg", "yolov8n-pose")
ZOO_OBB = "yolov8n-obb"
# the JAX models' parameter counts at each yaml's nc, which tests/test_torch_zoo.py holds the
# port's against (jax.eval_shape of the JAX package's DetectionModel)
ZOO_PARAMS = {"yolov8n": 2_724_432, "yolov5n": 2_222_048, "yolov3": 98_539_408,
              "yolov9c": 21_419_120, "yolov8n-seg": 2_977_200, "yolov8n-pose": 2_974_814,
              "yolov8n-obb": 2_796_099}


def phase_zoo(dev) -> dict:
    """The stock model zoo on the card, seeded weights at each yaml's
    published scale (yolov3 and yolov9c have none), each parameter count
    held to the JAX model's (``ZOO_PARAMS``): yolov8n, yolov5n, yolov3,
    yolov9c, yolov8n-seg and yolov8n-pose served (``task_serving``: 64
    images at batch 32, 640, fp32, conf 0.25, class 0 at P5 at the prior
    0.3, K4 once a batch, card vs CPU on 2 images); yolov8n-obb served as
    the OBB phase serves (``phase_obb_serving``: 32 images at batch 16,
    1024, K5 once a batch); yolov9c validated (``task_val``: 16
    self-labelled images, card vs CPU at 1e-3); yolov9c and yolov3 trained
    1 epoch (4 bf16 steps at batch 16, 640, ``task_training``), with one
    fp32 yolov9c step held against the CPU at 256."""
    import torch

    paths, serving = {}, {}
    for key in ZOO_SERVING:
        model = task_model(key, dev)
        if model.model.num_params() != ZOO_PARAMS[key]:
            raise AssertionError(f"{key}: {model.model.num_params():,} parameters, the JAX model "
                                 f"has {ZOO_PARAMS[key]:,}")
        serving[key] = task_serving(key, model, dev)
        paths[f"zoo_{key}_serving_run"] = serving[key]["run"]
        if key == "yolov9c":
            paths["zoo_yolov9c_val_run"] = task_val(key, model, dev)["run"]
        del model
        torch.cuda.empty_cache()
    obb = obb_model(dev, f"{ZOO_OBB}.yaml")
    if obb.model.num_params() != ZOO_PARAMS[ZOO_OBB]:
        raise AssertionError(f"{ZOO_OBB}: {obb.model.num_params():,} parameters, the JAX model "
                             f"has {ZOO_PARAMS[ZOO_OBB]:,}")
    paths[f"zoo_{ZOO_OBB}_serving_run"] = phase_obb_serving(obb, dev, ZOO_OBB)
    del obb
    training = {}
    for key in ("yolov9c", "yolov3"):
        training[key] = task_training(key, dev, hold_step=key == "yolov9c")
        paths[f"zoo_{key}_training_run"] = training[key]["run"]
    log("zoo: " + "; ".join(f"{k} {ZOO_PARAMS[k]:,} parameters, {v['images_per_s']:.1f} images/s"
                            for k, v in serving.items())
        + "; steps " + ", ".join(f"{k} {v['ms_per_step']:.1f} ms" for k, v in training.items()))
    return {"paths": paths, "serving": serving, "training": training}


# the module library (phase_module_library): the flagship yaml with layer 10
# swapped (the reference's ablation rows), or with its fusion_mode set; each
# parameter count is the JAX model's at scale n (tests/test_torch_tssa_ablations.py,
# tests/test_torch_fusion_modes.py)
LIBRARY_ABLATIONS = {"C2TSSA_DYT_Mona_EDFFN": 3_667_813, "C2SFA": 3_576_547,
                     "C2PSA_EDFFN": 3_632_225, "C2AdaptiveTSSA_Enhanced": 4_159_519,
                     "C2ProgressiveTSSA_Fusion1": 4_192_373}
LIBRARY_FUSIONS = {"weight": 4_164_733, "adaptive": 4_165_765, "concat": 4_130_941,
                   "SDI": 4_138_365}
MODEL_697 = "C2TSSA_DYT_Mona_EDFFN"
# the attention rows, each alone and as a yaml row after layer 10
LIBRARY_ROWS = ("EMA", "SimAM", "TripletAttention", "LSKBlock", "SEAttention",
                "EfficientChannelAttention", "SpatialGroupEnhance", "EffectiveSEModule", "ELA",
                "CAA", "MPCA", "AFGCAttention", "BAMBlock", "LSKBlockSA", "LSKA",
                "SegNext_Attention", "CPCA", "deformable_LKA", "DAttention",
                "FocusedLinearAttention", "CascadedGroupAttention", "LocalWindowAttention",
                "DualDomainSelectionMechanism", "EfficientAttention", "BiLevelRoutingAttention",
                "BiLevelRoutingAttention_nchw", "DSAN", "DSA")
ROW_SHAPE = (8, 64, 80, 80)  # scale n's P3 at 640
ROW_TOL = 1e-4  # of max |CPU|, each row alone card vs CPU in fp32
# class 0's priors in AYHead's shared cv3, tried in turn until 2 served images
# keep rows at conf 0.25 (phase_track's TRACK_PRIOR first)
LIBRARY_PRIORS = (0.15, 0.2, 0.3, 0.5, 0.7)


def library_cfg(layer10: str | None = None, fusion: str | None = None,
                row: str | None = None) -> dict:
    """The flagship yaml's dict with ``layer10`` at row 10, its
    ``fusion_mode`` set to ``fusion``, or the module ``row`` inserted after
    row 10 (the rows after it read the new row where they read row 10, and
    every later index moves up by one)."""
    from yolo_ad_refine_tpu_torch.models.parser import load_model_cfg

    d = copy.deepcopy(load_model_cfg(FLAGSHIP))
    if layer10:
        d["backbone"][10] = [-1, 2, layer10, [1024]]
    if fusion:
        d["fusion_mode"] = fusion
    if row:
        def shift(f):
            return f + 1 if f >= 10 else f

        for r in d["head"]:
            r[0] = [shift(f) for f in r[0]] if isinstance(r[0], list) else shift(r[0])
        d["head"].insert(0, [-1, 1, row, []])
    return d


def library_label(layer10: str | None = None, fusion: str | None = None) -> str:
    return f"layer 10 {layer10}" if layer10 else f"fusion_mode {fusion}"


def library_model(dev, cfg: dict, label: str, params: int | None):
    """YOLO(cfg) at 640 on ``dev`` with seeded weights, its parameter count
    held to the JAX model's, and class 0's bias in AYHead's shared cv3 at
    the first of LIBRARY_PRIORS under which 2 served images keep rows at
    conf 0.25 (a layer 10 or a fusion mode of its own moves the head's
    scores)."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import YOLO

    model = YOLO(cfg, device=dev, imgsz=640, seed=0)
    n = model.model.num_params()
    if params is not None and n != params:
        raise AssertionError(f"{label}: {n:,} parameters, the JAX model has {params:,}")
    rng = np.random.default_rng(0)
    probe = [rng.integers(0, 256, (*SERVING_SHAPES[i], 3), dtype=np.uint8) for i in range(2)]
    for prior in LIBRARY_PRIORS:
        with torch.no_grad():
            model.model.model[model.model.head_idx].cv3.bias[0] = logit(prior)
        if sum(len(r) for r in model.predict(probe, conf=0.25, batch=2)) > 0:
            break
    model.prior = prior
    return model


def library_serving(model, dev, label: str, n: int = 32, runs: int = 1,
                    hold: bool = True, warm: bool = True) -> dict:
    """``n`` images of the serving shapes at batch 32, 640, fp32, conf 0.25
    (with ``warm`` a warm-up batch first, then ``runs`` timed runs with the
    counts set to 0; without it the one run includes the first call's
    cuDNN plans):
    K1 fwd once a level and K4 once a batch, no other kernel; finite rows
    inside their images; with ``hold``, 2 images card vs CPU at the serving
    limits (boxes 5e-2 px, scores 1e-3)."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch.engine.predictor import preprocess

    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (*SERVING_SHAPES[i % len(SERVING_SHAPES)], 3), dtype=np.uint8)
            for i in range(n)]
    if warm:
        model.predict(imgs[:32], conf=0.25, batch=32)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    counters = kernel_counters()
    seconds = []
    batches = -(-n // 32)
    for _ in range(runs):
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        results = model.predict(imgs, conf=0.25, batch=32)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = {k: f.launches for k, f in counters.items()}
        want = {k: 0 for k in launches}
        want.update(dcn_forward=3 * batches, nms_suppress=batches)
        if launches != want:
            raise AssertionError(f"{label} serving: launches {launches}, expected K1 fwd once a "
                                 "level and K4 once a batch, and nothing else")
    dt = sorted(seconds)[len(seconds) // 2]
    kept = [len(r) for r in results]
    for im, r in zip(imgs, results):
        d = r.boxes.data
        h, w = im.shape[:2]
        if not (len(d) <= 300 and np.isfinite(d).all()) or (d[:, [0, 2]] < 0).any() or \
                (d[:, [0, 2]] > w).any() or (d[:, [1, 3]] < 0).any() or (d[:, [1, 3]] > h).any():
            raise AssertionError(f"{label} serving: bad detections for an image of {im.shape}")
    if sum(kept) == 0:
        raise AssertionError(f"{label} serving: no image kept a detection at conf 0.25")
    out = {"run": launches, "images_per_s": n / dt, "ms_per_batch": dt / batches * 1e3,
           "kept_mean": float(np.mean(kept))}
    msg = (f"{label} serving (class 0 at the prior {model.prior}): {n} images, batch 32, "
           f"imgsz 640, fp32, conf 0.25: "
           f"{n / dt:.1f} images/s, {dt / batches * 1e3:.1f} ms/batch ("
           + ("median of " + ", ".join(f"{n / s:.1f}" for s in seconds) if runs > 1 else "one run")
           + f" images/s; host clock, preprocess + forward + NMS + results); kept "
           f"{np.mean(kept):.1f} an image; launches {launches}")
    if hold:
        x, _ = preprocess(imgs[:2], 640, 2, torch.device(dev), torch.float32)
        with torch.inference_mode():
            y_gpu = model.model(x)[0].float().cpu()
            y_cpu = copy.deepcopy(model.model).cpu()(x.cpu())[0]
        out["box_err"] = (y_gpu[..., :4] - y_cpu[..., :4]).abs().max().item()
        out["score_err"] = (y_gpu[..., 4:] - y_cpu[..., 4:]).abs().max().item()
        msg += (f"; card vs CPU on 2 images: max |box diff| {out['box_err']:.3e} px (tol 5e-2), "
                f"max |score diff| {out['score_err']:.3e} (tol 1e-3)")
        if not (y_gpu.shape == (2, 8400, 84) and torch.isfinite(y_gpu).all()) or \
                out["box_err"] > 5e-2 or out["score_err"] > 1e-3:
            raise AssertionError(f"{label}: card and CPU predictions disagree or are not finite")
    log(msg)
    return out


def seeded_module(name: str, c: int):
    """The registry's module ``name`` at ``c`` channels on the CPU in eval
    mode: conv and linear weights drawn as ``init_weights`` draws them, the
    norms' scales uniform in [0.5, 1.5] and their shifts in [-0.2, 0.2],
    and every other parameter of a module's own (gates, layer scales,
    position tables) uniform in [0.5, 1.5], so that none is its
    constructor's identity or zero."""
    import torch
    from torch import nn

    import yolo_ad_refine_tpu_torch.models.parser  # noqa: F401 (fills the registry)
    from yolo_ad_refine_tpu_torch.models.model import init_weights
    from yolo_ad_refine_tpu_torch.nn.registry import MODULE_REGISTRY

    m = MODULE_REGISTRY[name](c)
    gen = torch.Generator().manual_seed(0)
    init_weights(m, gen)
    norms = (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, norms):
                mod.weight.uniform_(0.5, 1.5, generator=gen)
                mod.bias.uniform_(-0.2, 0.2, generator=gen)
            elif not isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                for p in mod.parameters(recurse=False):
                    p.uniform_(0.5, 1.5, generator=gen)
    return m.eval()


def library_rows_alone(dev) -> dict:
    """Each attention row and DSAN / DSA alone at scale n's P3 shape (batch
    8, 64 x 80 x 80; CascadedGroupAttention, which attends a map of its
    ``resolution``, at 64 x 7 x 7, the JAX test's map), fp32: its ms on the
    card (CUDA events, mean of 5 calls after 2) and the first 2 images of
    its output card vs CPU within ROW_TOL of max |CPU| (eval: each image is
    its own)."""
    import torch

    out = {}
    for name in LIBRARY_ROWS:
        shape = (8, 64, 7, 7) if name == "CascadedGroupAttention" else ROW_SHAPE
        x = torch.randn(*shape, generator=torch.Generator().manual_seed(1))
        m = seeded_module(name, shape[1])
        card = copy.deepcopy(m).to(dev)
        xd = x.to(dev).contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            ms = cuda_time(lambda: card(xd), 5)
            got = card(xd)[:2].float().cpu()
            want = m(x[:2].contiguous(memory_format=torch.channels_last))
        if not want.abs().max() > 0:
            raise AssertionError(f"{name}: the CPU's output is all zero, a vacuous hold")
        err = (got - want).abs().max().item() / want.abs().max().item()
        out[name] = {"ms": ms, "rel_err": err, "shape": list(shape)}
        log(f"module library: {name} alone at {tuple(shape)}, fp32: {ms:.3f} ms on the card; "
            f"card vs CPU (2 images) max |diff| / max |CPU| {err:.2e} (tol {ROW_TOL})")
        if not (torch.isfinite(got).all() and got.shape == want.shape) or err > ROW_TOL:
            raise AssertionError(f"{name}: card and CPU disagree ({err:.2e})")
        del card
    return out


def library_step_card_vs_cpu(dev) -> None:
    """One fp32 step of the 697 model held against the CPU by
    ``phase_step_card_vs_cpu``'s rule, its Monas dropping the same seeded
    units on both sides (``tests/torch_dropout_masks.py``); the rate stays
    0.1."""
    from yolo_ad_refine_tpu_torch.models.model import build_detection_model
    from yolo_ad_refine_tpu_torch.train.loss import DetectionLoss
    from yolo_ad_refine_tpu_torch.train.step import images_to_tensor

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_dropout_masks import FixedDropout, dropout_input_shapes, seeded_masks, set_masks

    batch = step_batch()
    base = build_detection_model(library_cfg(MODEL_697), nc=3, device="cpu", seed=3, imgsz=256)
    shapes = dropout_input_shapes(base, images_to_tensor(batch["img"], "cpu"))
    set_masks(base, seeded_masks(shapes, 0.1, seed=4))
    fixed = [m for m in base.modules() if isinstance(m, FixedDropout)]
    if len(fixed) != 2 or any(m.p != 0.1 for m in fixed):
        raise AssertionError(f"the 697 step's dropouts: {[(m.p, m.keep.shape) for m in fixed]}")
    log(f"697 card vs CPU step: the 2 Monas' dropout (rate 0.1) on seeded masks "
        f"{[tuple(m.keep.shape) for m in fixed]}, kept "
        f"{[round(m.keep.float().mean().item(), 4) for m in fixed]}")
    hold_step_card_vs_cpu("697 card vs CPU step", dev, base, batch,
                          lambda: DetectionLoss(nc=3, strides=(8, 16, 32)))


def phase_module_library(dev) -> dict:
    """The rest of the module library on the card (scale n, 640, seeded
    weights, class 0 raised (``library_model``), conf 0.25): the 697 ablation model
    served (64 images at batch 32, three runs, card vs CPU on 2), validated
    on 16 self-labelled images (``task_val``), trained 1 epoch (4 bf16
    steps at batch 16, K1 fwd and bwd 3 a step, ``phase_training``) and one
    fp32 step held against the CPU with shared dropout masks; the other
    ablation models and the flagship under each other ``fusion_mode``
    served on 32 images and held against the CPU, the SDI one also trained
    4 bf16 steps; each attention row and DSAN / DSA alone, card vs CPU with
    its ms, and as a yaml row after row 10 served on 32 images in one cold
    run (CascadedGroupAttention, which attends only a map of its resolution
    7, not at P5's 20 x 20: LocalWindowAttention runs it in windows). Every
    parameter count is the JAX model's; the phase's seconds are logged."""
    import torch

    t_phase = time.perf_counter()
    paths, serving = {}, {}
    model = library_model(dev, library_cfg(MODEL_697), "697", LIBRARY_ABLATIONS[MODEL_697])
    log(f"697: {model.model.num_params():,} parameters (the JAX model's), strides "
        f"{model.model.strides}")
    serving["697"] = library_serving(model, dev, "697", n=64, runs=3)
    paths["library_697_serving_run"] = serving["697"]["run"]
    paths["library_697_val_run"] = task_val("697", model, dev)["run"]
    del model
    run, step, _, ms_697 = phase_training(dev, None, library_cfg(MODEL_697), "697")
    paths.update({"library_697_training_run": run, "library_697_training_step": step})
    library_step_card_vs_cpu(dev)
    for layer10, fusion in ([(k, None) for k in LIBRARY_ABLATIONS if k != MODEL_697]
                            + [(None, f) for f in LIBRARY_FUSIONS]):
        label = library_label(layer10, fusion)
        count = LIBRARY_ABLATIONS[layer10] if layer10 else LIBRARY_FUSIONS[fusion]
        model = library_model(dev, library_cfg(layer10, fusion), label, count)
        serving[label] = library_serving(model, dev, label)
        paths[f"library_{layer10 or 'fusion_' + fusion}_serving_run"] = serving[label]["run"]
        del model
        torch.cuda.empty_cache()
    run, step, _, ms_sdi = phase_training(dev, None, library_cfg(fusion="SDI"), "fusion_mode SDI")
    paths.update({"library_fusion_SDI_training_run": run,
                  "library_fusion_SDI_training_step": step})
    alone = library_rows_alone(dev)
    inserted = {}
    for name in LIBRARY_ROWS:
        if name == "CascadedGroupAttention":
            continue
        model = library_model(dev, library_cfg(row=name), f"row {name}", None)
        inserted[name] = library_serving(model, dev, f"row {name} after row 10", hold=False,
                                         warm=False)
        paths[f"library_row_{name}_serving_run"] = inserted[name]["run"]
        del model
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"module library: 697 {serving['697']['images_per_s']:.1f} images/s served, "
        f"{ms_697:.1f} ms a bf16 step at batch 16; SDI {ms_sdi:.1f} ms a step; "
        + "; ".join(f"{k} {v['images_per_s']:.1f} images/s" for k, v in serving.items()
                    if k != "697"))
    return {"paths": paths, "serving": serving, "alone": alone, "inserted": inserted,
            "ms_697": ms_697, "ms_sdi": ms_sdi, "seconds": seconds}


# the SAM family (phase_sam): JAX's parameter counts (jax.eval_shape of build_sam /
# build_sam2 at 1024; the PE gaussian, a torch buffer, counted as JAX counts it)
SAM_COUNTS = {"sam_b": 93_735_728, "sam_l": 312_343_088, "sam_h": 641_090_864,
              "mobile_sam": 10_130_348}
SAM2_COUNTS = {"sam2_t": 38_946_242, "sam2_s": 46_044_098, "sam2_b": 80_833_922,
               "sam2_l": 224_430_386}
SAM_IMGSZ = 1024
SAM_SHAPE = (720, 1280)       # the 1280 x 720 BGR images and video frames
SAM_EMB_TOL = 1e-3            # card vs CPU embeddings, mask logits, memories: of max |CPU|
SAM_IOU_TOL = 1e-3            # card vs CPU predicted IoU and object score logits
SAM_STABILITY_TOL = 1e-3      # card vs CPU stability score of generate's candidates
VIDEO_FRAMES, VIDEO_HELD = 16, 4  # the video's frames; frames 1..4 held against the CPU
FASTSAMS = {"FastSAM-s": "yolov8s-seg.yaml", "FastSAM-x": "yolov8x-seg.yaml"}
FASTSAM_BATCH, FASTSAM_CONF = 8, 0.4
FASTSAM_SPREAD = 1.0          # class 0's logits' spread over a level (fastsam_model)
FASTSAM_TOPS = (0.002, 0.005, 0.01, 0.02, 0.05)  # shares of a level's anchors set to pass conf
FASTSAM_MIN_ROWS = 20         # rows the probe image keeps once the share is high enough
NAS_SHAPE = (32, 8400, 80)    # a NAS raw output: (B, anchors at 640, classes)


def sam_scene(seed: int, shift: int = 0):
    """A seeded 1280 x 720 BGR image: blurred noise with a dark square, a
    bright disc and a grey bar (``shift`` px to the right, for a video)."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.integers(90, 200, (*SAM_SHAPE, 3), dtype=np.uint8), (0, 0), 3)
    cv2.rectangle(img, (420 + shift, 220), (760 + shift, 520), (20, 25, 30), -1)
    cv2.circle(img, (1000, 200), 110, (230, 240, 250), -1)
    cv2.rectangle(img, (100, 560), (600, 640), (128, 128, 128), -1)
    return img


def sam_generate_settings(low_res) -> dict:
    """``generate``'s settings: its defaults (pred_iou 0.6, stability 0.7
    over logits +/- 1: seeded weights may keep none), and every candidate
    scored, with the stability offset at the median |logit| of a point's
    low-res masks ``low_res`` (seeded logits may lie within +/- 1, where
    every stability score would be 0)."""
    import numpy as np

    offset = round(float(np.median(np.abs(low_res))), 4)
    return {"the defaults": {},
            f"every candidate scored, stability offset {offset}": dict(
                pred_iou_thresh=-10.0, stability_score_thresh=0.0, stability_offset=offset)}
SAM_BBOX_TOL = 2  # px: a pixel flipped at a mask's edge (2e-3 of a mask may flip) moves its box
OBJECT_LOGIT = 10.0  # SAM2's object-score head bias: the seeded model sees an object


def see_objects(net) -> None:
    """Seeded SAM2 weights give object-score logits of either sign, and a
    negative one blanks the masks (NO_OBJ_SCORE): raise the object-score
    head's bias, as the detector phases raise a class prior."""
    import torch

    with torch.no_grad():
        net.sam_mask_decoder.pred_obj_score_head.layers[-1].bias.fill_(OBJECT_LOGIT)


SAM_PROMPTS = {"one point": dict(points=[[590, 370]]),
               "two points, one background": dict(points=[[590, 370], [1000, 200]],
                                                   labels=[1, 0]),
               "box": dict(box=[400, 200, 780, 540], multimask_output=False)}


def sam_count(net) -> int:
    """Parameters plus the PE gaussian buffers (JAX counts them as params)."""
    return sum(p.numel() for p in net.parameters()) + sum(
        b.numel() for n, b in net.named_buffers() if n.endswith("gaussian_matrix"))


def timed_ms(fn, runs: int = 3) -> tuple[float, list]:
    """Median host-clock ms of ``fn()`` over ``runs`` calls, each ended by a
    synchronise, after one warm-up call."""
    import torch

    fn()
    ms = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return sorted(ms)[len(ms) // 2], ms


def hold_masks(label: str, got, want, got_iou, want_iou) -> dict:
    import numpy as np

    if got.shape != want.shape:
        raise AssertionError(f"{label}: masks {got.shape} on the card, {want.shape} on the CPU")
    out = {"iou_err": float(np.abs(got_iou - want_iou).max()),
           "flipped": float((got != want).mean())}
    if out["iou_err"] > SAM_IOU_TOL or out["flipped"] > MASK_FLIP_TOL:
        raise AssertionError(f"{label}: card and CPU disagree: {out} (tol IoU {SAM_IOU_TOL}, "
                             f"mask pixels flipped {MASK_FLIP_TOL})")
    return out


def hold_values(label: str, got, want) -> float:
    """max |card - CPU| over max |CPU| of two arrays or tensors (mask
    logits, memories, embeddings), at most ``SAM_EMB_TOL``."""
    import numpy as np

    got, want = (np.asarray(v.float().cpu() if hasattr(v, "float") else v, np.float64)
                 for v in (got, want))
    if got.shape != want.shape:
        raise AssertionError(f"{label}: {got.shape} on the card, {want.shape} on the CPU")
    err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    if not np.isfinite(got).all() or err > SAM_EMB_TOL:
        raise AssertionError(f"{label}: card and CPU differ by {err:.3e} of max |CPU| (tol "
                             f"{SAM_EMB_TOL})")
    return err


def generate_candidates(sam, img, **kw) -> tuple[list, list]:
    """``sam.generate(img, points_per_side=8, **kw)``: (its candidates as
    they reach the NMS, in the order they were made; the kept ones)."""
    seen, nms = [], sam._nms
    sam._nms = lambda cands, iou: (seen.extend(cands), nms(cands, iou))[1]
    try:
        kept = sam.generate(img, points_per_side=8, **kw)
    finally:
        del sam._nms
    return seen, kept


def hold_candidates(label: str, got: list, want: list) -> dict:
    """Card against CPU candidates of ``generate``, in order: the same
    count, boxes within ``SAM_BBOX_TOL`` px, predicted IoU within
    ``SAM_IOU_TOL``, stability within ``SAM_STABILITY_TOL`` and mask pixels
    flipped within ``MASK_FLIP_TOL``."""
    import numpy as np

    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} candidates on the card, {len(want)} on the CPU")
    out = {"n": len(got), "bbox": 0, "iou": 0.0, "stability": 0.0, "flipped": 0.0}
    for g, w in zip(got, want):
        out["bbox"] = max(out["bbox"], int(np.abs(np.subtract(g["bbox"], w["bbox"])).max()))
        out["iou"] = max(out["iou"], abs(g["predicted_iou"] - w["predicted_iou"]))
        out["stability"] = max(out["stability"], abs(g["stability_score"] - w["stability_score"]))
        out["flipped"] = max(out["flipped"],
                             float((g["segmentation"] != w["segmentation"]).mean()))
    if (out["bbox"] > SAM_BBOX_TOL or out["iou"] > SAM_IOU_TOL
            or out["stability"] > SAM_STABILITY_TOL or out["flipped"] > MASK_FLIP_TOL):
        raise AssertionError(f"{label}: card and CPU candidates disagree: {out}")
    if got:
        out["iou_range"] = [min(c["predicted_iou"] for c in want),
                            max(c["predicted_iou"] for c in want)]
        out["stability_range"] = [min(c["stability_score"] for c in want),
                                  max(c["stability_score"] for c in want)]
    return out


def sam_prompts(variant: str) -> dict:
    """The prompts of ``SAM_PROMPTS`` that ``variant`` answers: sam_b all
    three, mobile_sam one point and the box, the others one point."""
    keys = (tuple(SAM_PROMPTS) if variant == "sam_b" else
            ("one point", "box") if variant == "mobile_sam" else ("one point",))
    return {k: SAM_PROMPTS[k] for k in keys}


def sam_cpu_side(variant: str) -> dict:
    """The CPU side of ``sam_variant``'s hold: ``SAM(variant)`` at 1024 on
    the CPU, its embeddings of ``sam_scene(0)``, each prompt's (masks, IoU,
    low-res logits), ``generate``'s settings from its one-point low-res
    logits (the card runs the same settings) and, for sam_b, each
    setting's candidates (masks bit-packed) and kept boxes."""
    import numpy as np

    from yolo_ad_refine_tpu_torch.models.sam import SAM

    img = sam_scene(0)
    t0 = time.perf_counter()
    cpu = SAM(variant, SAM_IMGSZ, device="cpu")
    cpu.set_image(img)
    out = {"set_image_s": time.perf_counter() - t0, "embeddings": as_numpy(cpu._embeddings),
           "prompts": {}, "generate": {}}
    for k, kw in sam_prompts(variant).items():
        out["prompts"][k] = (*cpu.predict(**kw), as_numpy(cpu._last_lowres))
    out["settings"] = sam_generate_settings(out["prompts"]["one point"][2])
    if variant == "sam_b":
        for label, kw in out["settings"].items():
            cands, kept = generate_candidates(cpu, img, **kw)
            out["generate"][label] = (
                [{**c, "segmentation": np.packbits(c["segmentation"]),
                  "shape": c["segmentation"].shape} for c in cands],
                np.asarray([c["bbox"] for c in kept]).reshape(-1, 4))
    out["seconds"] = time.perf_counter() - t0
    return out


def unpack_candidates(cands: list) -> list:
    """``sam_cpu_side``'s candidates with their masks unpacked."""
    import numpy as np

    return [{**c, "segmentation": np.unpackbits(c["segmentation"], count=math.prod(
        c["shape"])).reshape(c["shape"]).astype(bool)} for c in cands]


def sam_variant(variant: str, dev, generate: bool = False) -> dict:
    """``SAM(variant)`` at 1024 on the card: its count held to JAX's,
    set_image's and a point decode's ms, the prompts of ``sam_prompts``
    and, with ``generate``, ``generate(points_per_side=8)``; held against
    ``sam_cpu_side``'s CPU run (from the CPU-reference worker): embeddings
    and each prompt's low-res logits within 1e-3 of max |CPU|, IoU 1e-3,
    mask pixels flipped 2e-3, generate's candidates before the NMS
    (``hold_candidates``) and its kept boxes."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch.models.sam import SAM

    img = sam_scene(0)
    t0 = time.perf_counter()
    card = SAM(variant, SAM_IMGSZ, device=dev)
    build_s = time.perf_counter() - t0
    if sam_count(card.model) != SAM_COUNTS[variant]:
        raise AssertionError(f"{variant}: {sam_count(card.model):,} parameters, JAX has "
                             f"{SAM_COUNTS[variant]:,}")
    torch.cuda.reset_peak_memory_stats()
    set_ms, set_runs = timed_ms(lambda: card.set_image(img))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emb = card._embeddings
    if not (emb.shape == (1, 256, SAM_IMGSZ // 16, SAM_IMGSZ // 16) and torch.isfinite(emb).all()):
        raise AssertionError(f"{variant}: embeddings {tuple(emb.shape)}, finite "
                             f"{bool(torch.isfinite(emb).all())}")
    decode_ms, _ = timed_ms(lambda: card._decode(**SAM_PROMPTS["one point"]), runs=5)
    prompts = sam_prompts(variant)
    got = {k: (*card.predict(**kw), card._last_lowres) for k, kw in prompts.items()}
    for k, (m, iou, _) in got.items():
        if not (m.shape[1:] == SAM_SHAPE and np.isfinite(iou).all() and (np.diff(iou) <= 0).all()):
            raise AssertionError(f"{variant} {k}: masks {m.shape}, iou {iou}")
    out = {"params": sam_count(card.model), "build_s": build_s, "set_image_ms": set_ms,
           "decode_ms": decode_ms, "peak_gb": peak_gb}
    out["mask_cover"] = {k: float(m.mean()) for k, (m, _, _) in got.items()}
    ref = cpu_reference(sam_cpu_side, variant)
    gen_card = {}
    if generate:
        for label, kw in ref["settings"].items():
            t0 = time.perf_counter()
            gen_card[label] = generate_candidates(card, img, **kw)
            out[f"generate_s ({label})"] = time.perf_counter() - t0
            out[f"generate_kept ({label})"] = len(gen_card[label][1])
    msg = (f"{variant} at {SAM_IMGSZ}: {out['params']:,} parameters (JAX's), built in "
           f"{build_s:.1f} s; set_image {set_ms:.1f} ms (median of 3: "
           + ", ".join(f"{v:.1f}" for v in set_runs) + f"; cv2 resize on the host, encode on the "
           f"card, host clock with a synchronise), peak {peak_gb:.2f} GB; a point's decode "
           f"{decode_ms:.2f} ms (prompt + mask decoder, low-res logits to the host)")
    msg += "; mask pixels set " + ", ".join(f"{k} {v * 100:.1f} %"
                                            for k, v in out["mask_cover"].items())
    for label, (cands, kept) in gen_card.items():
        msg += (f"; generate(points_per_side=8, {label}) {out[f'generate_s ({label})']:.2f} s, "
                f"{len(cands)} candidates, {len(kept)} masks kept")
    out["cpu_set_image_s"] = ref["set_image_s"]
    out["cpu_s"] = ref["seconds"]
    out["embedding_err"] = hold_values(f"{variant} embeddings", emb, ref["embeddings"])
    out["prompts"] = {}
    for k, (m, iou, low) in got.items():
        cm, ciou, clow = ref["prompts"][k]
        out["prompts"][k] = hold_masks(f"{variant} {k}", m, cm, iou, ciou)
        out["prompts"][k]["low_res_err"] = hold_values(f"{variant} {k} low-res logits", low, clow)
        out["prompts"][k]["iou"] = ciou.tolist()
    out["generate"] = {}
    for label, (cands, kept) in gen_card.items():
        ccands, want_b = ref["generate"][label]
        held = hold_candidates(f"{variant} generate ({label})", cands, unpack_candidates(ccands))
        got_b = np.asarray([c["bbox"] for c in kept]).reshape(-1, 4)
        if got_b.shape != want_b.shape or (len(got_b) and np.abs(
                got_b - want_b).max() > SAM_BBOX_TOL):
            raise AssertionError(f"{variant} generate ({label}): kept boxes differ: card "
                                 f"{got_b.tolist()}, CPU {want_b.tolist()}")
        out["generate"][label] = {**held, "kept": len(got_b),
                                  "kept_bbox_err": int(np.abs(got_b - want_b).max())
                                  if len(got_b) else 0}
    msg += (f"; card vs CPU (CPU build + set_image {out['cpu_set_image_s']:.1f} s, the CPU side "
            f"{out['cpu_s']:.1f} s{cpu_wait_note(ref)}): "
            f"embeddings {out['embedding_err']:.2e} of max |CPU| (tol {SAM_EMB_TOL}), "
            + "; ".join(f"{k}: IoU {v['iou_err']:.2e} (CPU IoU "
                        + ", ".join(f"{x:.4f}" for x in v["iou"])
                        + f"), low-res logits {v['low_res_err']:.2e} of max |CPU|, pixels "
                        f"flipped {v['flipped']:.2e}" for k, v in out["prompts"].items()))
    for label, v in out["generate"].items():
        msg += (f"; generate ({label}): the same {v['n']} candidates in order (boxes within "
                f"{v['bbox']} px, IoU {v['iou']:.2e}, stability {v['stability']:.2e}, pixels "
                f"flipped {v['flipped']:.2e}")
        if v["n"]:
            msg += (f"; CPU IoU {v['iou_range'][0]:.4f} to {v['iou_range'][1]:.4f}, stability "
                    f"{v['stability_range'][0]:.4f} to {v['stability_range'][1]:.4f}")
        msg += f"), the same {v['kept']} kept, boxes within {v['kept_bbox_err']} px"
    log(msg)
    del card
    torch.cuda.empty_cache()
    return out


def keep_heads(net) -> list:
    """Wrap ``net.sam_heads`` so that each call's low-res masks (all of
    them), IoU, high-res mask logits and object score logits land in the
    returned list, on their device."""
    calls, heads = [], net.sam_heads

    def wrapped(*args, **kwargs):
        out = heads(*args, **kwargs)
        calls.append({"low_res": out[0], "iou": out[1], "high_res": out[3], "obj": out[5]})
        return out

    net.sam_heads = wrapped
    return calls


def sam2_variant(variant: str, dev) -> dict:
    """``SAM2Predictor(variant)`` at 1024: its count held to JAX's,
    set_image's ms, one point's three masks; held against
    ``sam2_cpu_side``'s CPU run (from the CPU-reference worker): the
    three low-res mask logits within 1e-3 of max |CPU|, IoU 1e-3, mask
    pixels flipped 2e-3. The IoU head ends in a sigmoid, so the CPU's IoUs
    are logged beside their difference (a saturated one holds nothing)."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch.models.sam.sam2 import SAM2Predictor

    img = sam_scene(1)
    card = SAM2Predictor(variant, device=dev)
    see_objects(card.net)
    if sam_count(card.net) != SAM2_COUNTS[variant]:
        raise AssertionError(f"{variant}: {sam_count(card.net):,} parameters, JAX has "
                             f"{SAM2_COUNTS[variant]:,}")
    set_ms, set_runs = timed_ms(lambda: card.set_image(img))
    heads = keep_heads(card.net)
    m, iou = card.predict([[590, 370]])
    if not (m.shape == (3, *SAM_SHAPE) and np.isfinite(iou).all()):
        raise AssertionError(f"{variant}: masks {m.shape}, iou {iou}")
    out = {"params": sam_count(card.net), "set_image_ms": set_ms, "mask_cover": float(m.mean())}
    ref = cpu_reference(sam2_cpu_side, variant)
    out["cpu_s"] = ref["seconds"]
    out["hold"] = hold_masks(variant, m, ref["masks"], iou, ref["iou"])
    out["hold"]["low_res_err"] = hold_values(f"{variant} low-res logits", heads[-1]["low_res"],
                                             ref["low_res"])
    out["hold"]["iou"] = ref["iou"].tolist()
    out["hold"]["object_logit"] = ref["object_logit"]
    log(f"{variant} at {SAM_IMGSZ}: {out['params']:,} parameters (JAX's); set_image "
        f"{set_ms:.1f} ms (median of 3: " + ", ".join(f"{v:.1f}" for v in set_runs) + "); "
        f"mask pixels set {out['mask_cover'] * 100:.1f} % (object-score bias {OBJECT_LOGIT}: "
        f"the CPU's object logit {out['hold']['object_logit']:.6f}); card vs CPU (CPU "
        f"{out['cpu_s']:.1f} s{cpu_wait_note(ref)}): low-res logits "
        f"{out['hold']['low_res_err']:.2e} of max |CPU| (tol {SAM_EMB_TOL}), IoU "
        f"{out['hold']['iou_err']:.2e} (CPU IoU "
        + ", ".join(f"{x:.7f}" for x in out["hold"]["iou"])
        + f"), pixels flipped {out['hold']['flipped']:.2e}")
    del card
    torch.cuda.empty_cache()
    return out


def sam2_cpu_side(variant: str) -> dict:
    """The CPU side of ``sam2_variant``'s hold: ``SAM2Predictor(variant)``
    on the CPU, one point on ``sam_scene(1)``: its masks, IoU, low-res
    logits and object logit."""
    from yolo_ad_refine_tpu_torch.models.sam.sam2 import SAM2Predictor

    t0 = time.perf_counter()
    cpu = SAM2Predictor(variant, device="cpu")
    see_objects(cpu.net)
    cheads = keep_heads(cpu.net)
    cm, ciou = cpu.set_image(sam_scene(1)).predict([[590, 370]])
    return {"masks": cm, "iou": ciou, "low_res": as_numpy(cheads[-1]["low_res"]),
            "object_logit": float(cheads[-1]["obj"].reshape(-1)[0]),
            "seconds": time.perf_counter() - t0}


def video_frames(n: int) -> list:
    """The sam2_b video's first ``n`` frames: a square moving 12 px a frame."""
    return [sam_scene(2, shift=12 * i) for i in range(n)]


VIDEO_POINT = [[590, 370]]


def video_cpu_side() -> dict:
    """The CPU side of ``sam2_video``'s hold: ``SAM2VideoPredictor("sam2_b")``
    on the CPU over frames 0..VIDEO_HELD (``add_points`` on frame 0, then
    ``track``): each frame's mask, object logit (frames 1..), high-res
    mask logits and stored memory."""
    from yolo_ad_refine_tpu_torch.models.sam.sam2 import SAM2VideoPredictor

    frames = video_frames(VIDEO_HELD + 1)
    t0 = time.perf_counter()
    cpu = SAM2VideoPredictor("sam2_b", device="cpu")
    see_objects(cpu.net)
    cheads = keep_heads(cpu.net)
    masks = [cpu.add_points(frames[0], 0, VIDEO_POINT)]
    logits = []
    for i in range(1, VIDEO_HELD + 1):
        m, lg = cpu.track(frames[i], i)
        masks.append(m)
        logits.append(lg)
    memories = [cpu.cond_frames[0]] + [cpu.non_cond_frames[i] for i in range(1, VIDEO_HELD + 1)]
    return {"masks": masks, "logits": logits,
            "high_res": [as_numpy(cheads[i]["high_res"]) for i in range(VIDEO_HELD + 1)],
            "memories": [{k: as_numpy(v) for k, v in m.items()} for m in memories],
            "seconds": time.perf_counter() - t0}


def sam2_video(dev) -> dict:
    """``SAM2VideoPredictor("sam2_b")`` at 1024 over a seeded 16-frame 1280
    x 720 video of a moving square: ``add_points`` on frame 0, ``propagate``
    over frames 1-15 (frames/s, host clock); frames 0-4 held against
    ``video_cpu_side``'s CPU run (from the CPU-reference worker): each
    frame's high-res mask logits and its stored memory (mem_feat,
    mem_pos, obj_ptr) within 1e-3 of max |CPU|, mask pixels flipped 2e-3,
    object logits within 1e-3 (forced near ``OBJECT_LOGIT`` by its bias,
    so they hold little; their distance from it is logged)."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch.models.sam.sam2 import SAM2VideoPredictor

    frames = video_frames(VIDEO_FRAMES)
    point = VIDEO_POINT
    card = SAM2VideoPredictor("sam2_b", device=dev)
    see_objects(card.net)
    card.add_points(frames[0], 0, point)  # warm-up: cuDNN plans, allocator
    card.reset_state()
    heads = keep_heads(card.net)  # keeps references only: no copy, no synchronise
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masks = [card.add_points(frames[0], 0, point)]
    logits = []
    for i in range(1, VIDEO_FRAMES):
        m, lg = card.track(frames[i], i)
        masks.append(m)
        logits.append(lg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not (all(m.shape == (SAM_IMGSZ, SAM_IMGSZ) for m in masks) and np.isfinite(logits).all()):
        raise AssertionError("sam2_b video: bad masks or object logits")
    out = {"frames_per_s": VIDEO_FRAMES / dt, "ms_per_frame": dt / VIDEO_FRAMES * 1e3,
           "mask_cover": float(np.mean([m.mean() for m in masks]))}
    ref = cpu_reference(video_cpu_side)
    out["cpu_s"] = ref["seconds"]
    out["logit_err"] = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(logits, ref["logits"]))
    out["logit_minus_bias"] = [b - OBJECT_LOGIT for b in ref["logits"]]
    out["flipped"] = max(float((a != b).mean()) for a, b in zip(masks, ref["masks"]))
    out["high_res_err"] = max(hold_values(f"sam2_b video frame {i} high-res logits",
                                          heads[i]["high_res"], ref["high_res"][i])
                              for i in range(VIDEO_HELD + 1))
    memories = [(0, card.cond_frames[0], ref["memories"][0])] + [
        (i, card.non_cond_frames[i], ref["memories"][i]) for i in range(1, VIDEO_HELD + 1)]
    out["memory_err"] = {k: max(hold_values(f"sam2_b video frame {i} {k}", g[k], w[k])
                                for i, g, w in memories)
                         for k in ("mem_feat", "mem_pos", "obj_ptr")}
    log(f"sam2_b video at {SAM_IMGSZ}: {VIDEO_FRAMES} frames of 1280 x 720 (add_points on frame "
        f"0, then track), {out['frames_per_s']:.2f} frames/s, {out['ms_per_frame']:.1f} ms a "
        f"frame (host clock: cv2 resize, encode, memory attention, heads, memory encoder, mask "
        f"to the host); mask pixels set {out['mask_cover'] * 100:.1f} %; frames 0-{VIDEO_HELD} "
        f"card vs CPU (CPU {out['cpu_s']:.1f} s{cpu_wait_note(ref)}): high-res mask logits "
        f"{out['high_res_err']:.2e} of max |CPU|, memories "
        + ", ".join(f"{k} {v:.2e}" for k, v in out["memory_err"].items())
        + f" of max |CPU| (tol {SAM_EMB_TOL}); pixels flipped {out['flipped']:.2e}; object "
        f"logits {out['logit_err']:.2e} (relative to max(1, |CPU|), tol {SAM_IOU_TOL}; the CPU's "
        f"minus the bias {OBJECT_LOGIT}: " + ", ".join(f"{v:+.6f}" for v in
                                                     out["logit_minus_bias"]) + ")")
    if out["logit_err"] > SAM_IOU_TOL or out["flipped"] > MASK_FLIP_TOL:
        raise AssertionError(f"sam2_b video: card and CPU disagree: {out}")
    del card
    torch.cuda.empty_cache()
    return out


def fastsam_model(name: str, dev):
    """``FastSAM(<yaml>)`` at 1024, nc 1, seeded, class 0's scores spread:
    the seeded head's features shrink to about 1e-7 by its last conv, so
    each level scores class 0 as its bias alone, flat to float rounding,
    and which rows pass conf and their order would be noise. On a probe
    image each level's last conv is rescaled so that its logits before the
    bias have a spread (standard deviation) of ``FASTSAM_SPREAD``, and its
    bias set so that a share ``top`` of that level's anchors passes conf
    0.4, ``top`` raised along ``FASTSAM_TOPS`` until the probe keeps
    ``FASTSAM_MIN_ROWS`` rows."""
    import torch
    import torch.nn.functional as F

    from yolo_ad_refine_tpu_torch import FastSAM

    model = FastSAM(FASTSAMS[name], device=dev, imgsz=SAM_IMGSZ)
    convs = [seq[-1] for seq in model.model.model[model.model.head_idx].cv3]
    probe = [sam_scene(3)]
    pre = []  # each level's class-0 logits before the bias, on the probe, in float64
    hooks = [c.register_forward_hook(lambda m, a, _: pre.append(
        F.conv2d(a[0].double(), m.weight.double()).flatten().cpu())) for c in convs]
    model.predict(probe, imgsz=SAM_IMGSZ, batch=1)
    for h in hooks:
        h.remove()
    gains = [FASTSAM_SPREAD / x.std().item() for x in pre]
    if not all(math.isfinite(g) for g in gains):
        raise AssertionError(f"{name}: class 0's logits are constant over a level: {gains}")
    with torch.no_grad():
        for c, g in zip(convs, gains):
            c.weight.mul_(g)
    for top in FASTSAM_TOPS:
        with torch.no_grad():
            for c, x, g in zip(convs, pre, gains):
                c.bias.fill_(logit(FASTSAM_CONF) - g * torch.quantile(x, 1 - top).item())
        rows = len(model.predict(probe, imgsz=SAM_IMGSZ, batch=1)[0])
        if rows >= FASTSAM_MIN_ROWS:
            break
    model.top, model.probe_rows = top, rows
    return model


def fastsam_serving(name: str, dev) -> dict:
    """8 seeded 1280 x 720 images at batch 8, 1024, fp32, everything mode
    (conf 0.4): K4 once a batch and nothing else, images/s over 3 runs;
    the snap (boxes inside their image); then a bbox and a point prompt
    (K4 once each); then 2 images card vs CPU: the decoded boxes (5e-2
    px), scores (1e-3) and the masks of 32 fixed anchors (pixels flipped
    2e-3). Returns the run's counts, the rate and K4 on the batch's
    candidates against its plain version."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch.engine.predictor import preprocess
    from yolo_ad_refine_tpu_torch.engine.profile_nms import Impl, predict_candidates, time_case
    from yolo_ad_refine_tpu_torch.ops.nms import suppress, suppress_plain

    model = fastsam_model(name, dev)
    imgs = [sam_scene(10 + i) for i in range(FASTSAM_BATCH)]
    kw = dict(imgsz=SAM_IMGSZ, batch=FASTSAM_BATCH)
    model.predict(imgs, **kw)  # warm-up
    counters = kernel_counters()
    seconds = []
    for _ in range(3):
        for f in counters.values():
            f.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = model.predict(imgs, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = {k: f.launches for k, f in counters.items()}
        if launches != {**{k: 0 for k in launches}, "nms_suppress": 1}:
            raise AssertionError(f"{name}: launches {launches}, expected K4 once a batch")
    dt = sorted(seconds)[1]
    kept = [len(r) for r in results]
    if not sum(kept):
        raise AssertionError(f"{name}: no image kept a row at conf {FASTSAM_CONF}")
    for r in results:
        d = r.boxes.xyxy
        h, w = r.orig_shape
        if not (np.isfinite(d).all() and (d >= 0).all() and (d[:, [0, 2]] <= w).all()
                and (d[:, [1, 3]] <= h).all()) or (len(r) and r.masks.data.shape != (len(r), h, w)):
            raise AssertionError(f"{name}: bad rows or masks for an image of {r.orig_shape}")
    before = {k: f.launches for k, f in counters.items()}
    pb = model.predict(imgs[:1], bboxes=[[400, 200, 780, 540]], **kw)
    pp = model.predict(imgs[:1], points=[[590, 370], [1000, 200]], labels=[1, 0], **kw)
    if counters["nms_suppress"].launches - before["nms_suppress"] != 2 or len(pb[0]) > 1:
        raise AssertionError(f"{name} prompts: {len(pb[0])} rows for one box, K4 launches "
                             f"{counters['nms_suppress'].launches - before['nms_suppress']}")
    out = {"run": launches, "images_per_s": FASTSAM_BATCH / dt, "ms_per_batch": dt * 1e3,
           "kept_mean": float(np.mean(kept)), "top": model.top, "probe_rows": model.probe_rows,
           "kept_scores": [float(min(r.boxes.conf.min() for r in results if len(r))),
                           float(max(r.boxes.conf.max() for r in results if len(r)))],
           "prompt_rows": {"bbox": len(pb[0]), "points": len(pp[0])}}
    bx, sc = predict_candidates(model, imgs, SAM_IMGSZ, (FASTSAM_CONF,))[FASTSAM_CONF]
    if not torch.equal(suppress(bx, sc, NMS_IOU, FASTSAM_CONF),
                       suppress_plain(bx, sc, NMS_IOU, FASTSAM_CONF)):
        raise AssertionError(f"{name}: K4's keep mask differs from plain on the batch")
    with quiet_card():
        r = time_case(Impl(), "K4", bx, sc, FASTSAM_CONF)
        plain_ms = cuda_time(lambda: suppress_plain(bx, sc, NMS_IOU, FASTSAM_CONF), iters=3,
                             warmup=1)
    bound = k4_bound(r["keep"])
    out["k4"] = {"B": sc.shape[0], "K": sc.shape[1], "ms": r["ms"], "device_ms": r["device_ms"],
                 "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
                 "bound_by": bound["bound_by"], "kept": r["kept"], "valid": r["valid"]}
    msg = (f"{name} ({FASTSAMS[name]}, nc 1, class 0 spread to {FASTSAM_SPREAD} logit and "
           f"the top {model.top * 100:g} % of a level's anchors past conf, the probe keeping "
           f"{model.probe_rows} rows): "
           f"{FASTSAM_BATCH} images of 1280 x 720 at batch {FASTSAM_BATCH}, imgsz {SAM_IMGSZ}, "
           f"fp32, everything mode at conf {FASTSAM_CONF}: {out['images_per_s']:.1f} images/s, "
           f"{dt * 1e3:.1f} ms a batch (median of 3: "
           + ", ".join(f"{FASTSAM_BATCH / s:.1f}" for s in seconds) + " images/s; host clock, "
           f"preprocess + forward + NMS + masks + snap); kept {np.mean(kept):.1f} an image "
           f"({min(kept)}-{max(kept)}, scores {out['kept_scores'][0]:.4f} to "
           f"{out['kept_scores'][1]:.4f}); "
           f"launches {launches}; bbox prompt {len(pb[0])} row, point prompts {len(pp[0])} rows; "
           f"K4 on the batch's candidates (B={sc.shape[0]}, K={sc.shape[1]}): keep mask equal "
           f"to plain, kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain "
           f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.5f} ms")
    x, metas = preprocess(imgs[:2], SAM_IMGSZ, 2, torch.device(dev), torch.float32)
    t0 = time.perf_counter()
    with torch.inference_mode():
        y_gpu, f_gpu = model.model(x)
        y_cpu, f_cpu = copy.deepcopy(model.model).cpu()(x.cpu())
    out["cpu_s"] = time.perf_counter() - t0
    y_gpu = y_gpu.float().cpu()
    errs = {"box": (y_gpu[..., :4] - y_cpu[..., :4]).abs().max().item(),
            "score": (y_gpu[..., 4:5] - y_cpu[..., 4:5]).abs().max().item()}
    errs["mask_pixels_flipped"] = anchor_mask_flips((y_gpu, f_gpu), (y_cpu, f_cpu), 1, metas,
                                                    imgs, SAM_IMGSZ, name)
    out["hold"] = errs
    msg += (f"; card vs CPU on 2 images (CPU {out['cpu_s']:.1f} s): max |box diff| "
            f"{errs['box']:.3e} px (tol 5e-2), max |score diff| {errs['score']:.3e} (tol "
            f"1e-3), mask pixels flipped (32 anchors an image) "
            f"{errs['mask_pixels_flipped']:.3e} (tol {MASK_FLIP_TOL})")
    if errs["box"] > 5e-2 or errs["score"] > 1e-3 or errs["mask_pixels_flipped"] > MASK_FLIP_TOL:
        raise AssertionError(f"{name}: card and CPU predictions disagree: {errs}")
    log(msg)
    del model
    torch.cuda.empty_cache()
    return out


def nas_run(dev) -> dict:
    """``nas_postprocess`` on a seeded raw NAS layout (32, 8400, 4) xyxy and
    (32, 8400, 80) scores: K4 once a call, its rows equal to the CPU's
    within 1e-4 px and its counts equal; the call's ms; ``NAS("yolo_nas_s")``
    raises ImportError without super_gradients, as in JAX."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import NAS
    from yolo_ad_refine_tpu_torch.models.nas import nas_postprocess
    from yolo_ad_refine_tpu_torch.ops.nms import suppress

    b, n, nc = NAS_SHAPE
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 600, (b, n, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(4, 120, (b, n, 2)).astype(np.float32)], -1)
    # background everywhere, and 3 % of the anchors an object of one class
    scores = rng.uniform(0, 0.2, (b, n, nc)).astype(np.float32)
    obj = rng.uniform(size=(b, n)) < 0.03
    scores[obj, rng.integers(0, nc, int(obj.sum()))] = rng.uniform(0.3, 1.0, int(obj.sum()))
    bt, st = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
    nas_postprocess(bt, st)  # warm-up
    suppress.launches = 0
    det, cnt = nas_postprocess(bt, st)
    run = {k: f.launches for k, f in kernel_counters().items()}
    if run["nms_suppress"] != 1:
        raise AssertionError(f"nas_postprocess: launches {run}, expected K4 once")
    with quiet_card():
        ms = cuda_time(lambda: nas_postprocess(bt, st), iters=5)
    cdet, ccnt = nas_postprocess(boxes, scores, device="cpu")
    err = float(np.abs(det - cdet).max())
    if not np.array_equal(cnt, ccnt) or err > 1e-4:
        raise AssertionError(f"nas_postprocess: card and CPU rows differ ({err:.3e}, counts "
                             f"{cnt} / {ccnt})")
    try:
        NAS("yolo_nas_s")
    except ImportError:
        pass
    else:
        raise AssertionError("NAS('yolo_nas_s') built without super_gradients")
    log(f"NAS postprocess on a raw ({b}, {n}, 4) xyxy + ({b}, {n}, {nc}) layout: {ms:.3f} ms a "
        f"call (CUDA events: xywh, candidate selection, K4, rows to the host), "
        f"{float(np.mean(cnt)):.1f} rows an image, equal to the CPU's (max |diff| {err:.1e}); "
        f"K4 launches {run['nms_suppress']}; NAS('yolo_nas_s') raises ImportError")
    return {"run": run, "ms": ms, "rows_mean": float(np.mean(cnt))}


def phase_sam(dev) -> dict:
    """The SAM family on the card (fp32, TF32 off, seeded weights, JAX's
    parameter counts): sam_b at 1024 on a 1280 x 720 image (a point, two
    points with a background one, a box; ``generate(points_per_side=8)``),
    sam_l and sam_h (a point each), mobile_sam (a point, a box),
    SAM2Predictor for sam2_t / s / b / l (a point each),
    SAM2VideoPredictor("sam2_b") over 16 frames, FastSAM-s and -x at 1024
    on 8 images in everything mode with bbox and point prompts (K4 once a
    batch), and nas_postprocess (K4 once). Every model is held against the
    CPU at ``SAM_EMB_TOL``, ``SAM_IOU_TOL``, ``SAM_STABILITY_TOL`` and
    ``MASK_FLIP_TOL``; the phase's seconds are logged."""
    t_phase = time.perf_counter()
    out = {"sam": {}, "sam2": {}, "fastsam": {}}
    paths = {}
    counters = kernel_counters()

    def path(name, fn, *args):
        for f in counters.values():
            f.launches = 0
        r = fn(*args)
        paths[name] = {k: f.launches for k, f in counters.items()}
        return r

    out["sam"]["sam_b"] = path("sam_b_run", sam_variant, "sam_b", dev, True)
    for v in ("sam_l", "sam_h", "mobile_sam"):
        out["sam"][v] = sam_variant(v, dev)
    for v in SAM2_COUNTS:
        out["sam2"][v] = sam2_variant(v, dev)
    out["video"] = path("sam2_video_run", sam2_video, dev)
    for name in FASTSAMS:
        r = fastsam_serving(name, dev)
        out["fastsam"][name] = r
        paths[f"{name.lower().replace('-', '_')}_serving_run"] = r["run"]
    nas = nas_run(dev)
    paths["nas_postprocess_run"] = nas["run"]
    out["nas"] = nas
    out["paths"] = paths
    out["k4"] = {**{f"{k} batch": v["k4"] for k, v in out["fastsam"].items()},
                 "nas call ms": nas["ms"]}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"SAM family: {out['seconds']:.1f} s")
    return out


TRACK_FRAMES, TRACK_SHAPE, TRACK_CONF = 48, (720, 1280), 0.25
TRACK_HELD = 24  # frames of the CPU's run: the trackers are causal, so the card's first 24 rows
TRACK_PRIOR = 0.15  # class 0's prior in the flagship's shared cv3: tens of rows at conf 0.25
TRACK_BOX_TOL = 5e-2  # px, card vs CPU track rows
TRACKER_THRESHOLDS = (0.25, 0.1)  # bytetrack / botsort defaults: high = new-track, low


def track_video(path: Path, frames: int | None = None) -> Path:
    """A seeded 1280x720 MJPG video of ``frames`` frames at 30 fps: a dim
    textured background panning one pixel a frame and eight filled shapes
    moving on straight lines across it (a shorter video is the longer
    one's first frames)."""
    import cv2
    import numpy as np

    frames = frames or TRACK_FRAMES
    rng = np.random.default_rng(3)
    h, w = TRACK_SHAPE
    base = cv2.resize(rng.integers(0, 90, (h // 8, w // 8, 3), dtype=np.uint8), (w, h))
    starts = rng.uniform((40, 40), (w - 240, h - 200), (8, 2))
    vel = rng.uniform(-9, 9, (8, 2))
    sizes = rng.uniform(50, 170, (8, 2))
    colors = rng.integers(90, 256, (8, 3))
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30, (w, h))
    for t in range(frames):
        frame = np.roll(base, t, axis=1).copy()
        for j in range(8):
            x, y = (starts[j] + vel[j] * t).astype(int)
            sw, sh = sizes[j].astype(int)
            color = tuple(int(c) for c in colors[j])
            if j % 2:
                cv2.ellipse(frame, (x + sw // 2, y + sh // 2), (sw // 2, sh // 2), 0, 0, 360,
                            color, -1)
            else:
                cv2.rectangle(frame, (x, y), (x + sw, y + sh), color, -1)
        out.write(frame)
    out.release()
    return path


def match_track_rows(g, w):
    """Card rows ``g`` against CPU rows ``w`` (n, 7) of one frame, each card
    row to the CPU row of the nearest box: (index into w for each row of g,
    max box diff, max score diff), or None where the counts, the pairing
    or the classes disagree."""
    import numpy as np

    if g.shape != w.shape:
        return None
    if not len(g):
        return np.zeros(0, int), 0.0, 0.0
    d = np.abs(g[:, None, :4] - w[None, :, :4]).max(-1)
    j = d.argmin(1)
    if len(set(j.tolist())) != len(g) or not np.array_equal(g[:, 6], w[j, 6]):
        return None
    return j, float(d[np.arange(len(g)), j].max()), float(np.abs(g[:, 5] - w[j, 5]).max())


def hold_tracks(label: str, got: list, want: list, card, cpu, frames) -> dict:
    """Card against CPU track rows, frame by frame: the same rows (each
    card row paired with the CPU row of the nearest box) with boxes within
    TRACK_BOX_TOL px, scores within 1e-3 and the same classes, and the same
    ids up to one relabeling fixed over the whole video. A new track takes
    the next id in the order of its frame's detections, and detections
    whose scores tie within rounding (seeded weights score a flat region's
    anchors alike) may sort apart on the card and the CPU: their tracks
    then carry each other's numbers, which the relabeling allows and counts.
    A frame that differs otherwise is excused, and the hold stops there,
    only where a detection's score on either side, in that frame or an
    earlier one (a track's state carries it on), lies within 1e-3 of a
    threshold the NMS or the tracker reads (conf, track_high / new_track,
    track_low): rounding may then put it on the other side."""
    import numpy as np

    from yolo_ad_refine_tpu_torch.engine.track import frame_rows

    box_err = score_err = 0.0
    ids: dict = {}
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.boxes.data, w.boxes.data
        m = match_track_rows(g, w)
        if m is not None:
            j, b, sc = m
            box_err, score_err = max(box_err, b), max(score_err, sc)
            pairs = dict(zip(g[:, 4].astype(int).tolist(), w[j, 4].astype(int).tolist()))
            consistent = all(ids.get(k, v) == v for k, v in pairs.items())
            ids.update(pairs)
            if consistent and len(set(ids.values())) == len(ids) and \
                    box_err <= TRACK_BOX_TOL and score_err <= 1e-3:
                continue
        for k in range(i, -1, -1):
            scores = np.concatenate([frame_rows(mm, frames[k], conf=TRACK_CONF)[0][:, 4]
                                     for mm in (card, cpu)])
            near = [float(v) for v in scores
                    if min(abs(v - t) for t in (TRACK_CONF, *TRACKER_THRESHOLDS)) < 1e-3]
            if near:
                break
        else:
            raise AssertionError(f"{label}: card and CPU tracks differ at frame {i + 1} with no "
                                 f"score near a threshold up to it: rows {g.shape} vs {w.shape}, "
                                 f"max box diff {box_err:.3e} px, score diff {score_err:.3e}")
        log(f"{label}: card and CPU tracks part at frame {i + 1} of {len(got)}; frame {k + 1} "
            f"has scores {near[:4]} within 1e-3 of a threshold; held frames 1-{i}")
        return {"held_frames": i, "box_err": box_err, "score_err": score_err, "parted_at": i + 1,
                "ids": len(ids), "ids_renumbered": sum(k != v for k, v in ids.items())}
    return {"held_frames": len(got), "box_err": box_err, "score_err": score_err,
            "parted_at": None, "ids": len(ids),
            "ids_renumbered": sum(k != v for k, v in ids.items())}


def track_model(dev):
    """The tracking phase's flagship (scale n, seed 0, 640) with class 0 at
    the prior TRACK_PRIOR."""
    import torch

    from yolo_ad_refine_tpu_torch import YOLO

    model = YOLO(FLAGSHIP, device=dev, imgsz=640, seed=0)
    with torch.no_grad():
        model.model.model[model.model.head_idx].cv3.bias[0] = logit(TRACK_PRIOR)
    return model


def track_cpu_side(tracker: str) -> dict:
    """The CPU side of ``phase_track``'s hold: ``track_model`` on the CPU
    over the video's first TRACK_HELD frames with ``tracker`` (cv2's
    generator seeded as on the card). Returns {"results", "seconds"}."""
    model = track_model("cpu")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_track_cpu_") as tmp:
        head = str(track_video(Path(tmp) / "head.avi", TRACK_HELD))
        cv2_seed(0)
        t0 = time.perf_counter()
        results = model.track(head, tracker=tracker, imgsz=640, conf=TRACK_CONF)
    return {"results": results, "seconds": time.perf_counter() - t0}


def phase_track(dev) -> dict:
    """``YOLO.track`` with the flagship (scale n, seeded weights, class 0 at
    the prior TRACK_PRIOR) at 640 over a 1280x720 MJPG video of 48 frames
    (``track_video``), with ``bytetrack`` and with ``botsort``: a warm-up
    run, then a timed run with the launch counts set to 0 (K4 once a frame,
    at B = 1, and K1 fwd 3 times a frame), its frames/s and each frame's
    split into host preprocess, forward + NMS (which waits for the card)
    and the tracker; the first TRACK_HELD frames' rows held against the
    same track on the CPU over those frames (``hold_tracks``); and K4 held
    against its plain version on one frame's candidates (B = 1, K = 2048),
    both timed. ``results`` keeps each tracker's (card results, CPU results,
    frames held) for ``phase_periphery``'s solutions."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch.data.loaders import load_inference_source
    from yolo_ad_refine_tpu_torch.engine.profile_nms import Impl, predict_candidates, time_case
    from yolo_ad_refine_tpu_torch.ops.nms import suppress_plain

    model = track_model(dev)
    cpu = copy.deepcopy(model)  # for hold_tracks' look at the scores of a frame that parts
    cpu.model = cpu.model.cpu()
    counters = kernel_counters()
    out = {"paths": {}, "results": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_track_") as tmp:
        vid = str(track_video(Path(tmp) / "track.avi"))
        frames = [f for _, f, _ in load_inference_source(vid)]
        if len(frames) != TRACK_FRAMES or frames[0].shape[:2] != TRACK_SHAPE:
            raise AssertionError(f"the video reads back as {len(frames)} frames of "
                                 f"{frames[0].shape}")
        for tracker in ("bytetrack", "botsort"):
            kw = dict(tracker=tracker, imgsz=640, conf=TRACK_CONF)
            model.track(vid, **kw)  # warm-up: cuDNN plans, allocator
            for f in counters.values():
                f.launches = 0
            cv2_seed(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = model.track(vid, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: f.launches for k, f in counters.items()}
            if launches["nms_suppress"] != TRACK_FRAMES or \
                    launches["dcn_forward"] != 3 * TRACK_FRAMES or \
                    any(v for k, v in launches.items() if k not in ("nms_suppress",
                                                                    "dcn_forward")):
                raise AssertionError(f"{tracker}: the track path did not launch K4 once and K1 "
                                     f"three times a frame, and nothing else: {launches}")
            speed = {k: float(np.mean([r.speed[k] for r in got]))
                     for k in ("preprocess", "inference", "track")}
            frame_ms = sum(speed.values())
            host = (speed["preprocess"] + speed["track"]) / frame_ms
            rows = [len(r) for r in got]
            ids = {int(i) for r in got for i in r.boxes.data[:, 4]}
            log(f"{tracker}: {TRACK_FRAMES} frames of {TRACK_SHAPE[1]}x{TRACK_SHAPE[0]} at 640 "
                f"in {wall:.2f} s, {TRACK_FRAMES / wall:.1f} frames/s (host clock with a "
                f"synchronise); a frame {frame_ms:.1f} ms: preprocess {speed['preprocess']:.1f}, "
                f"forward + NMS + the rows on the host {speed['inference']:.1f}, tracker "
                f"{speed['track']:.1f} ms (host share, preprocess + tracker, {host * 100:.1f} %); "
                f"tracks a frame {np.mean(rows):.1f} (min {min(rows)}, max {max(rows)}), "
                f"{len(ids)} ids; launches {launches}")
            if len(got) != TRACK_FRAMES or not all(r.boxes.is_track for r in got) or \
                    not 1 < len(ids) or not all(np.isfinite(r.boxes.data).all() for r in got):
                raise AssertionError(f"{tracker}: bad track results")
            ref = cpu_reference(track_cpu_side, tracker)
            want = ref["results"]
            held = hold_tracks(tracker, got[:TRACK_HELD], want, model.model, cpu.model, frames)
            log(f"{tracker}: card vs CPU ({ref['seconds']:.1f} s on the CPU"
                f"{cpu_wait_note(ref)}): {held['held_frames']} "
                f"of the first {TRACK_HELD} frames held, rows and classes equal, "
                f"{held['ids']} ids of which {held['ids_renumbered']} renumbered (tied scores "
                f"at their first frame), max |box diff| {held['box_err']:.3e} px (tol "
                f"{TRACK_BOX_TOL}), max |score diff| {held['score_err']:.3e} (tol 1e-3)")
            out["paths"][f"track_{tracker}_run"] = launches
            out[tracker] = {"frames_per_s": TRACK_FRAMES / wall, "frame_ms": frame_ms,
                            "host_share": host, **speed, **held}
            out["results"][tracker] = (got, want, held["held_frames"])
    bx, sc = predict_candidates(model, frames[:1], 640, (TRACK_CONF,))[TRACK_CONF]
    got, want = Impl()("K4", bx, sc, TRACK_CONF), suppress_plain(bx, sc, NMS_IOU, TRACK_CONF)
    if not torch.equal(got, want):
        raise AssertionError(f"K4 differs from plain on a tracked frame's candidates: "
                             f"{int((got != want).sum())} entries")
    with quiet_card():
        r = time_case(Impl(), "K4", bx, sc, TRACK_CONF)
        plain_ms = cuda_time(lambda: suppress_plain(bx, sc, NMS_IOU, TRACK_CONF), iters=3,
                             warmup=1)
    bound = k4_bound(got)
    out["k4"] = {"B": 1, "K": int(sc.shape[1]), "ms": r["ms"], "device_ms": r["device_ms"],
                 "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
                 "bound_by": bound["bound_by"], "kept": r["kept"], "valid": r["valid"]}
    log(f"K4 on a tracked frame's candidates (B=1, K={sc.shape[1]}): keep mask equal to plain; "
        f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain {plain_ms:.3f} ms, bound "
        f"{bound['bound_ms']:.5f} ms, {r['kept']} kept of {r['valid']} valid")
    return out


def cv2_seed(seed: int) -> None:
    """cv2's global generator, which BOT-SORT's RANSAC draws from."""
    import cv2

    cv2.setRNGSeed(seed)


NATIVE_PIXEL_TOL = (2.0, 12)  # mean and p99 |native - cv2| grey levels (tests/test_native.py:91-92)
EXPLORER_IMAGES, EXPLORER_IMGSZ, EXPLORER_BATCH = 40, 256, 16
ANNOTATE_IMAGES = 16
DOTA_SCENE, DOTA_LABELS, DOTA_CROP, DOTA_GAP = (3000, 4000), 20, 1024, 200


def native_batch(model, imgs, dev):
    """The flagship's forward and the port's NMS (conf 0.001, max_det 20) on
    one native batch of BGR uint8 letterboxed images, as the predictor
    feeds it: RGB, [0, 1], channels_last. Returns (det, cnt) on the host."""
    import torch

    from yolo_ad_refine_tpu_torch.ops.nms import non_max_suppression

    x = torch.from_numpy(imgs).to(dev).flip(-1).permute(0, 3, 1, 2).float() / 255.0
    with torch.inference_mode():
        det, cnt, _ = non_max_suppression(model.model(x)[0], conf_thres=0.001, iou_thres=0.7,
                                          max_det=20, nc=model.model.n_scores)
    return det.cpu().numpy(), cnt.cpu().numpy()


def native_serving(dev) -> dict:
    """``LoadImagesNative(batch=32, imgsz=640, threads=8)`` over the folder
    serving phase's 64 seeded JPEGs, each batch through the flagship's
    forward and the port's NMS on the card, boxes mapped back through the
    loader's meta. Held: K1 fwd 3 and K4 1 a batch; each image's pixels
    against ``cv2.imread`` and the port's letterbox (mean and p99 within
    NATIVE_PIXEL_TOL); each meta's ratio and pads against that letterbox's
    within 1e-6; boxes finite and inside their images. Printed: images/s of
    this path, of ``YOLO.predict(source=<folder>)`` and of the same images
    as arrays, from one run each after a warm-up, and the decoder."""
    import cv2
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.data.augment import letterbox_np
    from yolo_ad_refine_tpu_torch.data.loaders import LoadImagesNative
    from yolo_ad_refine_tpu_torch.ops import native
    from yolo_ad_refine_tpu_torch.ops.boxes import scale_boxes

    t0 = time.perf_counter()
    decoder = native.loader_decoder()
    build_s = time.perf_counter() - t0
    model = YOLO(FLAGSHIP, device=dev, imgsz=640, seed=0)
    counters = kernel_counters()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_native_") as tmp:
        folder = serving_jpegs(Path(tmp) / "images")

        def serve():
            out = []
            for paths, imgs, meta in LoadImagesNative(folder, imgsz=640, batch=32, threads=8):
                det, cnt = native_batch(model, imgs, dev)
                for j, path in enumerate(paths):
                    h0, w0, r, dw, dh = (float(v) for v in meta[j])
                    d = det[j, :cnt[j]].copy()
                    d[:, :4] = scale_boxes((640, 640), torch.from_numpy(d[:, :4]),
                                           (int(h0), int(w0)), ratio_pad=((r, r), (dw, dh))).numpy()
                    out.append((path, imgs[j], meta[j], d))
            return out

        serve()  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        served = serve()
        torch.cuda.synchronize()
        rate = {"native loader": len(served) / (time.perf_counter() - t0)}
        launches = {k: f.launches for k, f in counters.items()}
        if len(served) != 64 or launches["dcn_forward"] != 6 or launches["nms_suppress"] != 2 or \
                any(v for k, v in launches.items() if k not in ("dcn_forward", "nms_suppress")):
            raise AssertionError(f"native serving: {len(served)} images, launches {launches}")
        decoded = [cv2.imread(str(f)) for f in sorted(folder.glob("*.jpg"))]
        worst = [0.0, 0.0, 0.0]  # mean, p99, meta
        for (path, img, meta, d), ref in zip(served, decoded):
            want, (r, _), (dw, dh) = letterbox_np(ref, (640, 640))
            diff = np.abs(img.astype(int) - want.astype(int))
            meta_err = max(abs(meta[2] - r), abs(meta[3] - dw), abs(meta[4] - dh))
            worst = [max(worst[0], diff.mean()), max(worst[1], np.percentile(diff, 99)),
                     max(worst[2], meta_err)]
            h, w = ref.shape[:2]
            if tuple(meta[:2]) != (h, w) or not (0 < len(d) <= 20 and np.isfinite(d).all()) or \
                    (d[:, [0, 2]] < 0).any() or (d[:, [0, 2]] > w).any() or \
                    (d[:, [1, 3]] < 0).any() or (d[:, [1, 3]] > h).any():
                raise AssertionError(f"native serving: {path}: meta {meta}, {len(d)} boxes")
        if worst[0] >= NATIVE_PIXEL_TOL[0] or worst[1] > NATIVE_PIXEL_TOL[1] or worst[2] > 1e-6:
            raise AssertionError(f"native serving ({decoder}): pixels against cv2 mean "
                                 f"{worst[0]:.3f} / p99 {worst[1]} (limits {NATIVE_PIXEL_TOL}), "
                                 f"meta {worst[2]:.2e}")
        opts = dict(batch=32, imgsz=640, conf=0.001, max_det=20)
        model.predict(decoded[:32], **opts)  # warm-up of the predictor's path
        for label, src in (("YOLO.predict(folder)", str(folder)), ("numpy arrays", decoded)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.predict(source=src, **opts)
            torch.cuda.synchronize()
            rate[label] = 64 / (time.perf_counter() - t0)
    log(f"native serving ({decoder} decode, loader built or loaded in {build_s:.1f} s): 64 JPEGs "
        f"(8 shapes) at batch 32, 640, fp32: pixels against cv2.imread + letterbox worst mean "
        f"{worst[0]:.3f} and p99 {worst[1]:.0f} grey levels (limits < {NATIVE_PIXEL_TOL[0]}, "
        f"<= {NATIVE_PIXEL_TOL[1]}), meta {worst[2]:.2e} (tol 1e-6); launches {launches}")
    log("native serving: images/s (host clock, one run each after a warm-up): "
        + ", ".join(f"{k} {v:.1f}" for k, v in rate.items()))
    return {"launches": launches, "rate": rate, "decoder": decoder, "pixels": worst}


def track_region(results) -> list:
    """A rectangle over the upper half of where the first frame's track
    centres lie (their x span, from their top to their median y), so that
    region counts and queue lengths are neither 0 nor all by placement."""
    import numpy as np

    d = results[0].boxes.data
    cx, cy = (d[:, 0] + d[:, 2]) / 2, (d[:, 1] + d[:, 3]) / 2
    x0, x1 = float(cx.min()) - 10, float(cx.max()) + 10
    y0, y1 = float(cy.min()) - 10, float(np.median(cy))
    return [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]


def solution_apps(names: dict, region: list) -> dict:
    """The six apps over 1280x720 frames, and ObjectCounter twice: a
    counting line down the middle and ``region``, which QueueManager
    watches too."""
    from yolo_ad_refine_tpu_torch import solutions

    h, w = TRACK_SHAPE
    return {"ObjectCounter": solutions.ObjectCounter([(w // 2, 0), (w // 2, h)], names=names),
            "RegionCounter": solutions.ObjectCounter(region, names=names),
            "Heatmap": solutions.Heatmap((h, w), decay=1.0),
            "SpeedEstimator": solutions.SpeedEstimator(fps=30, pixels_per_meter=10),
            "QueueManager": solutions.QueueManager(region, names=names),
            "DistanceCalculator": solutions.DistanceCalculator(10.0),
            "Analytics": solutions.Analytics("line", names=names)}


def feed_apps(apps: dict, results: list) -> dict:
    """Each frame's Results to each app; returns each app's ms a frame.
    ``Analytics`` records its counts (``record``: the card's machine has no
    matplotlib to render them); the distance of every pair is kept."""
    names = list(apps)
    ms = dict.fromkeys(names, 0.0)
    apps["distances"] = []
    for i, r in enumerate(results):
        for name in names:
            t0 = time.perf_counter()
            if name == "Analytics":
                apps[name].record(i, r)
            elif name == "DistanceCalculator":
                apps["distances"].append(apps[name].update(r))
            else:
                apps[name].update(r)
            ms[name] += (time.perf_counter() - t0) * 1e3
    return {k: v / max(len(results), 1) for k, v in ms.items()}


def solutions_on_tracks(track: dict) -> dict:
    """``phase_track``'s ByteTrack results on the card (48 frames of
    1280x720) through ObjectCounter (a line, and a region over half the
    tracks: ``track_region``), Heatmap, SpeedEstimator, QueueManager (the
    region), DistanceCalculator and Analytics, each app's ms a frame
    printed; then the frames the card and the CPU tracks held alike
    (``hold_tracks``) through fresh apps on each side. Held equal: the
    in / out totals and the per-class counts (they do not depend on track
    numbering), the queue's count a frame, Analytics' totals and per-class
    history; within the boxes' tolerance (TRACK_BOX_TOL px): the heat's sum
    and mass (a box edge across an integer moves a row of pixels), the
    sorted speeds and distances (ids may be renumbered). The seeded
    detector's boxes sit at fixed anchors, so its tracks do not move (the
    largest step is printed): the line counts nothing and the speeds are
    0; the region counts, queue, heat and distances are what the hold
    reads."""
    import numpy as np

    got, want, held = track["results"]["bytetrack"]
    names = {0: "class0"}
    region = track_region(got)
    apps = solution_apps(names, region)
    ms = feed_apps(apps, got)
    card, cpu = solution_apps(names, region), solution_apps(names, region)
    feed_apps(card, got[:held])
    feed_apps(cpu, want[:held])
    counts = {k: (card[k].summary(), cpu[k].summary()) for k in ("ObjectCounter", "RegionCounter")}
    equal = {**{k: a == b for k, (a, b) in counts.items()},
             "QueueManager": card["QueueManager"].history == cpu["QueueManager"].history,
             "Analytics": (card["Analytics"].totals, card["Analytics"].classwise)
             == (cpu["Analytics"].totals, cpu["Analytics"].classwise)}
    heat, heat_cpu = card["Heatmap"].heat, cpu["Heatmap"].heat
    heat_err = abs(float(heat.sum()) - float(heat_cpu.sum())) / max(float(heat_cpu.sum()), 1.0)
    heat_px = float((heat != heat_cpu).mean())
    sp, sp_cpu = (sorted(a["SpeedEstimator"].speeds.values()) for a in (card, cpu))
    # a box within TRACK_BOX_TOL moves a centre's step by up to twice that
    speed_tol = 2 * TRACK_BOX_TOL * 30 / 10 * 3.6
    dist = sorted(d["pixels"] for d in card["distances"][-1].values()) if held else []
    dist_cpu = sorted(d["pixels"] for d in cpu["distances"][-1].values()) if held else []
    close = (len(sp) == len(sp_cpu) and np.allclose(sp, sp_cpu, atol=speed_tol, rtol=0)
             and len(dist) == len(dist_cpu)
             and np.allclose(dist, dist_cpu, atol=2 * TRACK_BOX_TOL, rtol=0))
    centres = {}
    for r in got:
        for row in r.boxes.data:
            centres.setdefault(int(row[4]), []).append(((row[0] + row[2]) / 2, (row[1] + row[3]) / 2))
    step = max((float(np.abs(np.diff(np.asarray(c), axis=0)).max()) for c in centres.values()
                if len(c) > 1), default=0.0)
    region_counts = apps["RegionCounter"].summary()
    log(f"solutions over {len(got)} ByteTrack frames of {TRACK_SHAPE[1]}x{TRACK_SHAPE[0]} "
        f"({len(centres)} tracks, largest centre step {step:.3f} px): ms a frame "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f"; line in "
        f"{apps['ObjectCounter'].in_count} out {apps['ObjectCounter'].out_count}, region in "
        f"{region_counts['in']} out {region_counts['out']}, queue mean "
        f"{np.mean(apps['QueueManager'].history):.2f}, {len(apps['SpeedEstimator'].speeds)} "
        f"speeds (max {max(apps['SpeedEstimator'].speeds.values(), default=0.0):.3f} km/h), "
        f"heat sum {float(apps['Heatmap'].heat.sum()):.0f}")
    log(f"solutions card vs CPU over the {held} frames held alike: line {counts['ObjectCounter']}, "
        f"region {counts['RegionCounter']}; queue / analytics equal {equal['QueueManager']} / "
        f"{equal['Analytics']}; heat sum {heat_err:.2e} relative, {heat_px:.2e} of the pixels "
        f"differ; {len(sp)} speeds, {len(dist)} distances within {speed_tol:.2f} km/h / "
        f"{2 * TRACK_BOX_TOL} px: {close}")
    if not held or not all(equal.values()) or not close or heat_err > 1e-2 or heat_px > 1e-2 \
            or not region_counts["in"] + region_counts["out"]:
        raise AssertionError(f"solutions: card and CPU apps disagree over {held} frames: "
                             f"{equal}, speeds / distances {close}, heat {heat_err}, {heat_px}, "
                             f"region {region_counts}")
    return {"ms": ms, "held_frames": held, "counts": counts, "largest_step": step}


def calibrate_for_embeddings(model, imgs) -> None:
    """Make a seeded model's embeddings follow its images: BatchNorm's
    running statistics from one train-mode forward over ``imgs`` (momentum
    1, as a trained model's are calibrated to its data), then AYHead's
    output biases zeroed. Seeded, the features shrink layer by layer under
    uncalibrated statistics and the head's biases (box 1.0, class prior)
    are the embedding: every similarity of the explorer's 40 images is 1 -
    1.2e-7 (measured on the CPU), so an order would be rounding's."""
    import torch

    p = next(model.parameters())
    x = torch.from_numpy(imgs).to(p.device).flip(-1).permute(0, 3, 1, 2).float() / 255.0
    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    momenta = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(x.contiguous(memory_format=torch.channels_last))
        head = model.model[model.head_idx]
        head.cv2.bias.zero_()
        head.cv3.bias.zero_()
    model.eval()
    for m, mom in zip(norms, momenta):
        m.momentum = mom


def explorer_embeddings(dev) -> dict:
    """``Explorer.create_embeddings_table`` with the flagship at 256 over 40
    seeded labelled images (the shapes set) at batch 16, so the last batch
    is 8 images and 8 zero images, card against CPU, the model calibrated
    by ``calibrate_for_embeddings`` on the card and copied to the CPU:
    embeddings within 1e-4 of max |CPU|, ``get_similar(0)`` in the same
    order (swaps allowed only between similarities within 1e-6 of each
    other on the CPU), ``sql_query("WHERE labels LIKE '%0%'")`` with the
    same rows; K1 fwd 3 a batch on the card."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.data import check_det_dataset
    from yolo_ad_refine_tpu_torch.data.explorer import Explorer
    from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset

    model = YOLO(FLAGSHIP, device=dev, imgsz=EXPLORER_IMGSZ, seed=0).model
    counters = kernel_counters()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_explorer_") as tmp:
        data = check_det_dataset(make_shapes_dataset(Path(tmp) / "ds", n_train=EXPLORER_IMAGES,
                                                     n_val=1, imgsz=EXPLORER_IMGSZ, seed=11))
        kw = dict(img_path=data["train"], imgsz=EXPLORER_IMGSZ, batch=EXPLORER_BATCH)
        card = Explorer(model=model, **kw)
        calibrate_for_embeddings(model, np.stack([card.dataset.get_sample(j)["img"][..., ::-1]
                                                  for j in range(EXPLORER_IMAGES)]))
        cpu_model = copy.deepcopy(model).cpu()
        card.create_embeddings_table()  # warm-up
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        emb = card.create_embeddings_table(force=True)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        cpu = Explorer(model=cpu_model, **kw)
        t0 = time.perf_counter()
        want = cpu.create_embeddings_table()
        cpu_s = time.perf_counter() - t0
        err = float(np.abs(emb - want).max() / np.abs(want).max())
        sims, sims_cpu = card.get_similar(0, limit=EXPLORER_IMAGES), \
            cpu.get_similar(0, limit=EXPLORER_IMAGES)
        ws = {r["idx"]: r["similarity"] for r in sims_cpu}
        order_ok = all(ws[a["idx"]] >= ws[b["idx"]] - 1e-6 for a, b in zip(sims, sims[1:]))
        swaps = sum(a["idx"] != b["idx"] for a, b in zip(sims, sims_cpu))
        rows, rows_cpu = (e.sql_query("WHERE labels LIKE '%0%'") for e in (card, cpu))
    batches = -(-EXPLORER_IMAGES // EXPLORER_BATCH)
    spread = 1.0 - min(ws.values())
    log(f"explorer: the flagship at {EXPLORER_IMGSZ}, {EXPLORER_IMAGES} images at batch "
        f"{EXPLORER_BATCH} ({emb.shape[1]}-d): card {card_s * 1e3 / EXPLORER_IMAGES:.2f} ms an "
        f"image, CPU {cpu_s * 1e3 / EXPLORER_IMAGES:.1f}; embeddings {err:.2e} of max |CPU| (tol "
        f"1e-4); get_similar(0) order held ({swaps} places swapped between ties within 1e-6; "
        f"similarities span 1 - {spread:.2e}); sql rows {len(rows)} equal "
        f"{rows == rows_cpu}; launches {launches}")
    if err > 1e-4 or not order_ok or rows != rows_cpu or not rows or \
            launches["dcn_forward"] != 3 * batches or any(
                v for k, v in launches.items() if k != "dcn_forward"):
        raise AssertionError(f"explorer: card vs CPU {err}, order {order_ok}, sql "
                             f"{len(rows)} / {len(rows_cpu)}, launches {launches}")
    return {"launches": launches, "err": err, "ms_per_image": card_s * 1e3 / EXPLORER_IMAGES}


def annotate_rows(model, folder: Path, out: Path, conf: float, counters) -> dict:
    """``auto_annotate`` of ``folder`` with ``model`` into ``out``, then each
    label file against ``model.predict`` of its image: box rows against the
    boxes' (cls, xywhn), polygon rows against each mask's polygon over the
    image's width and height, within 1e-3, in any order among rows that
    match (seeded scores tie). Returns its launches, rows and the rows
    found at another place."""
    import cv2
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch.data.annotator import auto_annotate

    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    auto_annotate(folder, model, out, conf=conf, imgsz=640)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    rows = moved = 0
    for img in sorted(folder.glob("*.jpg")):
        h, w = cv2.imread(str(img)).shape[:2]
        r = model.predict(str(img), conf=conf, imgsz=640)[0]
        if r.masks is not None:
            want = [np.concatenate([[c], (np.asarray(p, np.float64) / [w, h]).ravel()])
                    for c, p in zip(r.boxes.cls, r.masks.xy) if len(p) >= 3]
        else:
            want = list(np.concatenate([r.boxes.cls[:, None], r.boxes.xywhn], 1))
        got = [np.asarray(line.split(), np.float64)
               for line in (out / f"{img.stem}.txt").read_text().splitlines() if line.strip()]
        free = list(range(len(want)))
        for i, g in enumerate(got):  # rows whose scores tie may come in another order
            j = next((j for j in free if len(want[j]) == len(g) and g[0] == want[j][0]
                      and np.abs(g - want[j]).max() <= 1e-3), None)
            if j is None:
                near = min((np.abs(g - x).max() for x in want if len(x) == len(g)), default=None)
                raise AssertionError(f"auto_annotate: {img.name} row {i} ({len(g)} values) "
                                     f"matches none of its {len(want)} results within 1e-3 "
                                     f"(nearest {near})")
            free.remove(j)
            moved += j != i
        if len(got) != len(want):
            raise AssertionError(f"auto_annotate: {img.name}: {len(got)} rows for {len(want)}")
        rows += len(got)
    return {"launches": launches, "rows": rows, "moved": moved, "seconds": seconds}


def auto_annotate_phase(dev) -> dict:
    """``auto_annotate`` over 16 seeded JPEGs of the serving shapes with the
    flagship (box rows; class 0 in its cv3 at TRACK_PRIOR, conf 0.25) and
    with yolo11n-seg (polygon rows; ``task_model``: class 0 at P5 at 0.3,
    conf 0.25): each file's rows against its image's results within 1e-3
    (normalised), K4 once an image, K1 fwd 3 an image for the flagship."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import YOLO

    flagship = YOLO(FLAGSHIP, device=dev, imgsz=640, seed=0)
    with torch.no_grad():
        flagship.model.model[flagship.model.head_idx].cv3.bias[0] = logit(TRACK_PRIOR)
    seg = task_model("segment", dev)
    counters = kernel_counters()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_annotate_") as tmp:
        folder = serving_jpegs(Path(tmp) / "images", np.random.default_rng(13), ANNOTATE_IMAGES)
        for label, model in (("flagship", flagship), ("seg", seg)):
            model.predict(str(folder / "im00.jpg"), conf=0.25, imgsz=640)  # warm-up
            res = annotate_rows(model, folder, Path(tmp) / label, 0.25, counters)
            k1 = 3 * ANNOTATE_IMAGES if label == "flagship" else 0
            if res["launches"]["nms_suppress"] != ANNOTATE_IMAGES or \
                    res["launches"]["dcn_forward"] != k1 or not res["rows"]:
                raise AssertionError(f"auto_annotate ({label}): {res}")
            log(f"auto_annotate ({label}): {ANNOTATE_IMAGES} images in {res['seconds']:.2f} s, "
                f"{res['rows']} {'polygon' if label == 'seg' else 'box'} rows equal to the "
                f"results within 1e-3 ({res['moved']} at another place); launches "
                f"{res['launches']}")
            out[label] = res
    return out


def dota_scene(root: Path) -> None:
    """One seeded 4000 x 3000 scene in the DOTA layout (images/train,
    labels/train) with DOTA_LABELS rotated boxes of 20-150 px, normalised
    corners, classes of DOTA's 15."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(17)
    h, w = DOTA_SCENE
    (root / "images" / "train").mkdir(parents=True)
    (root / "labels" / "train").mkdir(parents=True)
    base = cv2.resize(rng.integers(0, 256, (h // 16, w // 16, 3), dtype=np.uint8), (w, h))
    rows = []
    for _ in range(DOTA_LABELS):
        cx, cy = rng.uniform(100, w - 100), rng.uniform(100, h - 100)
        bw, bh, a = rng.uniform(20, 150), rng.uniform(20, 100), rng.uniform(0, np.pi)
        c, s = np.cos(a), np.sin(a)
        pts = np.array([[-bw, -bh], [bw, -bh], [bw, bh], [-bw, bh]]) / 2 @ [[c, s], [-s, c]]
        pts += [cx, cy]
        cv2.fillPoly(base, [pts.astype(np.int32)], tuple(int(v) for v in rng.integers(0, 256, 3)))
        rows.append(f"{int(rng.integers(0, 15))} "
                    + " ".join(f"{v:.6g}" for v in (pts / [w, h]).ravel()))
    cv2.imwrite(str(root / "images" / "train" / "scene.jpg"), base)
    (root / "labels" / "train" / "scene.txt").write_text("\n".join(rows) + "\n")


def dota_tiles(dev) -> dict:
    """``split_images_and_labels`` of one seeded 4000 x 3000 scene with 20
    rotated labels at crop 1024, gap 200 (20 windows), then the tiles
    served by yolo11n-obb at 1024, batch 16. Held: every kept label's
    intersection over foreground with its window (recomputed from the
    tile's file) at least the split's 0.7, and every label that lies wholly
    inside a window written into that tile; K5 once a batch; the rotated
    detections finite."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch.data import split_dota

    model = obb_model(dev)
    counters = kernel_counters()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dota_") as tmp:
        root = Path(tmp)
        dota_scene(root / "dota")
        t0 = time.perf_counter()
        split_dota.split_images_and_labels(root / "dota", root / "tiles", "train",
                                           crop_sizes=(DOTA_CROP,), gaps=(DOTA_GAP,))
        split_s = time.perf_counter() - t0
        h, w = DOTA_SCENE
        windows = split_dota.get_windows((h, w), (DOTA_CROP,), (DOTA_GAP,))
        labels = np.loadtxt(root / "dota" / "labels" / "train" / "scene.txt", ndmin=2)
        corners = labels[:, 1:].reshape(-1, 4, 2) * [w, h]
        tiles = sorted((root / "tiles" / "images" / "train").glob("*.jpg"))
        kept = inside = 0
        for x0, y0, x1, y1 in windows:
            stem = f"scene__{DOTA_CROP}__{x0}___{y0}"
            text = (root / "tiles" / "labels" / "train" / f"{stem}.txt").read_text()
            rows = np.array([r.split() for r in text.splitlines() if r.strip()],
                            np.float64).reshape(-1, 9)
            kept += len(rows)
            if len(rows):
                iof = split_dota.bbox_iof(rows[:, 1:] * DOTA_CROP,
                                          np.array([[0, 0, DOTA_CROP, DOTA_CROP]], np.float64))
                if (iof < 0.7).any():
                    raise AssertionError(f"dota tiles: {stem} keeps a label at iof {iof.min()}")
            for i, c in enumerate(corners):
                if (c >= [x0, y0]).all() and (c <= [x1, y1]).all():
                    inside += 1
                    tile = (c - [x0, y0]) / DOTA_CROP
                    if not any(r[0] == labels[i, 0] and np.abs(r[1:] - tile.ravel()).max() < 1e-4
                               for r in rows):
                        raise AssertionError(f"dota tiles: label {i} inside {stem} is missing")
        if len(tiles) != len(windows) or not inside:
            raise AssertionError(f"dota tiles: {len(tiles)} tiles for {len(windows)} windows")
        model.predict([np.zeros((DOTA_CROP, DOTA_CROP, 3), np.uint8)] * 16, batch=16,
                      imgsz=OBB_IMGSZ, conf=0.001)  # warm-up
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        results = model.predict(source=str(tiles[0].parent), batch=16, imgsz=OBB_IMGSZ,
                                conf=0.001)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
    batches = -(-len(tiles) // 16)
    if len(results) != len(tiles) or launches["nms_rotated"] != batches or \
            any(v for k, v in launches.items() if k != "nms_rotated") or \
            not all(len(r.obb) and np.isfinite(r.obb.data).all() for r in results):
        raise AssertionError(f"dota tiles: {len(results)} results, launches {launches}")
    log(f"dota tiles: {w}x{h} scene, {DOTA_LABELS} labels, split at crop {DOTA_CROP} gap "
        f"{DOTA_GAP} into {len(tiles)} tiles in {split_s:.2f} s, {kept} labels kept (each iof >= "
        f"0.7, every one of {inside} wholly inside a window written there); served at batch 16, "
        f"{OBB_IMGSZ}: {len(tiles) / serve_s:.1f} tiles/s, "
        f"{np.mean([len(r.obb) for r in results]):.1f} rotated rows a tile; launches {launches}")
    return {"launches": launches, "tiles": len(tiles), "kept": kept}


def phase_periphery(dev, track: dict) -> dict:
    """The periphery's paths on the card (after ``phase_track``, whose
    ByteTrack rows the solutions read): native-loader serving, the solution
    apps, the explorer's embeddings, ``auto_annotate`` and the DOTA tiles.
    Returns {"paths": {path: launches}, ...}."""
    native = native_serving(dev)
    apps = solutions_on_tracks(track)
    explorer = explorer_embeddings(dev)
    annotate = auto_annotate_phase(dev)
    dota = dota_tiles(dev)
    return {"paths": {"native_serving_run": native["launches"],
                      "explorer_run": explorer["launches"],
                      "auto_annotate_flagship_run": annotate["flagship"]["launches"],
                      "auto_annotate_seg_run": annotate["seg"]["launches"],
                      "dota_tiles_run": dota["launches"]},
            "native": native, "solutions": apps}


def phase_classify(dev) -> dict:
    """yolo11n-cls on the card: the forward (softmax) of 64 images at 224
    in fp32, timed, against the CPU's (probabilities within 1e-4, the same
    top-5 but where the card's 5th and 6th lie within the measured
    difference: a rounding tie); ``ClassificationTrainer`` for 1 epoch on a
    seeded class-folder set (4 colours, 32 images each, at 224; batch 32: 4
    steps, ms a step); ``validate``'s top1 / top5 of the trained model on
    the card equal to the same model's on the CPU. No kernel runs on this
    path: the JAX package has no Pallas kernel on it either."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.data.synthetic import make_classify_dataset
    from yolo_ad_refine_tpu_torch.train.classify import ClassificationDataset, validate
    from yolo_ad_refine_tpu_torch.train.step import images_to_tensor

    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    model = YOLO(CLS_CFG, device=dev, imgsz=CLS_IMGSZ, seed=0)
    rng = np.random.default_rng(0)
    x = images_to_tensor(rng.integers(0, 256, (64, CLS_IMGSZ, CLS_IMGSZ, 3), dtype=np.uint8), dev)
    net = model.model.eval()
    with torch.inference_mode():
        ms = cuda_time(lambda: net(x), iters=10)
        probs = net(x).float().cpu()
        want = copy.deepcopy(net).cpu()(x.cpu())
    err = (probs - want).abs().max().item()
    top, ref = probs.argsort(-1, descending=True), want.argsort(-1, descending=True)
    ties = 0
    for i in range(64):
        if not torch.equal(top[i, :5], ref[i, :5]):
            gap = (probs[i, top[i, 4]] - probs[i, top[i, 5]]).item()
            if set(top[i, :5].tolist()) != set(ref[i, :5].tolist()) and gap > 2 * err:
                raise AssertionError(f"classify top-5 differs card vs CPU at image {i}")
            ties += 1
    log(f"classify: {CLS_CFG} ({model.model.num_params():,} parameters, nc 1000) forward + "
        f"softmax of 64 images at {CLS_IMGSZ}, fp32: {ms:.2f} ms a batch (CUDA events, mean of "
        f"10), {64 / ms * 1e3:.0f} images/s; card vs CPU max |prob diff| {err:.2e} (tol 1e-4), "
        f"top-5 equal on {64 - ties} of 64 (rounding ties {ties})")
    if probs.shape != (64, 1000) or err > 1e-4 or not torch.isfinite(probs).all():
        raise AssertionError(f"classify forward: shape {tuple(probs.shape)}, max diff {err:.2e}")
    steps, mark = [], {}

    def on_batch_start(tr):
        torch.cuda.synchronize()
        mark["t"] = time.perf_counter()

    def on_batch_end(tr):
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - mark["t"]) * 1e3)

    model.add_callback("on_train_batch_start", on_batch_start)
    model.add_callback("on_train_batch_end", on_batch_end)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_classify_") as tmp:
        data = make_classify_dataset(Path(tmp) / "cls", n_train=32, n_val=16, imgsz=CLS_IMGSZ)
        t0 = time.perf_counter()
        r = model.train(data=str(data), epochs=1, batch=32, imgsz=CLS_IMGSZ,
                        project=str(Path(tmp) / "runs"))
        wall = time.perf_counter() - t0
        step_ms = statistics.median(steps[1:])
        val_ds = ClassificationDataset(data / "val", CLS_IMGSZ)
        got = validate(model.model, val_ds, 16)
        ref = validate(copy.deepcopy(model.model).cpu(), val_ds, 16)
        reloaded = YOLO(str(Path(r["save_dir"]) / "weights" / "best"), device=dev)
    log(f"classify training: ClassificationTrainer, 1 epoch of 128 images at batch 32 "
        f"({len(steps)} steps, fp32) in {wall:.1f} s with its validation; steps "
        + ", ".join(f"{v:.1f}" for v in steps) + f" ms; {step_ms:.1f} ms a step (median of steps "
        f"2-4, host clock with a synchronise), {32 / step_ms * 1e3:.0f} images/s; top1 "
        f"{r['top1']:.3f}; validate on the card {got}, on the CPU {ref}")
    launches = {k: f.launches for k, f in counters.items()}
    if len(steps) != 4 or got != ref or reloaded.task != "classify" or any(launches.values()):
        raise AssertionError(f"classify training: {len(steps)} steps, card {got} vs CPU {ref}, "
                             f"reloaded as {reloaded.task}, launches {launches}")
    return {"paths": {"classify_run": launches}, "forward_ms_per_batch": ms,
            "ms_per_step": step_ms}


SERVE_BOX_TOL, SERVE_SCORE_TOL = 5e-2, 1e-3  # the serving limits, card vs CPU, fp32
BF16_STEP = 2.0 ** -8  # one bf16 step, relative: a bf16 program against the eager bf16 model


def phase_export(dev) -> dict:
    """The flagship (scale n, imgsz 640) exported at batch 32 through
    ``YOLO.export`` as ``torch_export`` and ``torchscript``, in fp32 and
    with ``half=True`` (bf16), and as ``torch_export`` under
    ``YAT_DCN_IMPL=pallas``; each artifact loaded by ``AutoBackend`` and run
    on 64 seeded images. Held: the decoded output against the eager model
    on the card (fp32 at the serving limits, boxes SERVE_BOX_TOL px and
    scores SERVE_SCORE_TOL; bf16 within BF16_STEP of the largest value
    against the eager model in bf16); the program's own DCN launches, 3 a
    batch of K1 fwd (K3 fwd for the ``pallas`` export) and no other DCN
    kernel; and ``DetectionValidator(backend=)`` over 20 images at batch 8
    (a final partial batch of 4) within 1e-3 of the same validation
    through the model. Printed: export and load seconds, images/s through
    each backend beside the eager model's (forward only, no NMS).
    Returns {path: launches}."""
    import cv2
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
    from yolo_ad_refine_tpu_torch.engine.exporter import AutoBackend, ExportedForward
    from yolo_ad_refine_tpu_torch.engine.validator import DetectionValidator

    counters = kernel_counters()

    def counts():
        return {k: f.launches for k, f in counters.items()}

    def zero():
        for f in counters.values():
            f.launches = 0

    def images_per_s(fns) -> list[float]:
        """Each callable's images/s over the 64 images in two batches of
        32: 4 timed runs each, taken in turns (a, b, b, a, ...) after a
        warm-up, median of each's runs."""
        runs = [[] for _ in fns]
        for fn in fns:
            fn(x[:32])
        torch.cuda.synchronize()
        for r in range(4):
            for j in (range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))):
                t0 = time.perf_counter()
                for i in (0, 32):
                    fns[j](x[i:i + 32])
                torch.cuda.synchronize()
                runs[j].append(64 / (time.perf_counter() - t0))
        return [statistics.median(r) for r in runs]

    paths, report = {}, {}
    model = YOLO(FLAGSHIP, device=dev, imgsz=640, seed=0)
    x = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (64, 640, 640, 3), dtype=np.uint8)).to(dev)
    cases = [("torch_export", False, None), ("torchscript", False, None),
             ("torch_export", True, None), ("torchscript", True, None),
             ("torch_export", False, "pallas")]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        for fmt, half, impl in cases:
            tag = f"{fmt}_{'bf16' if half else 'fp32'}" + (f"_{impl}" if impl else "")
            with dcn_env(impl):
                t0 = time.perf_counter()
                path = model.export(format=fmt, imgsz=640, batch=32, half=half,
                                    path=str(Path(tmp) / tag))
                export_s = time.perf_counter() - t0
                dtype = torch.bfloat16 if half else torch.float32
                eager = ExportedForward(copy.deepcopy(model.model).to(dtype), dtype).eval()
                with torch.inference_mode():
                    want = torch.cat([eager(x[i:i + 32].float()) for i in (0, 32)]).float()
            with dcn_env(None):  # the program keeps the DCN of its trace
                t0 = time.perf_counter()
                backend = AutoBackend(path, device=dev)
                load_s = time.perf_counter() - t0
                zero()
                y = torch.cat([backend(x[i:i + 32]) for i in (0, 32)]).float()
                torch.cuda.synchronize()
                run = counts()

            def eager_fn(b, eager=eager):
                with torch.inference_mode():
                    return eager(b.float())

            with dcn_env(impl):  # the eager model reads the variable at each forward
                rate, eager_rate = images_per_s([backend, eager_fn])
            dcn = {k: v for k, v in run.items() if k.startswith("dcn_")}
            fwd_k = "dcn_window_forward" if impl == "pallas" else "dcn_forward"
            box_err = (y[..., :4] - want[..., :4]).abs().max().item()
            score_err = (y[..., 4:] - want[..., 4:]).abs().max().item()
            rel = (y - want).abs().max().item() / want.abs().max().item()
            log(f"export {tag}: written in {export_s:.1f} s, loaded in {load_s:.1f} s "
                f"({backend.kind}, DCN {backend.meta['dcn_impl']} radius "
                f"{backend.meta['dcn_radius']}); 64 images: {rate:.1f} images/s through the "
                f"backend, {eager_rate:.1f} through the eager model (forward only, medians of "
                f"4 runs in turns); max |box diff| {box_err:.3e} px, |score diff| "
                f"{score_err:.3e}, relative "
                f"{rel:.3e}; launches {dcn}")
            if dcn != {**{k: 0 for k in dcn}, fwd_k: 6}:
                raise AssertionError(f"export {tag}: the loaded program did not launch {fwd_k} "
                                     f"3 times a batch and no other DCN kernel: {dcn}")
            if y.shape != (64, 8400, 84) or not torch.isfinite(y).all():
                raise AssertionError(f"export {tag}: bad output {tuple(y.shape)}")
            if half and rel > BF16_STEP:
                raise AssertionError(f"export {tag}: {rel:.3e} from the eager bf16 model")
            if not half and (box_err > SERVE_BOX_TOL or score_err > SERVE_SCORE_TOL):
                raise AssertionError(f"export {tag}: the program and the eager model disagree")
            paths[f"export_{tag}_run"] = run
            report[tag] = {"export_s": export_s, "load_s": load_s, "images_per_s": rate,
                           "eager_images_per_s": eager_rate}

        # standalone validation through a backend at batch 8, 20 images
        root = Path(tmp) / "shapes"
        data = make_shapes_dataset(root, n_train=1, n_val=20, imgsz=640, seed=9)
        files = sorted((root / "val" / "images").glob("*.jpg"))
        for f, r in zip(files, model.predict([cv2.imread(str(f)) for f in files], conf=0.001,
                                             batch=20)):
            (root / "val" / "labels" / f"{f.stem}.txt").write_text("".join(
                f"{int(c)} " + " ".join(f"{v:.6f}" for v in b) + "\n"
                for b, c in zip(r.boxes.xywhn[:3], r.boxes.cls[:3])))
        path = model.export(format="torch_export", imgsz=640, batch=8, half=False,
                            path=str(Path(tmp) / "val_b8"))
        backend = AutoBackend(path, device=dev)
        args = {"data": data, "imgsz": 640, "batch": 8, "conf": 0.001, "iou": 0.7,
                "max_det": 300, "task": "detect"}
        zero()
        got = DetectionValidator(dict(args))(backend=backend)
        torch.cuda.synchronize()
        run = counts()
        want = DetectionValidator(dict(args))(model=model.model)
    keys = ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
            "metrics/mAP50-95(B)", "fitness")
    log("export: backend validation, 20 images at batch 8 (3 batches, the last padded from 4): "
        + ", ".join(f"{k} {got[k]:.6f} (model {want[k]:.6f})" for k in keys)
        + f" (tol 1e-3); launches {run}")
    if run["dcn_forward"] != 9 or run["nms_suppress"] != 3:
        raise AssertionError(f"backend validation: expected 9 K1 fwd and 3 K4 launches: {run}")
    if want["metrics/mAP50(B)"] <= 0.05 or any(abs(got[k] - want[k]) > 1e-3 for k in keys):
        raise AssertionError("backend validation is vacuous or disagrees with the model's")
    paths["export_backend_val_run"] = run
    return {"paths": paths, "report": report}


def kernel_counters():
    """Every kernel wrapper, by the name of its entry in the kernels line."""
    from yolo_ad_refine_tpu_torch.ops import deform_mxu, deform_pallas
    from yolo_ad_refine_tpu_torch.ops.deform import dcn_backward, modulated_deform_conv2d
    from yolo_ad_refine_tpu_torch.ops.gather import gather_rows
    from yolo_ad_refine_tpu_torch.ops.lap import linear_sum_assignment
    from yolo_ad_refine_tpu_torch.ops.nms import suppress, suppress_rotated

    return {"dcn_forward": modulated_deform_conv2d, "dcn_backward": dcn_backward,
            "dcn_separable_forward": deform_mxu.dcn_separable_forward,
            "dcn_separable_backward": deform_mxu.dcn_separable_backward,
            "dcn_window_forward": deform_pallas.dcn_window_forward,
            "dcn_window_backward": deform_pallas.dcn_window_backward,
            "nms_suppress": suppress, "nms_rotated": suppress_rotated, "gather_rows": gather_rows,
            "linear_sum_assignment": linear_sum_assignment}


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


def serving_jpegs(folder: Path, rng=None, n: int = 64) -> Path:
    """n seeded JPEGs of the serving shapes (seeded noise, cv2's quality 95)
    in ``folder``, drawn from ``rng`` (default: the folder-serving phase's
    generator, seed 7)."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(7) if rng is None else rng
    folder.mkdir(parents=True)
    for i in range(n):
        h, w = SERVING_SHAPES[i % len(SERVING_SHAPES)]
        cv2.imwrite(str(folder / f"im{i:02d}.jpg"), rng.integers(0, 256, (h, w, 3), np.uint8))
    return folder


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
        folder = serving_jpegs(root / "images", rng)
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


def phase_training(dev, impl: str | None = None, cfg: str | dict = FLAGSHIP,
                   name: str | None = None):
    """YOLO(cfg).train on the card under YAT_DCN_IMPL=impl: 1 epoch of 4
    steps at batch 16, imgsz 640, bf16, then the EMA validation, checkpoints
    and a reload of best. Each step launches the variant's forward and
    backward kernel 3 times each (one a level) and no other DCN kernel.
    ``cfg`` FLAGSHIP_X trains the flagship at scale x, whose DCN backward
    (C = Cout = 384) runs K1 bwd's wide path; a model yaml's dict trains
    that model, ``name`` heading its log lines.
    Under ``pallas`` the reload also widens the radius: best's meta.yaml
    gets dcn_offset_max 11.5, the reloaded head must clip at 13, and one
    predict batch runs K3 at that radius."""
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset

    counters = kernel_counters()
    label = (impl or "auto") + ("" if cfg == FLAGSHIP else f", {name or cfg}")

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
    return launches, per_step, extra, ms


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


def phase_step_card_vs_cpu(dev, others: dict | None = None):
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
    from yolo_ad_refine_tpu_torch.models.model import build_detection_model
    from yolo_ad_refine_tpu_torch.train.loss import DetectionLoss

    base = build_detection_model(FLAGSHIP, nc=3, device="cpu", seed=3, imgsz=256)
    hold_step_card_vs_cpu("card vs CPU step", dev, base, step_batch(),
                          lambda: DetectionLoss(nc=3, strides=(8, 16, 32)), others)


def step_batch() -> dict:
    """The card-vs-CPU step's batch: 2 seeded images of 256², 3 classes,
    6 and 4 boxes."""
    import numpy as np

    r = np.random.default_rng(2)
    xy = r.uniform(0, 180, (2, 8, 2))
    boxes = np.concatenate([xy, xy + r.uniform(16, 70, (2, 8, 2))], -1).astype(np.float32)
    mask = (np.arange(8)[None, :, None] < np.array([[[6]], [[4]]])).astype(np.float32)
    return {"img": r.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8),
            "cls": r.integers(0, 3, (2, 8, 1)).astype(np.float32),
            "bboxes": boxes * mask, "mask": mask}


def hold_step_card_vs_cpu(name: str, dev, base, batch: dict, make_loss,
                          others: dict | None = None) -> None:
    """``phase_step_card_vs_cpu``'s hold for any model: one fp32 SGD step of
    ``base`` (a CPU model) on ``batch`` with the loss ``make_loss()`` on the
    card and on the CPU, held at its limits; ``name`` heads the log lines.
    ``others`` {label: (loss, gradients by parameter name, the same
    run's gradients on the CPU or None)}: more runs of the step
    (``phase_parallel``'s ranks), held at the same limits; a cancelling
    leaf of theirs against the larger of the CPU step's and the same run
    on the CPU's distance from fp64, where there is such a run (two ranks
    sum their halves: their fp32 rounding is not one process's)."""
    import torch

    from yolo_ad_refine_tpu_torch.train.optim import ModelEMA, build_optimizer
    from yolo_ad_refine_tpu_torch.train.step import TrainStep, images_to_tensor

    opt_kw = dict(optimizer="SGD", epochs=1, nb=1, batch=2, nbs=2, warmup_epochs=0.0,
                  nc=base.nc)

    def step(model):
        grads = {}
        for name, p in model.named_parameters():
            p.register_post_accumulate_grad_hook(
                lambda t, name=name: grads.__setitem__(name, t.grad.detach().double().cpu()))
        opt, _, _ = build_optimizer(model.named_parameters(), **opt_kw)
        m = TrainStep(model, make_loss(), opt, ModelEMA(model))(batch)
        return m["loss"].item(), grads

    loss_cpu, g_cpu = step(copy.deepcopy(base))
    m64 = copy.deepcopy(base).double().train()
    loss64 = make_loss()  # the task losses take the batch's masks or keypoints too
    out = loss64(m64(images_to_tensor(batch["img"], "cpu").double()),
                 *(torch.from_numpy(batch[k]) for k in ("cls", "bboxes", "mask",
                                                        *getattr(loss64, "extra_keys", ()))))
    out.total.backward()
    g64 = {n: p.grad.detach() for n, p in m64.named_parameters() if p.grad is not None}
    cpu_off = {n: (g - g64[n]).norm().item() for n, g in g_cpu.items()}
    cancels = {n for n, off in cpu_off.items() if off > LEAF_TOL / 4 * g64[n].norm().item()}

    def worst(grads, off):
        return max((((grads[n] - g64[n]).norm().item() / max(off[n], 1e-30), n)
                    for n in cancels), default=(0.0, "none"))

    def compare(label, loss, grads, cpu_same=None):
        """(loss rel, leaves over the limit, worst card / CPU distance from
        fp64 among the cancelling leaves), with the readings logged. With
        ``cpu_same``, the same step's gradients on the CPU (the ranks'
        step), a leaf's CPU distance is the larger of the two CPU steps';
        the ratio against the one-process CPU step alone is logged beside
        it, not held."""
        if set(grads) != set(g_cpu):
            raise AssertionError(f"{label}: card and CPU steps gave gradients to different "
                                 "parameters")
        rel = abs(loss - loss_cpu) / abs(loss_cpu)
        errs = sorted((((grads[n] - g).norm() / g.norm().clamp(min=1e-30)).item(), n)
                      for n, g in g_cpu.items() if n not in cancels)
        off = cpu_off if cpu_same is None else {
            n: max(cpu_off[n], (cpu_same[n] - g64[n]).norm().item()) for n in cancels}
        ratio = worst(grads, off)
        over = [f"{n}: {e:.2e}" for e, n in errs if e > LEAF_TOL]
        margin = LEAF_TOL / max(errs[-1][0], 1e-30)
        against = "|cpu - fp64|" if cpu_same is None else \
            "max(|cpu - fp64|, |cpu 2 ranks - fp64|)"
        one_cpu = "" if cpu_same is None else \
            "; against the one-process CPU alone, not held: {:.2f} ({})".format(
                *worst(grads, cpu_off))
        log(f"{label}: loss {loss:.6f} vs CPU {loss_cpu:.6f} (rel {rel:.2e}, tol 1e-4); "
            f"{len(errs)} leaves held at {LEAF_TOL} relative norm: {len(over)} over, worst "
            + ", ".join(f"{n} {e:.2e}" for e, n in errs[:-4:-1])
            + f" (margin {margin:.2f}x); {len(cancels)} cancelling leaves "
            f"against fp64: worst |card - fp64| / {against} {ratio[0]:.2f} ({ratio[1]}, "
            f"tol 4){one_cpu}")
        return rel, over, ratio[0]

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loss, grads = step(copy.deepcopy(base).to(dev))
        again = step(copy.deepcopy(base).to(dev))[1]
    log(f"{name}, deterministic algorithms; ops without a deterministic version: "
        + ", ".join(sorted({str(w.message).split(" does not have")[0].split(" defaults to")[0]
                            for w in caught if "deterministic" in str(w.message)})))
    rel, over, ratio = compare(f"{name}, fp32", loss, grads)
    log(f"{name}, cancelling leaves: |card - fp64| / |cpu - fp64| and, not held, the "
        "run-to-run spread |card - card again| / |cpu - fp64|: "
        + ", ".join(f"{n} {(grads[n] - g64[n]).norm().item() / max(cpu_off[n], 1e-30):.2f} "
                    f"{(grads[n] - again[n]).norm().item() / max(cpu_off[n], 1e-30):.2f}"
                    for n in sorted(cancels)))
    if rel > 1e-4:
        raise AssertionError(f"{name}: card and CPU train-step losses disagree")
    if over or ratio > 4:
        raise AssertionError(f"{name}: card and CPU gradients disagree: {over[:8]}, "
                             f"cancelling-leaf ratio {ratio:.2f}")
    for label, (loss, grads, cpu_same) in (others or {}).items():
        rel, over, ratio = compare(f"{name}, {label}", loss, grads, cpu_same)
        if rel > 1e-4 or over or ratio > 4:
            raise AssertionError(f"{name}, {label}: the step disagrees with the CPU's: loss rel "
                                 f"{rel:.2e}, leaves {over[:8]}, cancelling-leaf ratio {ratio:.2f}")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        compare(f"control, {name} with TF32 on", *step(copy.deepcopy(base).to(dev)))
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


def shapes_set(root: Path) -> Path:
    """The training phase's synthetic shapes set (64 train, 16 val images
    at 640, seed 0) as a data.yaml, for the CLI's ``data=``."""
    from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
    from yolo_ad_refine_tpu_torch.utils import yaml_save

    data = make_shapes_dataset(root / "shapes", n_train=64, n_val=16, imgsz=640, seed=0)
    yaml_save(root / "shapes.yaml", data)
    return root / "shapes.yaml"


def run_cli(*argv: str, timeout: int = 300) -> str:
    """``python -m yolo_ad_refine_tpu_torch <argv>`` from the checkout; raises
    with its output where it fails. Returns its standard output."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "yolo_ad_refine_tpu_torch", *argv],
                         cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                         timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"CLI {' '.join(argv[:2])} exited {out.returncode}:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    log(f"cli: {' '.join(a for a in argv if not a.startswith(('data=', 'project=')))} "
        f"ran in {time.perf_counter() - t0:.1f} s")
    return out.stdout


def phase_cli() -> dict:
    """The ``yat-torch`` command line in subprocesses (``python -m
    yolo_ad_refine_tpu_torch``), on the card by default: ``detect train``
    of the flagship at scale n, imgsz 640, batch 16 for 1 epoch (4 steps
    and the EMA validation) on the training phase's shapes set, then side
    by side ``val`` and ``predict`` (8 images, ``save_txt``) on its
    ``best``, and ``checks``.
    Held: results.csv's row and finite losses, ``weights/best``, the val
    metrics, an image and a label file for each predicted image, and the
    card and the five built kernels in ``checks``. Printed: each command's
    seconds and the train epoch's seconds over its 4 steps (the results.csv
    time: the steps, their first calls at the shape, and the validation).
    Returns the numbers."""
    import cv2
    import numpy as np

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        tmp = Path(tmp)
        data = shapes_set(tmp)
        t0 = time.perf_counter()
        run_cli("detect", "train", f"model={FLAGSHIP}", f"data={data}", "epochs=1", "batch=16",
                "imgsz=640", "plots=False", "workers=8", f"project={tmp / 'runs'}", "name=cli")
        train_s = time.perf_counter() - t0
        run = tmp / "runs" / "cli"
        csv = (run / "results.csv").read_text().splitlines()
        row = dict(zip(csv[0].split(","), csv[1].split(",")))
        losses = [float(row[k]) for k in ("train/box_loss", "train/cls_loss", "train/dfl_loss")]
        best = run / "weights" / "best"
        if len(csv) != 2 or not all(math.isfinite(v) for v in losses) or \
                not (best / "weights.pt").exists():
            raise AssertionError(f"CLI train: results.csv {csv}, best {best.exists()}")
        epoch_s = float(row["time"])
        log(f"cli train: 1 epoch of 4 steps at batch 16, imgsz 640, with its validation in "
            f"{epoch_s:.2f} s (results.csv), {epoch_s / 4 * 1e3:.0f} ms per step over that "
            f"epoch; losses box {losses[0]:.4f} cls {losses[1]:.4f} dfl {losses[2]:.4f}")
        src = tmp / "images"
        src.mkdir()
        rng = np.random.default_rng(5)
        for i, (h, w) in enumerate(SERVING_SHAPES[:8]):
            cv2.imwrite(str(src / f"im{i}.jpg"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        # val, predict and checks are light on the card: they run side by side
        with ThreadPoolExecutor(3) as pool:
            val = pool.submit(run_cli, "detect", "val", f"model={best}", f"data={data}",
                              "imgsz=640", "batch=16")
            predict = pool.submit(run_cli, "detect", "predict", f"model={best}", f"source={src}",
                                  "imgsz=640", "conf=0.001", "save_txt=True",
                                  f"project={tmp / 'pred'}")
            checks = pool.submit(run_cli, "checks")
            out, _, checks_out = val.result(), predict.result(), checks.result()
        if "'metrics/mAP50(B)'" not in out:
            raise AssertionError(f"CLI val printed no metrics:\n{out[-2000:]}")
        pred = tmp / "pred" / "predict"
        saved = sorted(p.name for p in pred.glob("*.jpg"))
        labels = sorted(p.stem for p in (pred / "labels").glob("*.txt"))
        if saved != [f"im{i}.jpg" for i in range(8)] or labels != [f"im{i}" for i in range(8)]:
            raise AssertionError(f"CLI predict saved {saved} and labels {labels}")
        built = [ln for ln in checks_out.splitlines()
                 if ln.startswith("kernel") and ": built" in ln]
        card = [ln for ln in checks_out.splitlines() if ln.startswith("cuda:0")]
        if len(built) != 5 or not card or "H100" not in card[0]:
            raise AssertionError(f"CLI checks did not report the card and 5 built kernels:\n"
                                 f"{checks_out}")
        log(f"cli checks: {card[0].strip()}; {len(built)} kernels built")
    return {"train_s": train_s, "epoch_s": epoch_s}


def phase_tune(dev) -> dict:
    """``YOLO(FLAGSHIP).tune(iterations=2)`` at scale n, imgsz 640, 1 epoch of
    4 steps at batch 16 each, on the training phase's shapes set. The
    Tuner scores an iteration whose training raises 0 and goes on, as the
    JAX package's does, so each iteration is held on its own: its
    ``DetectionTrainer.train`` returned (recorded by a wrapper around it),
    no "training failed" warning, its results.csv row with finite losses,
    its fitness row in tune_results.csv, and K1 fwd, K1 bwd and K4
    launched within it. Also held: best_hyperparameters.yaml and the best
    weights. Printed: seconds per iteration and each iteration's launches.
    Returns {"tune_run": launches of the whole, "iterations": [...],
    "seconds_per_iteration": s}."""
    import torch

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.train.trainer import DetectionTrainer
    from yolo_ad_refine_tpu_torch.utils import yaml_load

    counters = kernel_counters()
    train = DetectionTrainer.train
    per_iteration = []

    def counted_train(trainer):
        before = {k: f.launches for k, f in counters.items()}
        t0 = time.perf_counter()
        out = train(trainer)
        torch.cuda.synchronize()
        per_iteration.append({"seconds": time.perf_counter() - t0, "launches": {
            k: f.launches - before[k] for k, f in counters.items()}})
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as tmp:
        tmp = Path(tmp)
        data = shapes_set(tmp)
        model = YOLO(FLAGSHIP, device=dev, imgsz=640, seed=0)
        for f in counters.values():
            f.launches = 0
        DetectionTrainer.train = counted_train
        try:
            with log_records() as messages:
                t0 = time.perf_counter()
                best = model.tune(iterations=2, data=str(data), epochs=1, batch=16, imgsz=640,
                                  workers=8, project=str(tmp / "runs"))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            DetectionTrainer.train = train
        launches = {k: f.launches for k, f in counters.items()}
        failed = [m for m in messages if "training failed" in m]
        tune = tmp / "runs" / "tune"
        rows = (tune / "tune_results.csv").read_text().splitlines()
        fitness = [float(r.split(",")[0]) for r in rows[1:]]
        if failed or len(per_iteration) != 2 or len(rows) != 3 or \
                not all(math.isfinite(v) for v in fitness):
            raise AssertionError(f"tune: {len(per_iteration)} of 2 trainings returned; "
                                 f"failures {failed}; tune_results.csv {rows}")
        for i, it in enumerate(per_iteration, 1):
            csv = (tune / f"iter{i}" / "results.csv").read_text().splitlines()
            row = dict(zip(csv[0].split(","), csv[1].split(",")))
            losses = [float(row[k]) for k in ("train/box_loss", "train/cls_loss",
                                              "train/dfl_loss")]
            if len(csv) != 2 or not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"tune iteration {i}: results.csv {csv}")
            if not all(it["launches"][k] for k in ("dcn_forward", "dcn_backward",
                                                   "nms_suppress")):
                raise AssertionError(f"tune iteration {i} did not launch K1 fwd / bwd and K4: "
                                     f"{it['launches']}")
            log(f"tune iteration {i}: training {it['seconds']:.1f} s, fitness {fitness[i - 1]}, "
                f"losses {[round(v, 4) for v in losses]}, launches "
                f"{ {k: v for k, v in it['launches'].items() if v} }")
        if yaml_load(tune / "best_hyperparameters.yaml") != best or \
                not (tune / "weights" / "best" / "weights.pt").exists():
            raise AssertionError(f"tune wrote {sorted(p.name for p in tune.iterdir())}")
        log(f"tune: 2 iterations in {wall:.1f} s, {wall / 2:.1f} s per iteration (1 epoch of 4 "
            f"steps at batch 16, 640, and its validations); launches {launches}")
    return {"tune_run": launches, "iterations": per_iteration,
            "seconds_per_iteration": wall / 2}


def phase_benchmark(dev) -> dict:
    """``YOLO(FLAGSHIP).benchmark`` at batch 32, imgsz 640 for checkpoint,
    torch_export and torchscript (bf16 programs, the JAX default), each
    row ``ok`` with its ms per image; then ``model_flops`` at 640 for
    scale n and scale x. Returns the numbers."""
    import torch

    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.utils.benchmarks import model_flops

    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp:
        model = YOLO(FLAGSHIP, device=dev, imgsz=640, seed=0)
        t0 = time.perf_counter()
        rows = model.benchmark(imgsz=640, batch=32, save_dir=Path(tmp) / "export")
        wall = time.perf_counter() - t0
    if [r["status"] for r in rows] != ["ok"] * 3:
        raise AssertionError(f"benchmark rows: {rows}")
    for r in rows:
        log(f"benchmark: {r['format']}: {r['ms_per_image']:.3f} ms per image at batch 32, 640")
    flops = {"n": model_flops(model.model, 640)}
    x = YOLO(FLAGSHIP_X, device=dev, imgsz=640, seed=0)
    flops["x"] = model_flops(x.model, 640)
    del x
    torch.cuda.empty_cache()
    log(f"benchmark: {wall:.1f} s for the three formats; model_flops at 640: scale n "
        f"{flops['n']:.2f} GFLOPs, scale x {flops['x']:.2f} GFLOPs (FlopCounterMode: "
        "products and the DCN formula)")
    return {"rows": rows, "gflops": flops}


def phase_parallel(dev, one_process_ms: float) -> dict:
    """Data-parallel training on the one card (``tests/torch_parallel_worker.py``
    ranks with torchrun's environment): two ranks share the card over gloo
    with CUDA tensors (``parallel/multihost.py``), so every collective
    passes through the host and the times are no scaling figure. The
    two-rank runs share one start-up of the ranks, in this order:

    1. ``YOLO(FLAGSHIP).train`` on both ranks, DDP then FSDP2 (fsdp=True),
       global batch 16 (8 a rank), imgsz 640, bf16, 1 epoch of 4 steps on
       the training phase's shapes set, with rank 0's EMA validation: the
       ms of steps 2-4 beside the one-process step, finite losses, one
       save_dir, and each rank's K1 fwd / K1 bwd / K4 launches.
    2. One fp32 step with deterministic algorithms, on
       ``phase_step_card_vs_cpu``'s model and batch (global batch 2), by
       two DDP ranks and two FSDP2 ranks on the card, and the same two-rank
       DDP step on the CPU, whose halves round as theirs do.
    Then one DDP rank over NCCL takes the same step. Returns {"paths":
    {path: launches}, "steps": {label: (loss, grads, the CPU's two-rank
    grads or None)}, "ms": {...}, "seconds": {...}}: the card steps'
    losses and averaged gradients, which ``phase_step_card_vs_cpu`` holds
    at its limits."""
    import numpy as np
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_parallel_worker import run_ranks

    paths, ms, steps, seconds = {}, {}, {}, {}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        tmp = Path(tmp)
        data = shapes_set(tmp)
        r = np.random.default_rng(2)  # phase_step_card_vs_cpu's batch
        xy = r.uniform(0, 180, (2, 8, 2))
        boxes = np.concatenate([xy, xy + r.uniform(16, 70, (2, 8, 2))], -1).astype(np.float32)
        mask = (np.arange(8)[None, :, None] < np.array([[[6]], [[4]]])).astype(np.float32)
        batch = {"img": r.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8),
                 "cls": r.integers(0, 3, (2, 8, 1)).astype(np.float32),
                 "bboxes": boxes * mask, "mask": mask}
        np.savez(tmp / "step.npz", **{k: v[None] for k, v in batch.items()})
        step_spec = {"scenario": "step", "cfg": FLAGSHIP, "nc": 3, "seed": 3, "imgsz": 256,
                     "batches": str(tmp / "step.npz"), "deterministic": True,
                     "opt": dict(optimizer="SGD", epochs=1, nb=1, batch=2, nbs=2,
                                 warmup_epochs=0.0, nc=3)}
        kinds = ("ddp", "fsdp2")
        trains = [{"scenario": "train", "out": str(tmp / kind), "cfg": FLAGSHIP,
                   "train": {"data": str(data), "epochs": 1, "batch": 16, "imgsz": 640,
                             "amp": True, "plots": False, "workers": 4,
                             "fsdp": kind == "fsdp2", "project": str(tmp / "runs"),
                             "name": kind}} for kind in kinds]
        two_steps = {"DDP, 2 ranks (gloo)": ("ddp_2", "cuda", False),
                     "FSDP2, 2 ranks (gloo)": ("fsdp2_2", "cuda", True),
                     "CPU DDP, 2 ranks (gloo)": ("cpu_ddp_2", "cpu", False)}
        runs = trains + [{**step_spec, "out": str(tmp / tag), "device": device, "fsdp": fsdp}
                         for tag, device, fsdp in two_steps.values()]
        t0 = time.perf_counter()
        recs = run_ranks({"out": str(tmp / "two"), "timeout_s": 700, "device": "cuda",
                          "threads": 4, "runs": runs}, world=2)
        seconds["two_ranks"] = time.perf_counter() - t0
        if any(x["backend"] != "gloo" for rs in recs for x in rs):
            raise AssertionError(f"two ranks: backends {[[x['backend'] for x in rs] for rs in recs]}")
        for kind, rs in zip(kinds, recs):
            if len({x["results"]["save_dir"] for x in rs}) != 1:
                raise AssertionError(f"{kind}: ranks {[x['results'] for x in rs]}")
            csv = (Path(rs[0]["results"]["save_dir"]) / "results.csv").read_text().splitlines()
            row = dict(zip(csv[0].split(","), csv[1].split(",")))
            losses = [float(row[k]) for k in ("train/box_loss", "train/cls_loss", "train/dfl_loss")]
            if not all(math.isfinite(v) for v in losses) or any(len(x["ms"]) != 4 for x in rs):
                raise AssertionError(f"{kind}: losses {losses}, steps {[x['ms'] for x in rs]}")
            ms[kind] = [statistics.median(x["ms"][1:]) for x in rs]
            for x in rs:
                paths[f"parallel_{kind}_rank{x['rank']}_run"] = x["launches"]
                if not (x["launches"]["dcn_forward"] and x["launches"]["dcn_backward"]):
                    raise AssertionError(f"{kind} rank {x['rank']} launched {x['launches']}")
            if not rs[0]["launches"]["nms_suppress"]:
                raise AssertionError(f"{kind}: rank 0's validation launched no K4")
            log(f"parallel {kind}: 2 ranks on one card (gloo, CUDA tensors), global batch 16, "
                f"640, bf16: {ms[kind][0]:.1f} / {ms[kind][1]:.1f} ms per step (rank 0 / 1, "
                f"median of steps 2-4) beside {one_process_ms:.1f} ms one process; losses "
                f"{[round(v, 4) for v in losses]}; launches {[x['launches'] for x in rs]}")

        def step_result(label, tag, rs):
            grads = torch.load(tmp / tag / "state.pt")["grads"]
            log(f"parallel {label}: fp32 step loss {rs[0]['loss'][0]:.6f}, {len(grads)} "
                f"gradient leaves; launches {[x['launches'] for x in rs]}")
            return rs[0]["loss"][0], grads

        results = dict(zip(two_steps, recs[len(trains):]))
        cpu_two = step_result("CPU DDP, 2 ranks (gloo)", "cpu_ddp_2",
                              results.pop("CPU DDP, 2 ranks (gloo)"))[1]
        for label, rs in results.items():
            tag = two_steps[label][0]
            steps[label] = (*step_result(label, tag, rs), cpu_two)
            for x in rs:
                paths[f"parallel_{tag}_fp32_step_rank{x['rank']}"] = x["launches"]
        log(f"parallel: the two-rank runs (2 trainings, 3 fp32 steps) in "
            f"{seconds['two_ranks']:.1f} s with one start-up of the ranks")

        t0 = time.perf_counter()
        rs = run_ranks({**step_spec, "out": str(tmp / "ddp_1"), "timeout_s": 300,
                        "device": "cuda", "threads": 4}, world=1)
        seconds["nccl_rank"] = time.perf_counter() - t0
        if rs[0]["backend"] != "nccl":
            raise AssertionError(f"one rank over {rs[0]['backend']}, not NCCL")
        steps["DDP, 1 rank (NCCL)"] = (*step_result("DDP, 1 rank (NCCL)", "ddp_1", rs), None)
        paths["parallel_ddp_1_fp32_step_rank0"] = rs[0]["launches"]
    return {"paths": paths, "steps": steps, "ms": ms, "seconds": seconds}


def log_ptxas(report: dict) -> None:
    """The register and spill lines of each kernel build's ptxas report."""
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def timed(phase, *args, **kw):
    """``phase(*args, **kw)``, its seconds logged beside the host CPU seconds
    that it and its child processes took (a phase that needs many CPU
    seconds a second slows most where the card's host is shared); then the
    allocator's cache emptied, and a failed second half raised."""
    import torch

    t0, c0 = time.perf_counter(), os.times()
    out = phase(*args, **kw)
    c1 = os.times()
    cpu = sum(b - a for a, b in zip(c0[:4], c1[:4]))
    log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s (host CPU {cpu:.1f} s)")
    torch.cuda.empty_cache()  # the two halves share the card's memory
    check_second_half()
    return out


def main() -> int:
    t_start = time.perf_counter()
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
    start_second_half()

    # deform_window.cu takes nvcc the longest: it builds on beside the K1 phases, which
    # need only the others
    t0 = time.perf_counter()
    builder = ThreadPoolExecutor(1)
    window = builder.submit(kernels.build, "deform_window")
    report = kernels.build("deform_conv", "gather", "lap", "nms")
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (parallel nvcc): "
        + ", ".join(f"{n} {r['seconds']:.1f} s" for n, r in report.items())
        + "; deform_window builds on beside phase_k1 and phase_k1_bwd")
    log_ptxas(report)

    gen = torch.Generator().manual_seed(0)
    with dcn_env(None):  # each phase sets the DCN variant it drives
        # the kernels' own phases, with the card to themselves
        k1 = timed(phase_k1, dev, gen)
        k1b = timed(phase_k1_bwd, dev, gen)
        t1 = time.perf_counter()
        window_report = window.result()
        builder.shutdown()
        log(f"deform_window built {time.perf_counter() - t0:.1f} s after the build began "
            + (f"(nvcc {window_report['deform_window']['seconds']:.1f} s), "
               if window_report else "(already built), ")
            + f"waited for {time.perf_counter() - t1:.1f} s")
        log_ptxas(window_report)
        k1_wide = timed(phase_k1_wide, dev, gen)
        k4 = timed(phase_k4, dev, gen)
        bounded = {impl: timed(phase_bounded, dev, gen, impl) for impl in BOUNDED}
        gather, gather_run = timed(phase_gather, dev)
        obb = timed(obb_model, dev)
        k5 = timed(phase_k5, dev, gen, obb)
        # then the paths, in two halves side by side: this process's, and second_half's;
        # the CPU-reference worker starts only now, so the kernels' times above are
        # taken with the host's cores to themselves
        start_cpu_references()
        tell_second_half("go")
        paths = {"gather_probe_run": gather_run, "serving_run": timed(phase_serving, dev)}
        paths["folder_serving_run"], folder_rates = timed(phase_folder_serving, dev)
        for impl in ("mxu", "pallas", "mxu2"):
            paths[f"serving_{impl}_run"] = timed(phase_serving_variant, dev, impl)
        for impl in (None, "mxu", "pallas"):
            tag = "" if impl is None else f"_{impl}"
            run, step, extra, ms = timed(phase_training, dev, impl)
            paths.update({f"training{tag}_run": run, f"training{tag}_step": step, **extra})
            if impl is None:
                tell_second_half(repr(ms))  # phase_parallel's one-process step
        run, step, _, _ = timed(phase_training, dev, None, FLAGSHIP_X)
        paths.update({"training_x_run": run, "training_x_step": step})
        paths["obb_serving_run"] = timed(phase_obb_serving, obb, dev)
        paths["obb_val_run"] = timed(phase_obb_val, obb, dev)
        obb_training = timed(phase_obb_training, dev)
        paths["obb_training_run"] = obb_training["obb_training_run"]
        paths.update(timed(phase_segment, dev)["paths"])
        paths.update(timed(phase_pose, dev)["paths"])
        paths.update(timed(phase_classify, dev)["paths"])
        paths.update(timed(phase_v10, dev)["paths"])
        world = timed(phase_world, dev)
        paths.update(world["paths"])
        paths.update(timed(phase_zoo, dev)["paths"])
        rtdetr = timed(phase_rtdetr, dev)
        paths.update(rtdetr["paths"])
        track = timed(phase_track, dev)
        paths.update(track["paths"])
        paths.update(timed(phase_periphery, dev, track)["paths"])
        sam = timed(phase_sam, dev)
        paths.update(sam["paths"])
        timed(phase_benchmark, dev)
        paths.update(join_second_half()["paths"])

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
              device_ms=k4["device_ms"], parts=k4["parts"], predict_batch=k4["predict_batch"],
              world_batches=world["k4"], track_frame=track["k4"], track_frames=TRACK_FRAMES,
              sam_family=sam["k4"]),
        entry("nms_rotated", "nms.cu", "ops/nms_pallas.py:81", k5, "obb_serving_run",
              device_ms=k5["device_ms"], parts=k5["parts"], predict_batch=k5["predict_batch"],
              rounding_ties=k5["rounding_ties"]),
        entry("gather_rows", "gather.cu", "benchmarks/bench_dcn.py:103", {
            "max_abs_err": gather["max_abs_err"], **gather["bfloat16"]["total"],
            "bound_by": "bytes"}, "gather_probe_run", dtype="bfloat16",
            float32={**gather["float32"]["total"], "bound_by": "bytes"},
            levels={n: gather[n]["levels"] for n in ("bfloat16", "float32")}),
        entry("linear_sum_assignment", "lap.cu", "ops/lap.py:29", rtdetr["lap"],
              "rtdetr_training_run", matrices=[rtdetr["lap"][k] for k in ("B", "M", "N")],
              scans=rtdetr["lap"]["scans"], synthetic=rtdetr["lap"]["synthetic"],
              ms_in_step=rtdetr["lap_ms_per_step"], step_ms=rtdetr["ms_per_step"]),
    ]}
    for k in kernels_line["kernels"]:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was not launched on its main path {k['main_path']}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def second_half(result: str) -> int:
    """The phases that run beside the first half's, in a process of their own
    (``start_second_half``): the module library, export, the command line,
    tune, the training options, the two ranks and the card vs CPU step.
    It sets up, waits for ``go`` on its standard input, later reads there
    the one-process step's ms for ``phase_parallel``, and writes {"paths":
    {path: launches}} to ``result``."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = "cuda"
    torch.zeros(1, device=dev)  # the context, while the first half builds the kernels
    if sys.stdin.readline().strip() != "go":
        return 1
    paths = {}
    with dcn_env(None):
        paths.update(timed(phase_module_library, dev)["paths"])
        paths.update(timed(phase_export, dev)["paths"])
        timed(phase_cli)
        paths["tune_run"] = timed(phase_tune, dev)["tune_run"]
        paths.update(timed(phase_training_options, dev)["paths"])
        parallel = timed(phase_parallel, dev, float(sys.stdin.readline()))
        paths.update(parallel["paths"])
        timed(phase_step_card_vs_cpu, dev, parallel["steps"])
    with open(result, "wb") as f:
        pickle.dump({"paths": paths}, f)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--second-half"]:
        sys.exit(second_half(sys.argv[2]))
    if sys.argv[1:2] == ["--cpu-references"]:
        sys.exit(cpu_references(sys.argv[2]))
    try:
        code = main()
    finally:
        stop_second_half()
        stop_cpu_references()
    sys.exit(code)
