"""Ranks of a data-parallel run of the PyTorch port, started as processes.

``run_ranks(spec, world)`` starts ``world`` processes of this file, each with
the launcher's environment torchrun would give it (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT on a free localhost
port), waits for them within ``spec["timeout_s"]`` and returns what each
rank wrote. A rank creates the process group itself, with that timeout,
and runs one of two scenarios:

- ``step``: ``spec["steps"]`` train steps of a model (its yaml, nc, imgsz,
  seed, or the state dict in ``spec["weights"]``) on the global batches in
  ``spec["batches"]`` (an .npz of img, cls, bboxes, mask and a segment
  batch's masks or a pose batch's keypoints, stacked by step), with the
  loss of the model's task,
  each rank on its slice, wrapped in DDP or FSDP2 (``fsdp``) through
  ``parallel.wrap_model``. Rank 0 writes the losses, components, the first
  step's gradients as the optimizer reads them (averaged over the ranks,
  before the clip), the parameters, BN statistics and EMA after each
  step, in the one-process layout; every rank writes its local statistics
  (the first BatchNorm's batch mean and target_scores_sum on its own
  slice, before any sync), its step times and its kernel launch counts;
- ``train``: ``YOLO(cfg).train(**spec["train"])`` on every rank, which
  starts the ranks' trainer (``train/trainer.py``); each rank writes the
  results, its step times and its kernel launch counts.

Imports torch and the port only: ``chip_smoke.py`` drives it on the card
(two ranks sharing one card over gloo, and one rank over NCCL), the CPU
tests through gloo.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(spec: dict, world: int, local_world: int | None = None) -> list:
    """Run ``world`` ranks of ``spec`` (``spec["out"]`` a directory) and return
    each rank's JSON record; raises, with the ranks' output, when one fails
    or the whole outlasts ``spec["timeout_s"]``. ``spec["runs"]``, a list
    of specs over ``spec``'s keys (each with its own ``out``), runs them in
    turn in the same ranks, one start-up for all; the records then come as
    a list a run. A run's ``device`` may differ from the first's: under
    gloo (ranks on the CPU, or sharing a card) a run on the CPU shares the
    ranks of runs on the card."""
    out = Path(spec["out"])
    out.mkdir(parents=True, exist_ok=True)
    (out / "spec.json").write_text(json.dumps(spec))
    port = free_port()
    procs = []
    for r in range(world):
        env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r),
               "LOCAL_WORLD_SIZE": str(local_world or world), "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port), "PYTHONPATH": str(REPO)}
        log = open(out / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, __file__, str(out / "spec.json")],
                                       cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT),
                      log))
    deadline = time.monotonic() + float(spec["timeout_s"])
    try:
        for p, _ in procs:
            p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
            p.communicate()
        raise
    finally:
        for _, log in procs:
            log.close()
    logs = [(out / f"rank{r}.log").read_text() for r in range(world)]
    rcs = [p.returncode for p, _ in procs]
    if any(rcs):
        raise RuntimeError(f"ranks exited {rcs}:\n" + "\n".join(
            f"--- rank {r} ---\n{t[-4000:]}" for r, t in enumerate(logs)))
    recs = [[json.loads((Path(run["out"]) / f"rank{r}.json").read_text()) for r in range(world)]
            for run in runs_of(spec)]
    return recs if "runs" in spec else recs[0]


def runs_of(spec: dict) -> list[dict]:
    return [{**spec, **run} for run in spec["runs"]] if "runs" in spec else [spec]


def kernel_counters() -> dict:
    from yolo_ad_refine_tpu_torch.ops.deform import dcn_backward, modulated_deform_conv2d
    from yolo_ad_refine_tpu_torch.ops.nms import suppress

    return {"dcn_forward": modulated_deform_conv2d, "dcn_backward": dcn_backward,
            "nms_suppress": suppress}


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_step(spec: dict, rank: int, device) -> dict:
    import numpy as np
    import torch

    from yolo_ad_refine_tpu_torch.models.model import build_detection_model
    from yolo_ad_refine_tpu_torch.parallel import full_tensor, wrap_model
    from yolo_ad_refine_tpu_torch.parallel.multihost import per_host_batch_slice
    from yolo_ad_refine_tpu_torch.train.loss import DetectionLoss
    from yolo_ad_refine_tpu_torch.train.obb import OBBLoss
    from yolo_ad_refine_tpu_torch.train.optim import ModelEMA, build_optimizer
    from yolo_ad_refine_tpu_torch.train.pose import PoseLoss
    from yolo_ad_refine_tpu_torch.train.segment import SegmentationLoss
    from yolo_ad_refine_tpu_torch.train.step import TrainStep

    if spec.get("deterministic"):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
    data = np.load(spec["batches"])
    steps = int(spec.get("steps", 1))
    model = build_detection_model(spec["cfg"], nc=spec["nc"], device=device,
                                  seed=int(spec.get("seed", 0)), imgsz=spec["imgsz"])
    if spec.get("weights"):
        model.load_state_dict(torch.load(spec["weights"], map_location=device))
    if spec.get("float64"):  # no fp32 rounding: the ranks' step against one process's exactly
        model.double()
    head = model.model[model.head_idx]
    loss_fn = {"obb": OBBLoss, "segment": SegmentationLoss,
               "pose": lambda **k: PoseLoss(kpt_shape=head.kpt_shape, **k)}.get(
        model.task, DetectionLoss)(nc=model.nc, strides=model.strides)
    local = {}
    det = getattr(loss_fn, "det", loss_fn)  # the segment and pose losses' detection loss
    assign = det.assigner

    def assigner(*a, **k):  # this rank's target_scores_sum, before the loss syncs it
        res = assign(*a, **k)
        local.setdefault("target_scores_sum", float(res.target_scores.sum()))
        return res

    det.assigner = assigner

    def bn0_input(module, args, out):  # the first BatchNorm's input on this rank's slice
        local.setdefault("bn0_local_mean", out.detach().float().mean(dim=(0, 2, 3)).tolist())

    model.model[0].conv.register_forward_hook(bn0_input)
    opt, _, _ = build_optimizer(model.named_parameters(), **spec["opt"])
    ema = ModelEMA(model)
    wrapped = wrap_model(model, int(data["img"].shape[1]), fsdp=bool(spec.get("fsdp")),
                         optimizer=opt)
    names = [n for n, _ in model.named_parameters()]
    grads = {}
    step_opt = opt.step

    def record_then_step():
        if not grads and (opt.batches + 1) % opt.accumulate == 0:
            for n, p in zip(names, model.parameters()):
                if p.grad is not None:
                    grads[n] = full_tensor(p.grad).detach().double().cpu()
        return step_opt()

    opt.step = record_then_step
    amp = torch.bfloat16 if spec.get("amp") else None
    train_step = TrainStep(model, loss_fn, opt, ema, amp, wrapped=wrapped)
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    _, start, stop = per_host_batch_slice(int(data["img"].shape[1]))
    losses, comps, ms, states = [], [], [], []
    for s in range(steps):
        batch = {k: data[k][s, start:stop] for k in data.files}  # with a task's masks, keypoints
        sync(device)
        t0 = time.perf_counter()
        m = train_step(batch)
        sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        comps.append(m["components"].double().cpu().tolist())
        states.append({"state": {k: full_tensor(v).detach().cpu().clone()
                                 for k, v in model.state_dict().items()},
                       "ema": {k: v.detach().cpu().clone()
                               for k, v in ema.ema.state_dict().items()}})
    if rank == 0:
        torch.save({"grads": grads, "states": states}, Path(spec["out"]) / "state.pt")
    return {"loss": losses, "components": comps, "ms": ms, **local,
            "launches": {k: f.launches for k, f in counters.items()},
            "ema_updates": ema.updates, "wrapper": type(wrapped).__name__,
            "grads_sharded": type(next(model.parameters())).__name__}


def run_train(spec: dict, rank: int, device) -> dict:
    from yolo_ad_refine_tpu_torch import YOLO

    counters = kernel_counters()
    ms, mark = [], {}

    def start(trainer):
        sync(device)
        mark["t"] = time.perf_counter()

    def end(trainer):
        sync(device)
        ms.append((time.perf_counter() - mark["t"]) * 1e3)

    model = YOLO(spec["cfg"], device=str(device), imgsz=spec["train"]["imgsz"],
                 seed=int(spec.get("seed", 0)))
    model.add_callback("on_train_batch_start", start)
    model.add_callback("on_train_batch_end", end)
    for f in counters.values():
        f.launches = 0
    results = model.train(**spec["train"])
    return {"results": {k: v for k, v in results.items() if isinstance(v, (int, float, str))},
            "ms": ms, "launches": {k: f.launches for k, f in counters.items()},
            "device": str(next(model.model.parameters()).device)}


def main(spec_file: str) -> None:
    import torch

    from yolo_ad_refine_tpu_torch.parallel.multihost import maybe_initialize_distributed
    from yolo_ad_refine_tpu_torch.utils import select_device

    spec = json.loads(Path(spec_file).read_text())
    torch.set_num_threads(int(spec.get("threads", 2)))
    maybe_initialize_distributed(select_device(spec.get("device", "cuda")),
                                 timeout=timedelta(seconds=float(spec["timeout_s"])))
    rank = torch.distributed.get_rank()
    for run in runs_of(spec):
        scenario = {"step": run_step, "train": run_train}[run["scenario"]]
        Path(run["out"]).mkdir(parents=True, exist_ok=True)
        device = select_device(run.get("device", "cuda"))
        record = {"rank": rank, "backend": torch.distributed.get_backend(),
                  "device": str(device), **scenario(run, rank, device)}
        (Path(run["out"]) / f"rank{rank}.json").write_text(json.dumps(record))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main(sys.argv[1])
