"""Multi-process runtime: the process group and the host-level agreements.

Counterpart of ``yolo_ad_refine_tpu/parallel/multihost.py`` (reference
utils/dist.py, trainer.py:217-228 and :403-406 / :462-465). Where the JAX
package wires one process per host into one runtime, here there is one
process per GPU, as ``torchrun`` starts them, joined by
``torch.distributed``:

- ``maybe_initialize_distributed`` creates the default process group from
  torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``) or from the JAX
  package's contract (``YAT_COORDINATOR`` host:port, ``YAT_NUM_PROCESSES``,
  ``YAT_PROCESS_ID``), so a TPU user's launch script starts the same run.
  There each process covers every device of its host; here a process
  drives one card, so under the ``YAT_*`` variables on a host of several
  cards each process needs its ``LOCAL_RANK`` (torchrun sets it), and
  without it the run raises rather than train on one card of the host;
- the backend follows the devices: NCCL when every rank has a card of its
  own, gloo on the CPU, and gloo with CUDA tensors when ranks share a card
  (``LOCAL_WORLD_SIZE`` above the card count; NCCL refuses two ranks on
  one device). A failing NCCL initialisation raises: nothing falls back;
- each rank loads its contiguous slice of the global batch
  (``per_host_batch_slice``), and rank 0 writes the run's files
  (``is_main_process``); the stop decision and the fitness are agreed with
  ``all_agree_stop`` and ``broadcast_scalar``.

Without a launcher's environment nothing is initialised and every helper
answers for one process.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from yolo_ad_refine_tpu_torch.utils import LOGGER


def launcher_env() -> dict | None:
    """{launcher, rank, world_size, local_rank, local_world_size,
    init_method} from torchrun's or the JAX package's variables; None
    without either."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return {"launcher": "torchrun", "rank": int(os.environ["RANK"]),
                "world_size": int(os.environ["WORLD_SIZE"]),
                "local_rank": int(os.environ.get("LOCAL_RANK", 0)),
                "local_world_size": int(os.environ.get("LOCAL_WORLD_SIZE", 1)),
                "init_method": "env://"}
    if os.environ.get("YAT_COORDINATOR") and os.environ.get("YAT_NUM_PROCESSES"):
        return {"launcher": "YAT", "rank": int(os.environ.get("YAT_PROCESS_ID", 0)),
                "world_size": int(os.environ["YAT_NUM_PROCESSES"]),
                "local_rank": int(os.environ.get("LOCAL_RANK", 0)),
                "local_world_size": int(os.environ.get("LOCAL_WORLD_SIZE", 1)),
                "init_method": f"tcp://{os.environ['YAT_COORDINATOR']}"}
    return None


def backend_for(device: torch.device, local_world_size: int) -> tuple[str, str]:
    """(backend, reason) for ranks on ``device``."""
    if device.type != "cuda":
        return "gloo", f"ranks on {device.type}"
    n = torch.cuda.device_count()
    if local_world_size > n:
        return "gloo", (f"{local_world_size} ranks share {n} card(s) (NCCL takes one rank a "
                        "card): gloo with CUDA tensors, every collective through the host")
    return "nccl", f"one card a rank ({local_world_size} ranks, {n} cards)"


def maybe_initialize_distributed(device: torch.device,
                                 timeout: timedelta = timedelta(minutes=30)) -> bool:
    """Create the default process group when a launcher asked for one and
    it does not exist yet. Returns True when running in a process group."""
    if dist.is_initialized():
        return True
    env = launcher_env()
    if env is None:
        return False
    if (env["launcher"] == "YAT" and "LOCAL_RANK" not in os.environ
            and device.type == "cuda" and torch.cuda.device_count() > 1):
        raise RuntimeError(
            f"YAT_NUM_PROCESSES={env['world_size']}: under the JAX package a process covers "
            f"every device of its host; the port runs one process a card, and this host has "
            f"{torch.cuda.device_count()}. Launch one process a card with torchrun "
            "--nproc_per_node=<cards>, or give each process LOCAL_RANK and LOCAL_WORLD_SIZE "
            "and YAT_NUM_PROCESSES the count of all processes")
    backend, why = backend_for(device, env["local_world_size"])
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=env["init_method"], rank=env["rank"],
                            world_size=env["world_size"], timeout=timeout)
    LOGGER.info(f"distributed: rank {env['rank']}/{env['world_size']} (local "
                f"{env['local_rank']}/{env['local_world_size']}) on {device}, {backend}: {why}")
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """The rank that writes checkpoints, plots and results (reference RANK
    in {-1, 0} gating)."""
    return rank() == 0


def per_host_batch_slice(global_batch: int) -> tuple[int, int, int]:
    """(rank_batch, start, stop): this rank's contiguous slice of the global
    batch, the DistributedSampler replacement (reference data/build.py:127).
    Raises where the world size does not divide the batch."""
    n, i = world_size(), rank()
    if global_batch % n:
        raise ValueError(f"the global batch {global_batch} must divide by the world size {n}")
    hb = global_batch // n
    return hb, i * hb, (i + 1) * hb


def _device() -> torch.device:
    """The device collectives of the default group run on."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_agree_stop(stop: bool) -> bool:
    """Any rank voting stop stops everyone (reference trainer.py:462-465,
    here a max-reduction, as the JAX package's)."""
    if world_size() == 1:
        return stop
    t = torch.tensor([int(stop)], device=_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def all_reduce_max(value: float) -> float:
    """The maximum of a host scalar over the ranks."""
    if world_size() == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def broadcast_scalar(value: float, root: int = 0) -> float:
    """The root rank's host scalar on every rank (reference trainer.py:267)."""
    if world_size() == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=_device())
    dist.broadcast(t, src=root)
    return float(t.item())


def broadcast_object(obj, root: int = 0):
    """The root rank's picklable object on every rank (the run's save_dir)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root, device=_device())
    return box[0]


def sync_hosts() -> None:
    """Barrier (reference torch_distributed_zero_first)."""
    if world_size() > 1:
        dist.barrier(device_ids=[torch.cuda.current_device()]
                     if dist.get_backend() == "nccl" else None)
