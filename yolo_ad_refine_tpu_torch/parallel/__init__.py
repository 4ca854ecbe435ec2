"""Data-parallel training over the ranks of a process group: DDP or FSDP2.

Counterpart of ``yolo_ad_refine_tpu/parallel/__init__.py``. The JAX package
jits one train step over a 1-D 'data' mesh: the batch is sharded, the state
replicated (or, with ``fsdp=True``, each large leaf sharded) and XLA
computes exactly the one-device step over the global batch. Here each rank
is a process with its slice of the global batch (``multihost``), and the
same global math is kept by hand:

- ``wrap_model`` wraps the model in DistributedDataParallel (``fsdp=False``)
  or FSDP2 (``fully_shard`` over each layer of ``model.model``, then the
  root), after checking that the world size divides the global batch;
- ``global_batch()``, the one switch, is set by the train step
  (``train/step.py``) around the wrapped forward and the loss. Under it the
  train-mode BatchNorm (``nn/common.py``) takes its statistics over the
  global batch and the losses (``train/loss.py``, ``train/obb.py``) their
  normalisers, through ``all_reduce_sum``; MLCA (``nn/block.py``), whose
  global branch averages over the batch, sees the global batch's through
  ``all_gather_cat``. Any other forward (rank 0's validation, autobatch's
  probe) stays this rank's own;
- DDP and FSDP2 average the gradients over the ranks; the losses multiply
  their gradient by the world size, once, to make that average the global
  batch's sum;
- ``full_tensor`` and ``shard_like`` move FSDP2's sharded state to and from
  the one-process layout (EMA, clip norm, checkpoints). They use the
  process group's own all-gather: DTensor's ``full_tensor`` ends in a
  segmentation fault under gloo with CUDA tensors (torch 2.11, two ranks on
  one H100), which is how one card runs two ranks.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import nn

from yolo_ad_refine_tpu_torch.parallel.multihost import per_host_batch_slice, world_size


def group_active() -> bool:
    """True when a process group of more than one rank is running."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


_GLOBAL_BATCH = False


@contextlib.contextmanager
def global_batch(on: bool = True):
    """Within the block, when ``on`` and a group of more than one rank is
    running, the forward and the loss compute the global batch's
    statistics (``in_global_batch``)."""
    global _GLOBAL_BATCH
    prev, _GLOBAL_BATCH = _GLOBAL_BATCH, on and group_active()
    try:
        yield
    finally:
        _GLOBAL_BATCH = prev


def in_global_batch() -> bool:
    """True inside ``global_batch()`` under a group of more than one rank."""
    return _GLOBAL_BATCH


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of the default group, as a new tensor
    outside the autograd graph (the sums the step takes are of detached
    statistics, or inside ``nn/common.py``'s batch norm function)."""
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


class _AllGatherCat(torch.autograd.Function):
    """The ranks' tensors concatenated on dim 0 (equal shapes); the
    backward sums the cotangents over the ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, t):
        n = world_size()
        out = t.new_empty((t.shape[0] * n, *t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous())
        ctx.rows = (dist.get_rank() * t.shape[0], t.shape[0])
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g.narrow(0, *ctx.rows)


def all_gather_cat(t: torch.Tensor) -> torch.Tensor:
    """The global batch of a per-rank batch tensor: every rank's ``t``
    (the same shape on each) concatenated on dim 0 in rank order,
    differentiably."""
    return _AllGatherCat.apply(t)


def is_sharded(t) -> bool:
    return hasattr(t, "to_local") and hasattr(t, "device_mesh")


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole of an FSDP2 tensor (a DTensor sharded on dim 0 over the
    default group), gathered on every rank; other tensors pass as they are."""
    if not is_sharded(t):
        return t
    local = t.to_local()
    n, dim0 = world_size(), t.shape[0]
    chunk = -(-dim0 // n)
    padded = local.new_zeros((chunk, *t.shape[1:]))
    padded[: local.shape[0]] = local
    out = local.new_empty((chunk * n, *t.shape[1:]))
    dist.all_gather_into_tensor(out, padded.contiguous())
    return out[:dim0]


def shard_like(full: torch.Tensor, ref) -> torch.Tensor:
    """This rank's shard of ``full`` (the same on every rank) as a DTensor
    laid out like ``ref``, an FSDP2 parameter (no collective)."""
    from torch.distributed.tensor import DTensor

    n, r = world_size(), dist.get_rank()
    chunk = -(-full.shape[0] // n)
    local = full.to(ref.device)[r * chunk: (r + 1) * chunk].contiguous()
    return DTensor.from_local(local, ref.device_mesh, ref.placements, run_check=False,
                              shape=full.shape, stride=full.contiguous().stride())


@torch.no_grad()
def _average_grad(p: torch.Tensor) -> None:
    """A replicated parameter's gradient, averaged over the ranks as DDP
    and FSDP2 average theirs (on a gradient already averaged over the ranks
    and summed with this batch's, the average is linear: the result stays
    the global one)."""
    dist.all_reduce(p.grad)
    p.grad.div_(world_size())


def wrap_model(model: nn.Module, batch: int, fsdp: bool = False,
               optimizer=None) -> nn.Module:
    """The model as the ranks train it: DDP, or FSDP2 with ``fsdp``. Raises
    where the world size does not divide the global ``batch``. FSDP2
    replaces the parameters with sharded ones in place: pass the
    ``Optimizer`` built over the plain ones and it is moved onto them,
    its state (a resumed one too) sharded alike."""
    per_host_batch_slice(batch)
    device = next(model.parameters()).device
    if not fsdp:
        return nn.parallel.DistributedDataParallel(
            model, device_ids=[device] if dist.get_backend() == "nccl" else None,
            broadcast_buffers=False,  # the BN running stats come from global statistics
            find_unused_parameters=True)  # AdaptiveDynamicTanh's scale_weights take no grad
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard

    names = {id(p): n for n, p in model.named_parameters()}
    mesh = init_device_mesh(device.type, (world_size(),))
    # fully_shard refuses 0-d parameters (the flagship's residual weights and
    # head scales): they stay whole on every rank, as the JAX package keeps
    # its small leaves replicated, and their gradients are averaged here
    scalars = {p for p in model.parameters() if p.ndim == 0}
    for layer in model.model:
        if any(True for _ in layer.parameters()):
            fully_shard(layer, mesh=mesh, ignored_params=scalars & set(layer.parameters()))
    fully_shard(model, mesh=mesh, ignored_params=scalars)
    for p in scalars:
        p.register_post_accumulate_grad_hook(_average_grad)
    if optimizer is not None:
        optimizer.rebind(dict(model.named_parameters()), names)
    return model
