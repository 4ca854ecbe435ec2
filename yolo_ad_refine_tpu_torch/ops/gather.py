"""Row gather with a zero fill: the port of the DCN gather probe.

Counterpart of the TPU kernel ``kernel`` in
``benchmarks/bench_dcn.py::probe_pallas_gather`` (:103, ``pallas_call`` at
:108), which times whether a TPU kernel can gather rows of a (H*W, C) array
at dynamic indices, the pattern of a deformable conv's tap samples. Per
batch element it computes ``jnp.take(x, idx, axis=0, fill_value=0)``:

- ``gather_rows_plain`` in plain PyTorch: an index in [-N, -1] wraps to
  N + idx, an index below -N or at N and above gives a row of zeros;
- ``gather_rows`` runs it on CPU tensors and launches the CUDA kernel
  ``csrc/gather.cu`` on CUDA tensors, or raises. There is no fallback.

``engine/profile_gather.py`` times the kernel at the probe's shapes.
"""

from __future__ import annotations

import ctypes

import torch

from yolo_ad_refine_tpu_torch.utils import kernels


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, i] = x[b, idx[b, i]] for x (B, N, C) and integer idx (B, M),
    with ``jnp.take``'s fill: negative indices from -N wrap, the rest out of
    range give rows of zeros. Returns (B, M, C) in x.dtype."""
    n = x.shape[1]
    j = torch.where(idx < 0, idx + n, idx).long()
    inside = (j >= 0) & (j < n)
    rows = torch.gather(x, 1, j.clamp(0, max(n - 1, 0))[..., None].expand(-1, -1, x.shape[2]))
    return torch.where(inside[..., None], rows, torch.zeros((), dtype=x.dtype, device=x.device))


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``gather_rows_plain``'s function. A CPU tensor runs the plain
    version; a CUDA tensor launches ``csrc/gather.cu`` (x float32 or
    bfloat16 (B, N, C), idx int32 (B, M), both contiguous, on one device)
    or raises."""
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {x.device}")
    if x.dim() != 3 or idx.dim() != 2 or idx.shape[0] != x.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} must be (B, N, C) and idx {tuple(idx.shape)} (B, M)")
    if x.dtype not in (torch.float32, torch.bfloat16) or idx.dtype != torch.int32:
        raise TypeError(f"x must be float32 or bfloat16 and idx int32, got {x.dtype}, {idx.dtype}")
    if idx.device != x.device or not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("x and idx must be contiguous and on one device")
    b, n, c = x.shape
    m = idx.shape[1]
    out = torch.empty((b, m, c), dtype=x.dtype, device=x.device)
    lib = kernels.load("gather")
    fn = lib.gather_rows
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    status = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, m, c * x.element_size(),
                torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check(lib, status, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
