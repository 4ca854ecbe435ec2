"""Batched linear sum assignment: the Hungarian matcher's solver.

Counterpart of ``yolo_ad_refine_tpu/ops/lap.py`` (the exact shortest
augmenting path with dual potentials, scipy's rectangular algorithm, run on
the device). Rows are GT slots, columns are queries, M <= N; padded rows
(``row_mask`` 0) have a constant cost, so the valid rows' optimum does not
depend on them and only the valid rows are solved, in row order; the padded
rows then take the lowest columns no valid row took, in row order. A tie in
a scan goes first to an unassigned column, then to the lowest index, as in
JAX: where the valid rows' optimum is unique the assignment is JAX's and
scipy's, and its cost is their optimal cost everywhere.

- ``linear_sum_assignment_plain`` is the plain version, in numpy fp32 on
  the host, the same operations in the same order as the kernel;
- ``linear_sum_assignment`` runs it on CPU tensors and launches the CUDA
  kernel ``csrc/lap.cu`` (one block a matrix) on CUDA tensors, or raises.
  There is no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from yolo_ad_refine_tpu_torch.utils import kernels

_INF = np.float32(1e30)


def _solve_one(cost: np.ndarray, valid: np.ndarray) -> tuple[np.ndarray, int]:
    """col4row (M,) int32 and the count of Dijkstra scans for one (M, N)
    float32 matrix with finite entries."""
    m, n = cost.shape
    u = np.zeros(m, np.float32)
    v = np.zeros(n, np.float32)
    row4col = np.full(n, -1, np.int32)
    col4row = np.full(m, -1, np.int32)
    scans = 0
    for cur in np.flatnonzero(valid):
        spc = np.full(n, _INF, np.float32)
        path = np.zeros(n, np.int32)
        sr = np.zeros(m, bool)
        remaining = np.ones(n, bool)
        min_val = np.float32(0.0)
        i = cur
        while True:
            sr[i] = True
            r = ((min_val + cost[i]) - u[i]) - v
            better = remaining & (r < spc)
            spc[better] = r[better]
            path[better] = i
            masked = np.where(remaining, spc, _INF)
            lowest = masked.min()
            tie = remaining & (masked == lowest)
            free = tie & (row4col == -1)
            j = int(np.argmax(free if free.any() else tie))
            remaining[j] = False
            min_val = lowest
            scans += 1
            if row4col[j] == -1:
                sink = j
                break
            i = int(row4col[j])
        others = np.flatnonzero(sr & (np.arange(m) != cur))
        u[others] = u[others] + (min_val - spc[col4row[others]])
        u[cur] = u[cur] + min_val
        scanned = ~remaining
        v[scanned] = v[scanned] + (spc[scanned] - min_val)
        j = sink
        while True:
            i = int(path[j])
            row4col[j] = i
            nxt = col4row[i]
            col4row[i] = j
            if i == cur:
                break
            j = int(nxt)
    pad = np.flatnonzero(~valid)
    col4row[pad] = np.flatnonzero(row4col == -1)[:len(pad)]
    return col4row, scans


def _check(cost: torch.Tensor, row_mask: torch.Tensor | None):
    if cost.dim() != 3 or cost.shape[1] > cost.shape[2]:
        raise ValueError(f"cost {tuple(cost.shape)} must be (B, M, N) with M <= N")
    if row_mask is not None and tuple(row_mask.shape) != tuple(cost.shape[:2]):
        raise ValueError(f"row_mask {tuple(row_mask.shape)} must be (B, M) of cost "
                         f"{tuple(cost.shape)}")


def linear_sum_assignment_plain(cost: torch.Tensor, row_mask: torch.Tensor | None = None,
                                return_scans: bool = False):
    """col4row (B, M) int32, the column assigned to each row of each (M, N)
    matrix of ``cost`` (B, M, N), M <= N, minimising the valid rows' total;
    ``row_mask`` (B, M) > 0 marks the valid rows (None: all). Non-finite
    costs count as 0. With ``return_scans``, also the (B,) Dijkstra scans
    each matrix took. Runs on the host; the result is on cost's device."""
    _check(cost, row_mask)
    c = np.nan_to_num(cost.detach().float().cpu().numpy(), nan=0.0, posinf=0.0, neginf=0.0)
    valid = (np.ones(c.shape[:2], bool) if row_mask is None
             else row_mask.detach().cpu().numpy() > 0)
    out = [_solve_one(c[b], valid[b]) for b in range(c.shape[0])]
    col4row = torch.from_numpy(np.stack([o[0] for o in out]) if out
                               else np.zeros(c.shape[:2], np.int32)).to(cost.device)
    if return_scans:
        return col4row, torch.tensor([o[1] for o in out], dtype=torch.int32)
    return col4row


def linear_sum_assignment(cost: torch.Tensor, row_mask: torch.Tensor | None = None,
                          return_scans: bool = False):
    """``linear_sum_assignment_plain``'s function. A CPU tensor runs the
    plain version; a CUDA tensor launches ``csrc/lap.cu`` (cost any float
    type, taken as fp32; row_mask any type, > 0 valid) or raises."""
    if cost.device.type == "cpu":
        return linear_sum_assignment_plain(cost, row_mask, return_scans)
    if cost.device.type != "cuda":
        raise ValueError(f"linear_sum_assignment: unsupported device {cost.device}")
    _check(cost, row_mask)
    b, m, n = cost.shape
    c = cost.detach().float().contiguous()
    mask = (torch.ones((b, m), dtype=torch.uint8, device=cost.device) if row_mask is None
            else (row_mask.detach() > 0).to(torch.uint8).contiguous())
    if mask.device != c.device:
        raise ValueError("cost and row_mask must be on one device")
    col4row = torch.empty((b, m), dtype=torch.int32, device=cost.device)
    scans = torch.empty((b,), dtype=torch.int32, device=cost.device) if return_scans else None
    lib = kernels.load("lap")
    fn = lib.lap_solve
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    status = fn(c.data_ptr(), mask.data_ptr(), col4row.data_ptr(),
                scans.data_ptr() if scans is not None else None, b, m, n,
                torch.cuda.current_stream(cost.device).cuda_stream)
    kernels.check(lib, status, "linear_sum_assignment")
    linear_sum_assignment.launches += 1
    return (col4row, scans) if return_scans else col4row


linear_sum_assignment.launches = 0
