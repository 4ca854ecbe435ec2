"""Automatic batch size (``batch=-1``) from the card's measured memory.

Counterpart of ``yolo_ad_refine_tpu/utils/autobatch.py`` (reference
ultralytics/utils/autobatch.py:24-72). The fit and the pick are the JAX
package's: a line ``peak(b) = base + slope * b`` through the peaks of two
probe batches, then the largest power of two up to ``max_batch`` with
``base + slope * b <= fraction * limit``. The peaks are the card's own:
``torch.cuda.max_memory_allocated`` over one real train step at each probe
batch, after ``reset_peak_memory_stats``, and the limit is the device's
``total_memory``. Where the JAX package reads XLA's compile-time analysis
and falls back to batch 16 when that fails, a failed measurement here
raises: a guess would hide the device. On the CPU there is no card memory
to measure, and ``batch=-1`` raises.
"""

from __future__ import annotations

import torch

from yolo_ad_refine_tpu_torch.utils import LOGGER

PROBE_BATCHES = (8, 16)  # two real steps near the sizes the pick lands on (see PERF.md)


def fit_peaks(b1: int, p1: float, b2: int, p2: float) -> tuple[float, float]:
    """(base, slope) of the line through two measured peaks, as the JAX
    package fits its batch 1 and 2: slope at least 1 byte an image, base
    at least 0."""
    slope = max((p2 - p1) / (b2 - b1), 1)
    return max(p1 - slope * b1, 0), slope


def pick_batch(base: float, slope: float, limit: float, fraction: float = 0.60,
               max_batch: int = 1024) -> int:
    """The largest power of two b <= max_batch with base + slope * b within
    fraction * limit (1 when even 2 does not fit)."""
    budget = fraction * limit
    b = 1
    while b * 2 <= max_batch and base + slope * (b * 2) <= budget:
        b *= 2
    return b


def step_peak_bytes(step, batch: int, device: torch.device) -> int:
    """Peak allocated bytes of ``step(batch)`` (one train step) on the card."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    step(batch)
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def autobatch(step, device: torch.device, fraction: float = 0.60, max_batch: int = 1024,
              probes: tuple[int, int] = PROBE_BATCHES) -> dict:
    """Measure ``step`` (batch -> None, one real train step) at the two
    ``probes`` and pick the batch. Returns the pick with what it came from:
    {batch, peaks, base, slope, limit, fraction}."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("batch=-1 (autobatch) measures the card's memory and runs on CUDA "
                           f"only; on {device.type} pass a batch size")
    peaks = {b: step_peak_bytes(step, b, device) for b in probes}
    (b1, p1), (b2, p2) = sorted(peaks.items())
    base, slope = fit_peaks(b1, p1, b2, p2)
    limit = torch.cuda.get_device_properties(device).total_memory
    batch = pick_batch(base, slope, limit, fraction, max_batch)
    LOGGER.info(f"autobatch: peaks {', '.join(f'b{b} {p / 1e9:.2f} GB' for b, p in peaks.items())}"
                f" -> base {base / 1e9:.2f} GB + {slope / 1e6:.1f} MB/img, limit "
                f"{limit / 1e9:.1f} GB x {fraction:.0%} -> batch {batch}")
    return {"batch": batch, "peaks": peaks, "base": base, "slope": slope, "limit": limit,
            "fraction": fraction}
