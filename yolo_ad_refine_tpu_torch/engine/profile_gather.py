"""The gather probe's kernel (``csrc/gather.cu``) on the card, at the probe's
shapes.

    python -m yolo_ad_refine_tpu_torch.engine.profile_gather [--batch 32] [--dtype bfloat16|float32]

Mirrors the probe loop of ``benchmarks/bench_dcn.py`` (``probe_pallas_gather``):
for each AYHead level (80², 40², 20², C = 64) x (B, H*W, C) comes from
``np.random.default_rng(0).random`` and idx (B, 9*H*W) int32 from the same
generator's ``integers(0, H*W)``, one all-taps row fetch a sample. For
each level and in total it prints the kernel's time (CUDA events, mean
after warm-up) and its device time (torch.profiler), the bound (each input
read once and the output written once, over 3.35 TB/s), the plain
version's time and that of ``torch.gather(x, 1, idx[..., None].expand(-1,
-1, C))``, the one PyTorch call that computes the same function for
in-range indices (the table's library column; the port never calls it).
Nothing here is checked: ``chip_smoke.py`` holds the kernel against its
plain version.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from yolo_ad_refine_tpu_torch.engine.profile_dcn import cuda_time, device_ms
from yolo_ad_refine_tpu_torch.ops.gather import gather_rows, gather_rows_plain

LEVELS = ((80, 80), (40, 40), (20, 20))  # the AYHead's DCN maps at imgsz 640
C = 64
KK = 9
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet


def probe_inputs(b: int, h: int, w: int, dtype: torch.dtype, dev) -> tuple:
    """(x, idx) of ``bench_dcn.py``'s probe at one level: a fresh
    ``default_rng(0)`` draws x (B, H*W, C) and idx (B, 9*H*W) in [0, H*W)."""
    hw = h * w
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.random((b, hw, C))).to(dev, dtype)
    idx = torch.from_numpy(r.integers(0, hw, (b, KK * hw)).astype(np.int32)).to(dev)
    return x, idx


def bound_ms(x: torch.Tensor, idx: torch.Tensor) -> float:
    """x and idx read once, the (B, M, C) output written once, at the card's
    memory rate."""
    out_bytes = idx.numel() * x.shape[2] * x.element_size()
    return (x.numel() * x.element_size() + idx.numel() * 4 + out_bytes) / H100_BYTES_PER_S * 1e3


def profile(batch: int, dtype: torch.dtype, dev="cuda") -> dict:
    """Per level and in total: the kernel's ``ms`` and ``device_ms``, its
    ``bound_ms``, ``plain_ms`` and ``library_ms`` (torch.gather)."""
    levels = {}
    for h, w in LEVELS:
        x, idx = probe_inputs(batch, h, w, dtype, dev)
        lib_idx = idx.long()[..., None].expand(-1, -1, C)
        levels[f"{h}x{w}"] = {
            "ms": cuda_time(lambda: gather_rows(x, idx), iters=20),
            "device_ms": device_ms(lambda: gather_rows(x, idx), name="gather_rows"),
            "bound_ms": bound_ms(x, idx),
            "plain_ms": cuda_time(lambda: gather_rows_plain(x, idx), iters=5, warmup=1),
            "library_ms": cuda_time(lambda: torch.gather(x, 1, lib_idx), iters=20)}
    total = {k: sum(v[k] for v in levels.values()) for k in next(iter(levels.values()))}
    return {"batch": batch, "dtype": str(dtype).split(".")[1], "levels": levels, "total": total}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--out", type=Path, help="write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_gather: CUDA is not available; this script runs on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    res = profile(args.batch, getattr(torch, args.dtype))
    for name, v in [*res["levels"].items(), ("total", res["total"])]:
        print(f"{name} B={args.batch} {args.dtype}: kernel {v['ms']:.4f} ms (device "
              f"{v['device_ms']:.4f}), bound {v['bound_ms']:.4f} ms (bytes), torch.gather "
              f"{v['library_ms']:.4f} ms, plain {v['plain_ms']:.4f} ms", flush=True)
    res["card"] = card
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
