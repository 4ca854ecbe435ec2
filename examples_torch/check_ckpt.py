"""Checkpoint introspection: the port's copy of ``examples/check_ckpt.py``
(parity surface: the reference's root check_pt.py, which loads a weights
file, reports its structure and finds named modules).

Usage:
    python examples_torch/check_ckpt.py <run_dir>/weights/best [module-substr] [--device cuda]

It loads a checkpoint directory, the port's (weights.pt) or the JAX
package's (weights.msgpack), with ``engine/checkpoint.py load_checkpoint``
and prints the JAX script's three sections: the head, nc and strides; the
parameters leaf by leaf with their shapes and counts; the yaml layers. The
leaves are printed under the JAX package's names, shapes and order (flax
paths such as ``modules_0/conv/kernel``, through
``utils/jax_weights.py jax_leaf_map``), so the two scripts print the same
lines for one checkpoint, and the total is the JAX checkpoint's, which is
the port model's parameter count.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv: list[str] | None = None) -> dict:
    """Load and print; returns {"head", "nc", "strides", "leaves" [(name,
    shape, count)], "total", "layers" [(index, name)]}, what it printed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default="runs/train/exp/weights/best")
    ap.add_argument("needle", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    path, needle = args.path, args.needle

    from yolo_ad_refine_tpu_torch.engine.checkpoint import load_checkpoint
    from yolo_ad_refine_tpu_torch.utils.jax_weights import jax_leaf_map

    print(f"loading: {path} ...")
    model = load_checkpoint(path, args.device)
    head = model.specs[model.head_idx].name if model.head_idx >= 0 else "?"
    print("\n=== checkpoint loaded ===")
    print(f"task head: {head}  nc={model.nc}  strides={model.strides}")
    leaves = sorted(((key, tuple(shape)) for _, _, targets in jax_leaf_map(model)
                     for coll, key, _, shape in targets if coll == "params"),
                    key=lambda leaf: tuple(leaf[0].split("/")))
    total, shown = 0, []
    for name, shape in leaves:
        n = int(np.prod(shape))
        total += n
        if needle is None or needle.lower() in name.lower():
            print(f"{name:<70} {str(shape):<20} {n:>10,}")
            shown.append((name, shape, n))
    print(f"\ntotal parameters: {total:,}")
    # per-layer module table (the reference walks named_modules)
    print("\nyaml layers:")
    for s in model.specs:
        mark = " <--" if needle and needle.lower() in s.name.lower() else ""
        print(f"  {s.i:>3} {s.name}{mark}")
    return {"head": head, "nc": model.nc, "strides": model.strides, "leaves": shown,
            "total": total, "layers": [(s.i, s.name) for s in model.specs]}


if __name__ == "__main__":
    main()
