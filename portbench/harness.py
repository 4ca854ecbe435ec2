"""What every cell's run shares: finding the cell's files by name, the
caches, the card, the result line and the isolation check.

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` is run from
``configs/<config>.json``, ``traffic/<traffic>.json`` and, for each
per-layer metric, ``metrics/<metric>.py`` (a ``read(run)`` that returns the
number, or None where its cell has nothing for it to read). The traffic
file's ``kind`` names the runner, the module ``portbench.<kind>``, whose
``run`` measures the cell and returns its end-to-end values under their
metric names (``e2e``) and its compared numbers (``numbers``).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "yolo_ad_refine_tpu"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: Path = ROOT) -> dict:
    """The ``workloads`` entry of ``name`` in ``root``'s BENCHMARK.json with
    its configuration, traffic and the metrics that it reports, each read
    from its own file."""
    spec = load_json(root / "BENCHMARK.json")
    w = next((w for w in spec["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    cfg = load_json(root / conf["file"])
    cfg["yaml_path"] = str(root / cfg["yaml"])
    traffic = load_json(root / BENCH.name / "traffic" / f"{w['traffic']}.json")

    def here(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in spec["end_to_end"] if here(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if here(m) and m["moves"] in e2e_names]
    return {"name": name, "chips": w["chips"], "config": cfg, "traffic": traffic,
            "end_to_end": e2e, "per_layer": layer, "root": root}


def metric_reader(name: str, root: Path = ROOT):
    path = root / BENCH.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def fixed_caches() -> None:
    """The program's kernel caches at fixed paths inside the checkout: the
    nvcc build directory is its own ``csrc/build``; Triton's and torch's
    extension cache go to ``.portbench_cache``."""
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


@contextlib.contextmanager
def tf32_off():
    """TF32 off in cuDNN and matmul for the reference, the flags restored
    after it."""
    import torch

    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def scratch_dir() -> Path:
    """Where a run writes its data: under the TMPDIR it is given."""
    import tempfile

    return Path(tempfile.gettempdir()) / "portbench"


def loaded_forbidden() -> list[str]:
    """Modules whose top-level name, compared whole, is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def require_cards(n: int) -> dict:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        raise SystemExit(f"the cell needs {n} CUDA device(s); "
                         f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}


def held(numbers: dict, limits: dict) -> list[tuple[str, float, float]]:
    """[(name, value, limit)] of the numbers that the configuration gives a
    limit; the others are printed on stderr, not compared."""
    for name in sorted(numbers.keys() - limits.keys()):
        print(f"{name} {numbers[name]!r} (not compared)", file=sys.stderr)
    return [(name, numbers[name], limit) for name, limit in limits.items()]


def emit(result: dict, limits: list[tuple[str, float, float]]) -> None:
    """Print the compared numbers beside their limits as the last lines of
    stderr and the result as the last line of stdout, after the isolation
    check."""
    bad = loaded_forbidden()
    if bad:
        print(f"isolation: these modules were loaded: {', '.join(bad)}", file=sys.stderr)
        raise SystemExit(3)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in limits}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for n, v, lim in limits:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
