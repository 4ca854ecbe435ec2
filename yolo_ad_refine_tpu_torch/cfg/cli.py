"""Command-line interface of the PyTorch port.

Counterpart of ``yolo_ad_refine_tpu/cfg/cli.py`` (reference
cfg/__init__.py:678 entrypoint): the same ``task mode key=value`` grammar,
modes and special modes. Installed as the ``yat-torch`` console script and
runnable as ``python -m yolo_ad_refine_tpu_torch``, also under
``torchrun --nproc_per_node=N`` for multi-GPU training.

Usage:
    yat-torch detect train data=coco128.yaml model=yolo11n.yaml epochs=3
    yat-torch detect val model=runs/train/weights/best data=coco128.yaml
    yat-torch detect predict model=runs/train/weights/best source=imgs/
    yat-torch detect tune data=coco128.yaml iterations=10
    yat-torch detect benchmark model=runs/train/weights/best imgsz=640 batch=32
    yat-torch classify train model=yolo11n-cls.yaml data=<class-folder dir> imgsz=224
    yat-torch classify val model=runs/cls/weights/best data=<class-folder dir> imgsz=224
    yat-torch cfg | yat-torch version | yat-torch checks | yat-torch settings [key=value]
    torchrun --nproc_per_node=8 -m yolo_ad_refine_tpu_torch detect train data=... batch=128

Every mode runs on the card unless ``device=cpu`` is given. Without a task
the model's head decides it (the JAX CLI assumes ``detect``).
"""

from __future__ import annotations

import ast
import sys

from yolo_ad_refine_tpu_torch.utils import DEFAULT_CFG_PATH, LOGGER, yaml_load

TASKS = {"detect", "segment", "pose", "obb", "classify"}
MODES = {"train", "val", "predict", "benchmark", "tune"}

HELP = __doc__


def parse_kv(args: list[str]) -> dict:
    """Parse k=v tokens with literal-eval values."""
    out = {}
    for a in args:
        if "=" not in a:
            raise SystemExit(f"argument '{a}' is not key=value (see `yat-torch help`)")
        k, v = a.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        out[k] = v
    return out


def checks() -> None:
    """The environment report: Python, torch, CUDA, the card's name and
    power limit, nvcc, the build state of the hand-written kernels, and
    whether the native host ops and JPEG loader build (g++, libjpeg)."""
    import platform
    import subprocess

    import torch

    from yolo_ad_refine_tpu_torch.utils import kernels

    print(f"python   {platform.python_version()} on {platform.platform()}")
    print(f"torch    {torch.__version__}  CUDA {torch.version.cuda}")
    if torch.cuda.is_available():
        try:
            card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True, text=True,
                                  check=True, timeout=30).stdout.strip().splitlines()
        except (OSError, subprocess.SubprocessError) as e:
            card = [f"{torch.cuda.get_device_name(i)} (nvidia-smi: {e})"
                    for i in range(torch.cuda.device_count())]
        for i, c in enumerate(card):
            print(f"cuda:{i}   {c}")
    else:
        print("cuda     not available: every mode needs device=cpu here")
    try:
        nvcc = kernels.nvcc_path()
        out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=30)
        print(f"nvcc     {nvcc}: {out.stdout.strip().splitlines()[-1]}")
    except (RuntimeError, OSError, subprocess.SubprocessError, IndexError) as e:
        print(f"nvcc     not found ({e})")
    for name in kernels.EXTRA_FLAGS:
        lib = kernels.library_path(name)
        print(f"kernel   {name}: {'built' if lib.exists() else 'not built'} ({lib})")
    from yolo_ad_refine_tpu_torch.ops import native

    try:
        native.get_lib()
        print("native ops    ok")
    except RuntimeError as e:  # the build's cause and the compiler's log
        print(f"native ops    unavailable: {e}")
    try:
        print(f"native loader ok ({native.loader_decoder()})")
    except RuntimeError as e:
        print(f"native loader unavailable: {e}")


def entrypoint(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("help", "-h", "--help"):
        print(HELP)
        return 0
    if argv[0] == "version":
        from yolo_ad_refine_tpu_torch import __version__

        print(__version__)
        return 0
    if argv[0] == "cfg":
        import yaml

        print(yaml.safe_dump(yaml_load(DEFAULT_CFG_PATH), sort_keys=False).rstrip())
        return 0
    if argv[0] == "checks":
        checks()
        return 0
    if argv[0] == "settings":
        from yolo_ad_refine_tpu_torch.utils.settings import get_settings

        s = get_settings()
        updates = parse_kv(argv[1:])
        if updates.pop("reset", False):
            s.reset()
        if updates:
            s.update(updates)
        for k, v in s.items():
            print(f"{k}: {v}")
        return 0

    task = argv.pop(0) if argv[0] in TASKS else None
    if not argv or argv[0] not in MODES:
        raise SystemExit(f"expected a mode in {sorted(MODES)} (see `yat-torch help`)")
    mode = argv.pop(0)
    overrides = parse_kv(argv)

    from yolo_ad_refine_tpu_torch import YOLO

    model_arg = overrides.pop("model", "yolo11n.yaml")
    task = overrides.pop("task", task)  # `train task=obb ...` also works
    model = YOLO(model_arg, task=task, imgsz=int(overrides.get("imgsz", 640)),
                 device=str(overrides.pop("device", "cuda")))

    if mode == "train":
        results = model.train(**overrides)
        LOGGER.info(f"results: {results}")
    elif mode == "tune":
        best = model.tune(iterations=int(overrides.pop("iterations", 10)), **overrides)
        LOGGER.info(f"best hyperparameters: {best}")
    elif mode == "val":
        results = model.val(**overrides)
        LOGGER.info(f"results: {results}")
    elif mode == "predict":
        source = overrides.pop("source", None)
        if source is None:
            raise SystemExit("predict requires source=<path>")
        model.predict(source=source, save=overrides.pop("save", True), **overrides)
    else:  # benchmark
        model.benchmark(**overrides)
    return 0


if __name__ == "__main__":
    raise SystemExit(entrypoint())
