"""Runtime utilities of the PyTorch port: logging, yaml IO, run paths,
device selection, timers, and ``TryExcept``.

Counterpart of ``yolo_ad_refine_tpu/utils/__init__.py``. PyYAML reads and
writes the yamls, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import yaml

RANK = int(os.getenv("RANK", -1))
ROOT = Path(__file__).resolve().parents[1]  # package root
DEFAULT_CFG_PATH = ROOT / "cfg" / "default.yaml"


def _make_logger(name: str = "yolo_ad_refine_tpu_torch", verbose: bool = True) -> logging.Logger:
    level = logging.INFO if verbose and RANK in {-1, 0} else logging.ERROR
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(message)s"))
        handler.setLevel(level)
        logger.addHandler(handler)
    logger.propagate = False
    return logger


LOGGER = _make_logger()


def yaml_load(file: str | Path, append_filename: bool = False) -> dict:
    """Load a yaml file to dict; optionally record the source path."""
    path = Path(file)
    with open(path, errors="ignore", encoding="utf-8") as f:
        data = yaml.safe_load(f) or {}
    if append_filename:
        data["yaml_file"] = str(path)
    return data


def yaml_save(file: str | Path, data: dict | None = None, header: str = "") -> None:
    """Save a dict to yaml, converting paths and numpy scalars to builtins;
    ``header`` (a comment, say) is written first, as it stands."""
    file = Path(file)
    file.parent.mkdir(parents=True, exist_ok=True)
    clean = {}
    for k, v in (data or {}).items():
        if isinstance(v, Path):
            v = str(v)
        elif isinstance(v, np.generic):
            v = v.item()
        clean[k] = v
    with open(file, "w", errors="ignore", encoding="utf-8") as f:
        if header:
            f.write(header)
        yaml.safe_dump(clean, f, sort_keys=False, allow_unicode=True)


def yaml_print(data: dict | str | Path) -> None:
    """Log a yaml dict, or the yaml file at ``data``."""
    d = yaml_load(data) if isinstance(data, (str, Path)) else data
    LOGGER.info(yaml.dump(d, sort_keys=False, allow_unicode=True))


def emojis(string: str = "") -> str:
    """``string`` made safe for the platform's console (unchanged on Linux)."""
    return string


class IterableSimpleNamespace(SimpleNamespace):
    """A SimpleNamespace that iterates over its (key, value) pairs and has
    ``get`` (a cfg object)."""

    def __iter__(self):
        return iter(vars(self).items())

    def __str__(self):
        return "\n".join(f"{k}={v}" for k, v in vars(self).items())

    def get(self, key, default=None):
        return getattr(self, key, default)


class Profile:
    """Timing context manager (reference utils/ops.py:17): ``dt`` is the
    last block's seconds, ``t`` their sum. Like the JAX package's it does
    not synchronise a device: the caller ends the block's device work
    (``torch.cuda.synchronize()``) inside it."""

    def __init__(self, t: float = 0.0):
        self.t = t
        self.dt = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dt = time.perf_counter() - self.start
        self.t += self.dt

    def __str__(self):
        return f"Elapsed time is {self.t} s"


def colorstr(*args) -> str:
    """ANSI-colour a string: colorstr('red', 'bold', 'text'); one argument is blue bold."""
    *styles, string = args if len(args) > 1 else ("blue", "bold", args[0])
    codes = {"red": "\033[31m", "green": "\033[32m", "yellow": "\033[33m", "blue": "\033[34m",
             "bold": "\033[1m", "end": "\033[0m"}
    return "".join(codes[s] for s in styles) + f"{string}" + codes["end"]


def increment_path(path: str | Path, exist_ok: bool = False, sep: str = "",
                   mkdir: bool = False) -> Path:
    """runs/train -> runs/train{sep}2, runs/train{sep}3, ... unless
    ``exist_ok``; an existing file is numbered before its suffix
    (results.csv -> results{sep}2.csv)."""
    path = Path(path)
    if path.exists() and not exist_ok:
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = Path(f"{path}{sep}{n}{suffix}")
            if not p.exists():
                path = p
                break
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


class TryExcept:
    """Context manager / decorator that logs an exception as a warning and
    swallows it (the decorated function then returns None), as the JAX
    package's ``utils.TryExcept`` does."""

    def __init__(self, msg: str = "", verbose: bool = True):
        self.msg = msg
        self.verbose = verbose

    def __call__(self, func):
        def wrapper(*args, **kwargs):
            with self:
                return func(*args, **kwargs)

        wrapper.__name__, wrapper.__doc__ = func.__name__, func.__doc__
        return wrapper

    def __enter__(self):
        return self

    def __exit__(self, exc_type, value, tb):
        if self.verbose and value:
            LOGGER.warning(f"{self.msg}{': ' if self.msg else ''}{value}")
        return True


def not_ported(what: str, item: str):
    """Raise for a feature of the JAX package that the port does not run
    yet, naming the ROADMAP item that brings it."""
    raise NotImplementedError(f"{what} is not ported to PyTorch yet ({item})")


def select_device(device: str | torch.device = "cuda") -> torch.device:
    """Resolve ``device``; a CUDA device that is not there raises instead of
    falling back to the CPU. The CPU runs only when the caller asks for it.
    Under a launcher that sets ``LOCAL_RANK`` (torchrun), a bare "cuda" is
    the rank's card, card LOCAL_RANK modulo the card count (ranks share
    the cards when there are more ranks than cards)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (use 'cuda' or 'cpu')")
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    return device
