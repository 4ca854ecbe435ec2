"""Runtime utilities of the PyTorch port: logging, yaml IO, device selection.

Counterpart of ``yolo_ad_refine_tpu/utils/__init__.py``, kept to what the
predict path needs. PyYAML reads the model yamls, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path

import torch
import yaml

RANK = int(os.getenv("RANK", -1))
ROOT = Path(__file__).resolve().parents[1]  # package root


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


def select_device(device: str | torch.device = "cuda") -> torch.device:
    """Resolve ``device``; a CUDA device that is not there raises instead of
    falling back to the CPU. The CPU runs only when the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (use 'cuda' or 'cpu')")
    return device
