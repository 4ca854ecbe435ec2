"""Checkpoint directories: save, load, resume.

Counterpart of ``yolo_ad_refine_tpu/engine/checkpoint.py`` (reference
engine/trainer.py:507-541 save_model, tasks.py:718-877). A checkpoint is a
directory:

- ``weights.pt``: the EMA ``state_dict``, which is the model (the
  reference's best.pt holds the EMA too);
- ``train.pt`` (``last``): the raw ``state_dict``, the optimizer state with
  its batch and step counts, and the EMA update count, for resume;
- ``meta.yaml``: the JAX package's keys (model_yaml, nc,
  dcn_offset_max, names, epoch, best_fitness, train_args, date, version).

Tensors are written with ``torch.save``. Reading the JAX package's msgpack
checkpoints is not ported (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import datetime
from pathlib import Path

import torch

from yolo_ad_refine_tpu_torch.utils import LOGGER, select_device, yaml_load, yaml_save

VERSION = "0.1.0"


def save_checkpoint(path: str | Path, *, model, ema=None, optimizer=None, epoch: int = -1,
                    best_fitness: float = 0.0, train_args: dict | None = None,
                    names: dict | None = None, dcn_offset_max: float | None = None) -> Path:
    """Write a checkpoint directory. With ``ema`` its model is the weights;
    with ``optimizer`` too, ``train.pt`` holds what resume needs."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    weights = (ema.ema if ema is not None else model).state_dict()
    torch.save({k: v.detach().cpu() for k, v in weights.items()}, path / "weights.pt")
    if optimizer is not None:
        torch.save({"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
                    "optimizer": optimizer.state_dict(),
                    "ema_updates": ema.updates if ema is not None else 0},
                   path / "train.pt")
    yaml_save(path / "meta.yaml", {
        "model_yaml": model.yaml,
        "nc": model.nc,
        # max |DCN offset| seen in training; the JAX package widens its
        # bounded kernels' clip radius from it, the port samples unbounded
        "dcn_offset_max": float(dcn_offset_max) if dcn_offset_max is not None else None,
        "names": names or getattr(model, "names", None),
        "epoch": epoch,
        "best_fitness": float(best_fitness),
        "train_args": train_args or {},
        "date": datetime.datetime.now().isoformat(),
        "version": VERSION,
    })
    return path


def load_checkpoint(path: str | Path, device: str | torch.device = "cuda"):
    """Rebuild a DetectionModel from a checkpoint directory (its EMA
    weights), in eval mode on ``device`` with its strides probed."""
    from yolo_ad_refine_tpu_torch.models.model import DetectionModel

    device = select_device(device)
    path = Path(path)
    if path.is_file():  # meta.yaml or weights.pt
        path = path.parent
    if not (path / "weights.pt").exists():
        raise FileNotFoundError(f"no port checkpoint at {path} (weights.pt missing); reading "
                                "the JAX package's msgpack checkpoints is not ported yet "
                                "(ROADMAP Queue 1 item 7)")
    meta = yaml_load(path / "meta.yaml")
    model = DetectionModel(meta["model_yaml"], nc=meta.get("nc"))
    model.load_state_dict(torch.load(path / "weights.pt", map_location="cpu"))
    model = model.to(device).eval()
    imgsz = int((meta.get("train_args") or {}).get("imgsz") or 640)
    model.probe_strides(imgsz)
    model.names = meta.get("names") or {i: f"class{i}" for i in range(model.nc)}
    model.ckpt_meta = meta
    LOGGER.info(f"loaded checkpoint {path} (epoch {meta.get('epoch')}, "
                f"fitness {meta.get('best_fitness', 0.0):.4f})")
    return model


def load_train_state(path: str | Path, model, ema, optimizer):
    """Restore raw weights, EMA, optimizer and counters from a ``last``
    checkpoint in place. Returns (start_epoch, best_fitness, dcn_offset_max)."""
    path = Path(path)
    meta = yaml_load(path / "meta.yaml")
    dev = next(model.parameters()).device
    blob = torch.load(path / "train.pt", map_location=dev)
    model.load_state_dict(blob["model"])
    ema.ema.load_state_dict(torch.load(path / "weights.pt", map_location=dev))
    ema.updates = int(blob["ema_updates"])
    optimizer.load_state_dict(blob["optimizer"])
    return (int(meta.get("epoch", -1)) + 1, float(meta.get("best_fitness", 0.0)),
            float(meta.get("dcn_offset_max") or 0.0))
