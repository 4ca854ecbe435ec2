"""Checkpoint directories: save, load, resume.

Counterpart of ``yolo_ad_refine_tpu/engine/checkpoint.py`` (reference
engine/trainer.py:507-541 save_model, tasks.py:718-877). A checkpoint is a
directory:

- ``weights.pt``: the EMA ``state_dict``, which is the model (the
  reference's best.pt holds the EMA too);
- ``train.pt`` (``last``): the raw ``state_dict``, the optimizer state with
  its batch and step counts and the gradients summed towards its next
  step, and the EMA update count, for resume;
- ``meta.yaml``: the JAX package's keys (model_yaml, nc,
  dcn_offset_max, names, epoch, best_fitness, train_args, date, version).

Tensors are written with ``torch.save``. ``load_checkpoint`` also reads a
directory the JAX package wrote (``weights.msgpack`` in flax's msgpack
format, decoded with ``msgpack`` alone, and the same ``meta.yaml``), and in
both cases widens the DCN clip radius to cover the checkpoint's
``dcn_offset_max`` as the JAX package does (its engine/checkpoint.py:85-104).
``load_train_state`` resumes from either kind of ``last``: the port's
``train.pt`` or the JAX package's ``train.msgpack`` with its optax state.
"""

from __future__ import annotations

import datetime
import math
from pathlib import Path

import numpy as np
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
        # max |DCN offset| seen in training: load_checkpoint widens the
        # bounded kernels' clip radius to cover it
        "dcn_offset_max": float(dcn_offset_max) if dcn_offset_max is not None else None,
        "names": names or getattr(model, "names", None),
        "epoch": epoch,
        "best_fitness": float(best_fitness),
        "train_args": train_args or {},
        "date": datetime.datetime.now().isoformat(),
        "version": VERSION,
    })
    return path


def widen_dcn_radius(model_yaml, dcn_offset_max):
    """The model yaml with ``dcn_radius`` raised to cover a checkpoint's
    ``dcn_offset_max`` (+1 px of headroom: validation images can push the
    offsets slightly past the training maximum), as the JAX package's
    ``load_checkpoint`` does. A yaml that already covers it is returned
    as it is."""
    if not dcn_offset_max:
        return model_yaml
    from yolo_ad_refine_tpu_torch.models.parser import load_model_cfg

    model_yaml = load_model_cfg(model_yaml)
    need = math.ceil(float(dcn_offset_max)) + 1
    have = float(model_yaml.get("dcn_radius", 3.0))
    if need > have:
        model_yaml = dict(model_yaml, dcn_radius=float(need))
        LOGGER.info(f"DCN radius {have:g} -> {need} (checkpoint dcn_offset_max "
                    f"{float(dcn_offset_max):.2f}; bounded kernels stay exact)")
    return model_yaml


def _flax_ndarray(data: bytes) -> np.ndarray:
    """One array of flax's msgpack encoding: (shape, dtype name, C-order bytes)."""
    import msgpack

    shape, name, buf = msgpack.unpackb(data, raw=True)
    if name == b"bfloat16":  # numpy has no bfloat16: widen through torch
        bits = torch.from_numpy(np.frombuffer(buf, np.uint16).copy())
        return bits.view(torch.bfloat16).float().numpy().reshape(shape)
    return np.frombuffer(buf, np.dtype(name.decode())).reshape(shape)


def read_flax_msgpack(path: str | Path) -> dict:
    """A tree that flax's ``msgpack_serialize`` wrote, decoded with
    ``msgpack`` alone: ext type 1 is an ndarray, 3 a numpy scalar, 2 a
    complex. The chunked form, which flax uses only for arrays over 2**30
    bytes, raises."""
    import msgpack

    def ext(code, data):
        if code == 1:
            return _flax_ndarray(data)
        if code == 3:
            return _flax_ndarray(data)[()]
        if code == 2:
            re, im = msgpack.unpackb(data)
            return complex(re, im)
        raise ValueError(f"{path}: unknown msgpack ext type {code}")

    def check(tree):
        if isinstance(tree, dict):
            if "__msgpack_chunked_array__" in tree:
                raise ValueError(f"{path}: chunked arrays (over 2**30 bytes) are not supported")
            for v in tree.values():
                check(v)

    tree = msgpack.unpackb(Path(path).read_bytes(), ext_hook=ext, raw=False)
    check(tree)
    return tree


def load_checkpoint(path: str | Path, device: str | torch.device = "cuda"):
    """Rebuild a DetectionModel from a checkpoint directory (its EMA
    weights), the port's (``weights.pt``) or the JAX package's
    (``weights.msgpack``, loaded strictly through ``load_jax_variables``),
    in eval mode on ``device`` with its strides probed. The DCN radius is
    widened to cover the checkpoint's ``dcn_offset_max``."""
    from yolo_ad_refine_tpu_torch.models.model import DetectionModel
    from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

    device = select_device(device)
    path = Path(path)
    if path.is_file():  # meta.yaml, weights.pt or weights.msgpack
        path = path.parent
    if not (path / "weights.pt").exists() and not (path / "weights.msgpack").exists():
        raise FileNotFoundError(f"no checkpoint at {path} (neither weights.pt nor weights.msgpack)")
    meta = yaml_load(path / "meta.yaml")
    model_yaml = widen_dcn_radius(meta["model_yaml"], meta.get("dcn_offset_max"))
    model = DetectionModel(model_yaml, nc=meta.get("nc"))
    if (path / "weights.pt").exists():
        model.load_state_dict(torch.load(path / "weights.pt", map_location="cpu"))
    else:
        variables = read_flax_msgpack(path / "weights.msgpack")
        extra = set(variables) - {"params", "batch_stats"}
        if extra:
            raise KeyError(f"{path}/weights.msgpack holds collections the port does not load: "
                           f"{sorted(extra)}")
        load_jax_variables(model, flatten_tree(variables["params"]),
                           flatten_tree(variables.get("batch_stats", {})))
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
    checkpoint in place: the port's ``train.pt`` where there is one, else
    the JAX package's ``train.msgpack`` (``_load_jax_train_state``).
    Returns (start_epoch, best_fitness, dcn_offset_max), the last from
    meta.yaml, where the JAX package's own resume leaves it at 0."""
    path = Path(path)
    meta = yaml_load(path / "meta.yaml")
    dev = next(model.parameters()).device
    if (path / "train.pt").exists():
        blob = torch.load(path / "train.pt", map_location=dev)
        model.load_state_dict(blob["model"])
        ema.ema.load_state_dict(torch.load(path / "weights.pt", map_location=dev))
        ema.updates = int(blob["ema_updates"])
        optimizer.load_state_dict(blob["optimizer"])
    elif (path / "train.msgpack").exists():
        _load_jax_train_state(path, model, ema, optimizer)
    else:
        raise FileNotFoundError(f"resume checkpoint not found at {path} "
                                "(neither train.pt nor train.msgpack)")
    return (int(meta.get("epoch", -1)) + 1, float(meta.get("best_fitness", 0.0)),
            float(meta.get("dcn_offset_max") or 0.0))


def _load_jax_train_state(path: Path, model, ema, optimizer) -> None:
    """A JAX ``last`` (its engine/checkpoint.py save_checkpoint and
    load_train_state): the raw variables into ``model`` and the EMA's
    ``weights.msgpack`` into ``ema.ema``, both strictly through
    ``load_jax_variables``; ``step`` (batches seen) and ``ema_updates``
    into the counters; ``opt_state`` through ``load_jax_opt_state``. As in
    the JAX package, a blob without ``step`` (a ``best``) keeps the fresh
    counters, and one without ``opt_state`` or whose state does not fit
    this optimizer warns and starts the optimizer fresh."""
    from yolo_ad_refine_tpu_torch.train.optim import load_jax_opt_state
    from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

    blob = read_flax_msgpack(path / "train.msgpack")
    for target, variables in ((model, blob["variables"]),
                              (ema.ema, read_flax_msgpack(path / "weights.msgpack"))):
        load_jax_variables(target, flatten_tree(variables["params"]),
                           flatten_tree(variables.get("batch_stats", {})))
    if "step" in blob:
        optimizer.batches = int(blob["step"])
        ema.updates = int(round(float(blob["ema_updates"])))
    if "opt_state" not in blob:
        LOGGER.warning(f"{path}/train.msgpack has no optimizer state; the optimizer starts fresh")
        return
    try:
        load_jax_opt_state(optimizer, blob["opt_state"], model)
    except (KeyError, ValueError) as e:
        LOGGER.warning(f"optimizer state restore failed ({e}); the optimizer starts fresh")
