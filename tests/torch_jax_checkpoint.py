"""Write a port training state as the JAX package's ``last`` checkpoint.

The card has no JAX, so ``chip_smoke.py`` checks the port's resume from a
JAX checkpoint on a ``last`` that this module writes from a port run. It
imports neither JAX nor the JAX package: it encodes flax's msgpack format
with ``msgpack`` alone and takes each tensor's flax leaves, shapes and
layout from the port's own table (``utils/jax_weights.py jax_leaf_map``),
inverting each converter by the index map it gives. The tier-1 test
``tests/test_torch_resume_jax.py`` holds what it writes, leaf for leaf,
against the JAX package's ``save_checkpoint`` of the same state, so the
card check does not rest on the loader it checks.

The files (the JAX package's engine/checkpoint.py save_checkpoint with
``include_optimizer``): ``weights.msgpack`` (the EMA's variables),
``train.msgpack`` (raw variables, ``step``, ``ema_updates`` and optax's
``opt_state`` as its train/optim.py build_optimizer lays it out) and
``meta.yaml``.
"""

from __future__ import annotations

import datetime
from pathlib import Path

import msgpack
import numpy as np
import torch

from yolo_ad_refine_tpu_torch.utils import yaml_save
from yolo_ad_refine_tpu_torch.utils.jax_weights import jax_leaf_map


def _pack(x):
    """flax's msgpack extension for ndarrays (type 1: shape, dtype, bytes)."""
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(1, msgpack.packb((x.shape, x.dtype.name, x.tobytes("C")),
                                                use_bin_type=True))
    return x


def _sorted(tree):
    """Dicts in sorted key order, as flax's tree_map leaves them."""
    return {k: _sorted(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree


def serialize(tree: dict) -> bytes:
    """flax's ``msgpack_serialize`` of a tree of dicts and ndarrays."""
    return msgpack.packb(_sorted(tree), default=_pack, strict_types=True)


def _set(tree: dict, key: str, value) -> None:
    *parents, last = key.split("/")
    for k in parents:
        tree = tree.setdefault(k, {})
    tree[last] = value


def to_flax(model: torch.nn.Module, tensors: dict | None = None,
            collections=("params", "batch_stats")) -> dict:
    """{collection: nested flax tree} of ``tensors`` (port name -> tensor,
    the model's own by default), each tensor split into its flax leaves in
    the flax layout: the port's converter applied to a grid of flax
    indices says where each port element came from."""
    out: dict = {c: {} for c in collections}
    for name, t, targets in jax_leaf_map(model):
        coll = targets[0][0]
        if coll not in collections:
            continue
        value = (t if tensors is None else tensors[name]).detach().float().cpu().numpy()
        shapes = [tuple(int(d) for d in f) for _, _, _, f in targets]
        sizes = [int(np.prod(f)) for f in shapes]
        offsets = np.cumsum([0] + sizes[:-1])
        index = [np.asarray(fn(np.arange(n).reshape(f) + o))
                 for (_, _, fn, _), f, n, o in zip(targets, shapes, sizes, offsets)]
        index = np.concatenate(index, 0) if len(index) > 1 else index[0]
        flat = np.empty(sum(sizes), np.float32)
        flat[index.reshape(-1)] = value.reshape(-1)
        for (_, key, _, _), f, n, o in zip(targets, shapes, sizes, offsets):
            _set(out[coll], key, flat[o:o + n].reshape(f).copy())
    return out


def _masked(tree, keep: set, prefix: str = ""):
    """The params tree with optax's masked-out leaves as {} (how flax
    serialises optax.MaskedNode)."""
    if isinstance(tree, dict):
        return {k: _masked(v, keep, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
    return tree if prefix in keep else {}


def opt_state_tree(optimizer, model: torch.nn.Module) -> dict:
    """The serialised optax state of the JAX package's build_optimizer for
    this port ``Optimizer`` (its train/optim.py: clip_by_global_norm, then,
    with accumulate > 1, scale + MultiSteps, then multi_transform over
    bias / nodecay / decay, inject_hyperparams, and add_decayed_weights +
    sgd(nesterov) or adamw)."""
    from yolo_ad_refine_tpu_torch.train.optim import param_group_label

    sgd = isinstance(optimizer.opt, torch.optim.SGD)
    acc, steps = optimizer.accumulate, optimizer.steps
    named = dict(model.named_parameters())
    state = {n: optimizer.opt.state.get(p, {}) for n, p in named.items()}
    kinds = {"trace": "momentum_buffer"} if sgd else {"mu": "exp_avg", "nu": "exp_avg_sq"}
    trees = {k: to_flax(model, {n: state[n].get(v, torch.zeros_like(p))
                                for n, p in named.items()}, ("params",))["params"]
             for k, v in kinds.items()}
    # each port tensor's flax leaves, by the group its parameter is in
    keys = {n: [key for _, key, _, _ in targets] for n, _, targets in jax_leaf_map(model)}
    at = max(steps - 1, 0) * acc  # the schedules' batch at the last applied update
    i32, f32 = (lambda v: np.asarray(v, np.int32)), (lambda v: np.asarray(v, np.float32))
    groups = {}
    for label in ("bias", "nodecay", "decay"):
        keep = {k for n, p in named.items() if param_group_label(n, p) == label for k in keys[n]}
        if sgd:
            first = {"trace": _masked(trees["trace"], keep)}
            opt_chain = {"0": first, "1": {}}
            hyper = {"lr": f32(optimizer.lr_fns[label](at)), "mom": f32(optimizer.momentum_fn(at))}
        else:
            first = {"count": i32(steps), **{k: _masked(trees[k], keep) for k in ("mu", "nu")}}
            opt_chain = {"0": first, "1": {}, "2": {}}
            hyper = {"lr": f32(optimizer.lr_fns[label](at))}
        chain = {"0": {}, "1": opt_chain} if label == "decay" else {"0": opt_chain}
        groups[label] = {"inner_state": {
            "count": i32(steps), "hyperparams": hyper,
            "hyperparams_states": {k: {"count": i32(steps)} for k in hyper},
            "inner_state": chain}}
    inner = {"0": {}, "1": {"inner_states": groups}}
    if acc == 1:
        return inner
    mini = optimizer.batches % acc
    grads = {n: (p.grad.detach() * (acc / mini) if mini and p.grad is not None
                 else torch.zeros_like(p)) for n, p in named.items()}
    return {"0": {}, "1": {"acc_grads": to_flax(model, grads, ("params",))["params"],
                           "gradient_step": i32(steps), "inner_opt_state": inner,
                           "mini_step": i32(mini), "skip_state": {}}}


def write_jax_last(path: str | Path, *, model, ema, optimizer, epoch: int, best_fitness: float,
                   names: dict, dcn_offset_max: float | None, train_args: dict) -> Path:
    """A JAX-layout ``last`` directory of a port training state."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "weights.msgpack").write_bytes(serialize(to_flax(ema.ema)))
    blob = {"variables": to_flax(model), "ema_updates": np.asarray(ema.updates, np.float32),
            "step": np.asarray(optimizer.batches, np.int32),
            "opt_state": opt_state_tree(optimizer, model)}
    (path / "train.msgpack").write_bytes(serialize(blob))
    yaml_save(path / "meta.yaml", {
        "model_yaml": model.yaml, "nc": model.nc,
        "dcn_offset_max": float(dcn_offset_max) if dcn_offset_max is not None else None,
        "names": names, "epoch": epoch, "best_fitness": float(best_fitness),
        "train_args": train_args, "date": datetime.datetime.now().isoformat(),
        "version": "written from a PyTorch state"})
    return path
