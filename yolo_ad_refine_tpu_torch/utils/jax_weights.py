"""Carry JAX-package variables into the port's modules.

The inverse direction of ``yolo_ad_refine_tpu/utils/torch_import.py``: each
tensor of the port's state_dict is named like the reference's, and its flax
leaf follows from that name and the kind of module that owns it. Layouts
are converted on the way (flax -> torch):

- conv kernel HWIO -> OIHW; ConvTranspose (kh, kw, I, O) -> (I, O, kh, kw)
  with the spatial flip (flax does not flip the kernel, torch does)
- Conv1d (K, I, O) -> (O, I, K); Dense (I, O) -> Linear (O, I)
- BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var;
  GroupNorm scale -> weight
- MultiHeadDotProductAttention query/key/value (D, nh, hd) -> in_proj_weight,
  out (nh, hd, D) -> out_proj.weight
- EDFFN fft (8, 5, C) -> (C, 1, 1, 8, 5); AdaptiveDynamicTanh alphas
  (ns,) -> (1, ns, 1, 1); AYHead scale{i} -> scale.{i}.scale
- DyDCNv2 weight (3, 3, C, Cout) -> DyDCNV2.conv.weight (Cout, C, 3, 3)
- OBB head: the reference's ``cv2`` / ``cv3`` sit under ``detect/``
  (``detect/cv2_i_j``), the angle branch ``cv4.i.j`` at ``cv4_i_j``

``load_jax_variables`` takes the flax trees flattened to
``{"modules_8/m0/m1/cv1/conv/kernel": array}``; ``jax_to_port`` gives the
converted arrays by port tensor name without filling a model, which is how
an optimizer's per-parameter state (momentum, Adam moments, accumulated
gradients) takes the same per-leaf layout change as the weights.
``jax_leaf_map`` lists, for each port tensor, its flax leaves with their
flax shapes and converters.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from yolo_ad_refine_tpu_torch.nn.head import OBB, ModulatedDeformConv

STATS = {"running_mean": "mean", "running_var": "var"}


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dict of arrays -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = v
    return out


def _module_path(name: str) -> list[str]:
    """'model.10.m.0.attn.qkv_projections.0' -> ['modules_10', 'm0', 'attn',
    'qkv_projections_0']: Sequential / ModuleList indices fold into the
    preceding name ('m.0' -> 'm0', 'cv2.0.1' -> 'cv2_0_1')."""
    parts = name.split(".")
    if parts[0] != "model":
        raise KeyError(f"not a yaml-row module: {name}")
    path = [f"modules_{parts[1]}"]
    i = 2
    while i < len(parts):
        nums = []
        j = i + 1
        while j < len(parts) and parts[j].isdigit():
            nums.append(parts[j])
            j += 1
        if parts[i] == "m" and nums:
            path += [f"m{nums[0]}", *nums[1:]]
        elif nums:
            path.append("_".join([parts[i], *nums]))
        else:
            path.append(parts[i])
        i = j
    # reference module names whose flax counterparts are flattened
    out: list[str] = []
    for comp in path:
        if out and re.fullmatch(r"stages_\d+", out[-1]):
            out[-1] = f"{out[-1]}_{comp}"          # PFF stages.0.conv -> stages_0_conv
        elif re.fullmatch(r"(cls|reg)_gate_0", comp):
            out.append(comp[:-2])                  # Sequential(conv, sigmoid) -> the conv
        elif comp == "conv" and out and out[-1] == "reduction_conv":
            pass                                   # TaskDecomposition reduction_conv.conv
        elif comp == "gn" and out and out[-1] == "reduction_conv":
            out[-1] = "gn"                         # ... and its GN sits beside it
        else:
            out.append(comp)
    return out


def _targets(mname: str, mod: nn.Module, pname: str, shape: tuple, nested=frozenset(),
             heads: int | None = None):
    """[(collection, flax path, converter flax -> port, flax shape)] for one
    tensor. ``nested``: yaml rows ("modules_23") whose flax head holds its
    Detect branches one level down, under ``detect/``. ``heads``: the
    number of heads of the attention that owns an ``out_proj``."""
    path = _module_path(mname)
    if path[0] in nested and re.match(r"cv[23]_\d", path[1]):
        path.insert(1, "detect")
    if len(path) == 1 and isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
        path.append("conv")  # bare nn.Conv2d / nn.ConvTranspose2d yaml rows
    if isinstance(mod, nn.GroupNorm) and path[-1] == "norm":
        path[-1] = "gn"      # DyDCNv2's norm (mmcv build_norm_layer)
    key = "/".join(path)
    same = lambda a: a  # noqa: E731
    if isinstance(mod, nn.MultiheadAttention):
        nh = mod.num_heads
        if pname == "in_proj_weight":
            f = (shape[1], nh, shape[0] // 3 // nh)
            return [("params", f"{key}/{n}/kernel", lambda a, s=shape: a.reshape(s[1], -1).T, f)
                    for n in ("query", "key", "value")]
        return [("params", f"{key}/{n}/bias", lambda a: a.reshape(-1), (nh, shape[0] // 3 // nh))
                for n in ("query", "key", "value")]
    if isinstance(mod, nn.Linear) and path[-1] == "out_proj":
        key = "/".join(path[:-1] + ["out"])
        if pname == "weight":
            f = (heads, shape[1] // heads, shape[0]) if heads else None
            return [("params", f"{key}/kernel", lambda a, s=shape: a.reshape(-1, s[0]).T, f)]
        return [("params", f"{key}/bias", same, shape)]
    if isinstance(mod, ModulatedDeformConv):  # DyDCNV2.conv.weight -> DyDCNV2/weight
        return [("params", "/".join(path[:-1] + ["weight"]), lambda a: a.transpose(3, 2, 0, 1),
                 (shape[2], shape[3], shape[1], shape[0]))]
    if pname in STATS:
        return [("batch_stats", f"{key}/{STATS[pname]}", same, shape)]
    if isinstance(mod, (nn.BatchNorm2d, nn.GroupNorm)):
        return [("params", f"{key}/{'scale' if pname == 'weight' else 'bias'}", same, shape)]
    if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
        if pname == "bias":
            return [("params", f"{key}/bias", same, shape)]
        s = shape
        conv = {nn.ConvTranspose2d: (lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1),
                                     (s[2:] + s[:2]) if len(s) == 4 else None),
                nn.Conv2d: (lambda a: a.transpose(3, 2, 0, 1),
                            (s[2], s[3], s[1], s[0]) if len(s) == 4 else None),
                nn.Conv1d: (lambda a: a.transpose(2, 1, 0), s[::-1]),
                nn.Linear: (lambda a: a.T, s[::-1])}
        fn, f = next(v for t, v in conv.items() if isinstance(mod, t))
        return [("params", f"{key}/kernel", fn, f)]
    if pname == "scale" and re.fullmatch(r"scale_\d+", path[-1]):  # AYHead Scale modules
        return [("params", "/".join(path[:-1] + [path[-1].replace("_", "")]), same, shape)]
    if pname == "fft":  # EDFFN (8, 5, C) -> (C, 1, 1, 8, 5)
        return [("params", f"{key}/fft", lambda a: a.transpose(2, 0, 1)[:, None, None],
                 (shape[3], shape[4], shape[0]))]
    if pname == "alphas":  # AdaptiveDynamicTanh (ns,) -> (1, ns, 1, 1)
        return [("params", f"{key}/alphas", lambda a, s=shape: a.reshape(s),
                 (int(np.prod(shape)),))]
    # the module's own parameters (fusion_weight, temps, residual weights, ...)
    return [("params", f"{key}/{pname}", lambda a, s=shape: a.reshape(s), shape)]


def jax_leaf_map(model: nn.Module) -> list[tuple[str, torch.Tensor, list]]:
    """(port name, tensor, targets) for every tensor a flax leaf fills, in
    module order; targets as ``_targets`` gives them. BatchNorm's
    num_batches_tracked has no flax leaf and is left out."""
    # the JAX OBB head nests its Detect under "detect" (its nn/head.py OBB)
    nested = frozenset(_module_path(n)[0] for n, m in model.named_modules() if isinstance(m, OBB))
    heads = {f"{n}.out_proj": m.num_heads for n, m in model.named_modules()
             if isinstance(m, nn.MultiheadAttention)}
    out = []
    for mname, mod in model.named_modules():
        tensors = list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False))
        for pname, t in tensors:
            if pname == "num_batches_tracked" or not mname:
                continue
            out.append((f"{mname}.{pname}", t,
                        _targets(mname, mod, pname, tuple(t.shape), nested, heads.get(mname))))
    return out


def jax_to_port(model: nn.Module, params: dict, batch_stats: dict | None = None,
                strict: bool = True, collections=("params", "batch_stats")) -> dict:
    """{port name: array in the port's layout} from flattened JAX trees, for
    every tensor whose flax leaves sit in ``collections``. With ``strict``,
    raises KeyError on any flax leaf left unused, on any such port tensor
    left without its leaf, and on any shape mismatch."""
    sources = {"params": dict(params), "batch_stats": dict(batch_stats or {})}
    used: set = set()
    errors: list[str] = []
    values = {}
    for name, t, targets in jax_leaf_map(model):
        if targets[0][0] not in collections:
            continue
        parts = []
        for coll, key, fn, _ in targets:
            if key not in sources[coll]:
                errors.append(f"no flax leaf {coll}:{key} for {name}")
                break
            used.add((coll, key))
            parts.append(np.array(fn(np.asarray(sources[coll][key], np.float32)), order="C"))
        if len(parts) != len(targets):
            continue
        value = np.concatenate(parts, 0) if len(parts) > 1 else parts[0]
        if value.shape != tuple(t.shape):
            errors.append(f"shape {value.shape} != {tuple(t.shape)} for {name}")
            continue
        values[name] = value
    unused = [f"{c}:{k}" for c in sources for k in sources[c] if (c, k) not in used]
    if strict and (errors or unused):
        raise KeyError(f"JAX -> port transfer mismatches:\nport side ({len(errors)}): "
                       f"{errors[:10]}\nunused flax leaves ({len(unused)}): {unused[:10]}")
    return values


@torch.no_grad()
def load_jax_variables(model: nn.Module, params: dict, batch_stats: dict | None = None,
                       strict: bool = True) -> None:
    """Fill ``model`` (a port DetectionModel) from flattened JAX variables.

    With ``strict``, raises KeyError on any flax leaf left unused and on any
    port tensor left unfilled (BatchNorm's num_batches_tracked aside), and
    on any shape mismatch.
    """
    values = jax_to_port(model, params, batch_stats, strict)
    for name, t, _ in jax_leaf_map(model):
        if name in values:
            t.copy_(torch.from_numpy(values[name]).to(t.dtype))
