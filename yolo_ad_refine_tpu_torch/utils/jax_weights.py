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
``{"modules_8/m0/m1/cv1/conv/kernel": array}``.
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


def _targets(mname: str, mod: nn.Module, pname: str, shape: tuple, nested=frozenset()):
    """[(collection, flax path, converter flax -> port)] for one tensor.
    ``nested``: yaml rows ("modules_23") whose flax head holds its Detect
    branches one level down, under ``detect/``."""
    path = _module_path(mname)
    if path[0] in nested and re.match(r"cv[23]_\d", path[1]):
        path.insert(1, "detect")
    if len(path) == 1 and isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
        path.append("conv")  # bare nn.Conv2d / nn.ConvTranspose2d yaml rows
    if isinstance(mod, nn.GroupNorm) and path[-1] == "norm":
        path[-1] = "gn"      # DyDCNv2's norm (mmcv build_norm_layer)
    key = "/".join(path)
    if isinstance(mod, nn.MultiheadAttention):
        if pname == "in_proj_weight":
            return [("params", f"{key}/{n}/kernel", lambda a, s=shape: a.reshape(s[1], -1).T)
                    for n in ("query", "key", "value")]
        return [("params", f"{key}/{n}/bias", lambda a: a.reshape(-1))
                for n in ("query", "key", "value")]
    if isinstance(mod, nn.Linear) and path[-1] == "out_proj":
        key = "/".join(path[:-1] + ["out"])
        if pname == "weight":
            return [("params", f"{key}/kernel", lambda a, s=shape: a.reshape(-1, s[0]).T)]
        return [("params", f"{key}/bias", lambda a: a)]
    if isinstance(mod, ModulatedDeformConv):  # DyDCNV2.conv.weight -> DyDCNV2/weight
        return [("params", "/".join(path[:-1] + ["weight"]), lambda a: a.transpose(3, 2, 0, 1))]
    if pname in STATS:
        return [("batch_stats", f"{key}/{STATS[pname]}", lambda a: a)]
    if isinstance(mod, (nn.BatchNorm2d, nn.GroupNorm)):
        return [("params", f"{key}/{'scale' if pname == 'weight' else 'bias'}", lambda a: a)]
    if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
        if pname == "bias":
            return [("params", f"{key}/bias", lambda a: a)]
        conv = {nn.ConvTranspose2d: lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1),
                nn.Conv2d: lambda a: a.transpose(3, 2, 0, 1),
                nn.Conv1d: lambda a: a.transpose(2, 1, 0),
                nn.Linear: lambda a: a.T}
        fn = next(f for t, f in conv.items() if isinstance(mod, t))
        return [("params", f"{key}/kernel", fn)]
    if pname == "scale" and re.fullmatch(r"scale_\d+", path[-1]):  # AYHead Scale modules
        return [("params", "/".join(path[:-1] + [path[-1].replace("_", "")]), lambda a: a)]
    if pname == "fft":
        return [("params", f"{key}/fft", lambda a: a.transpose(2, 0, 1)[:, None, None])]
    # the module's own parameters (fusion_weight, temps, alphas, ...)
    return [("params", f"{key}/{pname}", lambda a, s=shape: a.reshape(s))]


@torch.no_grad()
def load_jax_variables(model: nn.Module, params: dict, batch_stats: dict | None = None,
                       strict: bool = True) -> None:
    """Fill ``model`` (a port DetectionModel) from flattened JAX variables.

    With ``strict``, raises KeyError on any flax leaf left unused and on any
    port tensor left unfilled (BatchNorm's num_batches_tracked aside), and
    on any shape mismatch.
    """
    sources = {"params": dict(params), "batch_stats": dict(batch_stats or {})}
    used: set = set()
    errors: list[str] = []
    # the JAX OBB head nests its Detect under "detect" (its nn/head.py OBB)
    nested = frozenset(_module_path(n)[0] for n, m in model.named_modules() if isinstance(m, OBB))
    for mname, mod in model.named_modules():
        tensors = list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False))
        for pname, t in tensors:
            if pname == "num_batches_tracked" or not mname:
                continue
            targets = _targets(mname, mod, pname, tuple(t.shape), nested)
            parts = []
            for coll, key, fn in targets:
                if key not in sources[coll]:
                    errors.append(f"no flax leaf {coll}:{key} for {mname}.{pname}")
                    break
                used.add((coll, key))
                parts.append(np.array(fn(np.asarray(sources[coll][key], np.float32)), order="C"))
            if len(parts) != len(targets):
                continue
            value = np.concatenate(parts, 0) if len(parts) > 1 else parts[0]
            if value.shape != tuple(t.shape):
                errors.append(f"shape {value.shape} != {tuple(t.shape)} for {mname}.{pname}")
                continue
            t.copy_(torch.from_numpy(value).to(t.dtype))
    unused = [f"{c}:{k}" for c in sources for k in sources[c] if (c, k) not in used]
    if strict and (errors or unused):
        raise KeyError(f"JAX -> port transfer mismatches:\nport side ({len(errors)}): "
                       f"{errors[:10]}\nunused flax leaves ({len(unused)}): {unused[:10]}")
