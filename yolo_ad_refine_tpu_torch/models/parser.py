"""Yaml -> layer-graph compiler.

Counterpart of ``yolo_ad_refine_tpu/models/parser.py`` (reference
ultralytics/nn/tasks.py:943-1108 parse_model): the same channel
bookkeeping, for the modules this port has so far.

- depth gain: n = max(round(n * depth), 1) for n > 1
- width gain: c2 = make_divisible(min(c2, max_channels) * width, 8) unless
  c2 == nc, for the conv family including bare nn.Conv2d /
  nn.ConvTranspose2d rows (fork extension)
- yaml-level variables (``head_channel``, ``fusion_mode``) resolved by name
- C3k2 forces c3k=True at scales m/l/x
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from torch import nn

from yolo_ad_refine_tpu_torch.nn import block as B
from yolo_ad_refine_tpu_torch.nn import common as C
from yolo_ad_refine_tpu_torch.nn import head as H
from yolo_ad_refine_tpu_torch.nn import tssa as T
from yolo_ad_refine_tpu_torch.nn.common import make_divisible
from yolo_ad_refine_tpu_torch.utils import LOGGER, ROOT, yaml_load

HEAD_MODULES = {"Detect", "AYHead", "AYHead1", "OBB"}
# modules whose first yaml arg is an out-channel subject to width scaling
WIDTH_SCALED = {"Conv", "SPPF", "C2f", "C3", "C3k2", "C2PSA", "C3k2_MLCA", "C2PTSSA",
                "nn.Conv2d", "nn.ConvTranspose2d"}
CSP_MODULES = {"C2f": B.C2f, "C3": B.C3, "C3k2": B.C3k2, "C3k2_MLCA": B.C3k2MLCA}
PSA_MODULES = {"C2PSA": B.C2PSA, "C2PTSSA": T.C2PTSSA}


@dataclass
class LayerSpec:
    """One compiled yaml row."""

    i: int                      # layer index
    f: Any                      # 'from': int or list of ints
    name: str                   # module name as written in yaml
    n: int                      # repeats as written
    c2: int                     # output channels
    module: nn.Module
    is_head: bool = False
    args: list = field(default_factory=list)


def guess_model_scale(path: str | Path) -> str:
    """The compound-scale suffix of a file name (yolo11n -> 'n')."""
    m = re.search(r"yolo[v]?\d+([nslmx])", Path(path).stem)
    return m.group(1) if m else ""


def resolve_cfg(model: str | Path) -> Path:
    """Find a model yaml: the path itself, or by name in the bundled
    cfg/models, also with its scale letter removed (yolo11n.yaml)."""
    p = Path(model)
    if p.exists():
        return p
    unified_name = re.sub(r"(\d+)([nslmx])(.*)\.", r"\1\3.", p.name)
    for name in (p.name, unified_name):
        bundled = ROOT / "cfg" / "models" / name
        if bundled.exists():
            return bundled
    raise FileNotFoundError(f"model cfg '{model}' not found (looked in cwd and {ROOT / 'cfg' / 'models'})")


def load_model_cfg(cfg: str | Path | dict) -> dict:
    """Load a model yaml (dict passthrough) and record the scale of its name."""
    if isinstance(cfg, dict):
        return dict(cfg)
    d = yaml_load(resolve_cfg(cfg), append_filename=True)
    scale = guess_model_scale(cfg)
    if scale:
        d["scale"] = scale
    return d


def _substitute(args: list, variables: dict) -> list:
    """Resolve string args: yaml top-level variables first, then literals."""
    out = []
    for a in args:
        if isinstance(a, str):
            if a in variables:
                a = variables[a]
            else:
                try:
                    a = ast.literal_eval(a)
                except (ValueError, SyntaxError):
                    pass
        out.append(a)
    return out


def _arg(rest: list, i: int, default):
    return rest[i] if len(rest) > i else default


def parse_model_yaml(d: dict, ch: int = 3, verbose: bool = False):
    """Compile a model yaml dict into layer specs.

    Returns (specs, meta): meta holds nc, the savelist (sorted indices of
    layers whose outputs are reused), the scale and the per-layer channels.
    """
    nc = d.get("nc", 80)
    scales = d.get("scales")
    scale = d.get("scale")
    depth, width, max_channels = d.get("depth_multiple", 1.0), d.get("width_multiple", 1.0), float("inf")
    if scales:
        if not scale:
            scale = tuple(scales.keys())[0]
            LOGGER.warning(f"WARNING no model scale passed. Assuming scale='{scale}'.")
        depth, width, max_channels = scales[scale]
    variables = {k: v for k, v in d.items() if k not in ("backbone", "head", "scales")}

    ch_list = [ch]
    specs: list[LayerSpec] = []
    save: set[int] = set()
    for i, (f, n, name, args) in enumerate(d["backbone"] + d["head"]):
        args = _substitute(list(args), variables)
        n_orig = n
        n = max(round(n * depth), 1) if n > 1 else n
        c1 = ch_list[f] if isinstance(f, int) else ch_list[f[0]]
        c2 = c1

        if name in WIDTH_SCALED:
            c2 = args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            rest = args[1:]
            if name == "Conv":
                module = C.Conv(c1, c2, _arg(rest, 0, 1), _arg(rest, 1, 1), _arg(rest, 2, None),
                                _arg(rest, 3, 1), _arg(rest, 4, 1), _arg(rest, 5, True))
            elif name == "SPPF":
                module = B.SPPF(c1, c2, _arg(rest, 0, 5))
            elif name in ("C2f", "C3"):
                module = CSP_MODULES[name](c1, c2, n, _arg(rest, 0, name == "C3"))
            elif name in ("C3k2", "C3k2_MLCA"):
                c3k = _arg(rest, 0, False)
                if name == "C3k2" and scale in ("m", "l", "x"):
                    c3k = True  # reference tasks.py:1050-1051
                module = CSP_MODULES[name](c1, c2, n, c3k=c3k, e=_arg(rest, 1, 0.5),
                                           shortcut=_arg(rest, 2, True))
            elif name in PSA_MODULES:
                e = _arg(rest, 0, 0.5)
                module = PSA_MODULES[name](c1, c2, n, e if isinstance(e, float) else 0.5)
            elif name == "nn.Conv2d":
                module = C.plain_conv2d(c1, c2, _arg(rest, 0, 1), _arg(rest, 1, 1))
            else:  # nn.ConvTranspose2d
                module = C.plain_conv_transpose2d(c1, c2, _arg(rest, 0, 3), _arg(rest, 1, 2),
                                                  _arg(rest, 2, 1), _arg(rest, 3, 1))
        elif name == "ELA_HSFPN":
            module = B.ELAHSFPN(c1, _arg(args, 0, True))
        elif name == "Multiply":
            module = B.Multiply()
        elif name == "Add":
            module = B.Add()
        elif name == "Fusion":
            inc_list = tuple(ch_list[x] for x in f)
            module = B.Fusion(inc_list, _arg(args, 0, "bifpn"))
        elif name == "Concat":
            c2 = sum(ch_list[x] for x in f)
            module = C.Concat()
        elif name == "nn.Upsample":
            module = nn.Upsample(size=_arg(args, 0, None), scale_factor=_arg(args, 1, 2),
                                 mode=_arg(args, 2, "nearest"))
        elif name in HEAD_MODULES:
            head_ch = tuple(ch_list[x] for x in f)
            head_nc = _arg(args, 0, nc)
            if name == "OBB":
                module = H.OBB(nc=head_nc, ne=_arg(args, 1, 1), ch=head_ch)
            elif name == "Detect":
                module = H.Detect(nc=head_nc, ch=head_ch)
            else:
                # dcn_radius: the top-level model-yaml key (checkpoint-aware:
                # load_checkpoint widens it to cover a checkpoint's offsets)
                module = H.AYHead(nc=head_nc, ch=head_ch,
                                  dcn_radius=float(d.get("dcn_radius", 3.0)))
            c2 = 0
        else:
            raise KeyError(
                f"yaml module '{name}' (layer {i}) is not implemented in yolo_ad_refine_tpu_torch")

        specs.append(LayerSpec(i=i, f=f, name=name, n=n_orig, c2=c2, module=module,
                               is_head=name in HEAD_MODULES, args=args))
        save.update(x % i for x in ([f] if isinstance(f, int) else list(f)) if x != -1)
        if verbose:
            LOGGER.info(f"{i:>3}{str(f):>20}{n_orig:>3}  {name:<45}{str(args):<30}")
        if i == 0:
            ch_list = []
        ch_list.append(c2)

    meta = {"nc": nc, "save": sorted(save), "scale": scale, "depth": depth, "width": width,
            "ch": ch_list}
    return specs, meta
