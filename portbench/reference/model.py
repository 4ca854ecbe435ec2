"""The flagship detector built from its yaml in plain PyTorch: the reference
that a cell's outputs are judged by.

``build(yaml_path, scale)`` reads the frozen model yaml beside this file
(byte-identical to the port's ``cfg/models/yolo11-701-YOLO-AD-Refine.yaml``
and to the paper's ``z-yaml/`` file) and builds the rows the flagship uses,
with the port's parser's channel arithmetic (``models/parser.py``, copied
for these rows only). ``Detector.forward`` runs the rows in order as the
port's ``DetectionModel`` does: eval mode returns (y, maps), y (B, N, 4+nc)
xywh input pixels and sigmoided scores; train mode the per-level maps.
With ``checkpointed`` True (training) each row runs under activation
checkpointing, so that an fp32 step at the cell's batch fits the card.
"""

from __future__ import annotations

import ast
from pathlib import Path

import torch
import yaml
from torch import nn
from torch.utils.checkpoint import checkpoint

from portbench.reference import modules as M

WIDTH_SCALED = {"Conv", "SPPF", "C3k2", "C3k2_MLCA", "C2PTSSA", "nn.Conv2d", "nn.ConvTranspose2d"}


def _substitute(args: list, variables: dict) -> list:
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


def parse(d: dict, scale: str, ch: int = 3):
    """[(from, module)] of the yaml's rows at ``scale``, and the save set."""
    nc = d.get("nc", 80)
    depth, width, max_channels = d["scales"][scale]
    variables = {k: v for k, v in d.items() if k not in ("backbone", "head", "scales")}
    ch_list, rows, save = [ch], [], set()
    for i, (f, n, name, args) in enumerate(d["backbone"] + d["head"]):
        args = _substitute(list(args), variables)
        n = max(round(n * depth), 1) if n > 1 else n
        c1 = ch_list[f] if isinstance(f, int) else ch_list[f[0]]
        c2 = c1
        if name in WIDTH_SCALED:
            c2 = args[0]
            if c2 != nc:
                c2 = M.make_divisible(min(c2, max_channels) * width, 8)
            rest = args[1:]
            if name == "Conv":
                m = M.Conv(c1, c2, _arg(rest, 0, 1), _arg(rest, 1, 1), _arg(rest, 2, None),
                           _arg(rest, 3, 1), _arg(rest, 4, 1), _arg(rest, 5, True))
            elif name == "SPPF":
                m = M.SPPF(c1, c2, _arg(rest, 0, 5))
            elif name in ("C3k2", "C3k2_MLCA"):
                c3k = _arg(rest, 0, False)
                if name == "C3k2" and scale in ("m", "l", "x"):
                    c3k = True
                cls = M.C3k2 if name == "C3k2" else M.C3k2MLCA
                m = cls(c1, c2, n, c3k=c3k, e=_arg(rest, 1, 0.5), shortcut=_arg(rest, 2, True))
            elif name == "C2PTSSA":
                e = _arg(rest, 0, 0.5)
                m = M.C2PTSSA(c1, c2, n, e if isinstance(e, float) else 0.5)
            elif name == "nn.Conv2d":
                m = nn.Conv2d(c1, c2, _arg(rest, 0, 1), _arg(rest, 1, 1), 0, bias=True)
            else:
                m = nn.ConvTranspose2d(c1, c2, _arg(rest, 0, 3), _arg(rest, 1, 2),
                                       _arg(rest, 2, 1), output_padding=_arg(rest, 3, 1),
                                       bias=True)
        elif name == "ELA_HSFPN":
            m = M.ELAHSFPN(c1, _arg(args, 0, True))
        elif name == "Multiply":
            m = M.Multiply()
        elif name == "Add":
            m = M.Add()
        elif name == "Fusion":
            inc = tuple(ch_list[x] for x in f)
            m = M.Fusion(inc, _arg(args, 0, "bifpn"))
            c2 = inc[0]
        elif name in ("AYHead", "AYHead1"):
            m = M.AYHead(nc=_arg(args, 0, nc), ch=tuple(ch_list[x] for x in f),
                         dcn_radius=float(d.get("dcn_radius", 3.0)))
            c2 = 0
        else:
            raise KeyError(f"row {i}: {name} is not a row of the flagship")
        rows.append((f, m))
        save.update(x % i for x in ([f] if isinstance(f, int) else list(f)) if x != -1)
        if i == 0:
            ch_list = []
        ch_list.append(c2)
    return rows, save, nc


class Detector(nn.Module):
    def __init__(self, d: dict, scale: str):
        super().__init__()
        rows, save, self.nc = parse(d, scale)
        self.model = nn.ModuleList(m for _, m in rows)
        self.froms = [f for f, _ in rows]
        self.save = save
        self.checkpointed = False

    def _run(self, i: int, inp, input_h: int):
        m = self.model[i]
        kw = {"input_h": input_h} if i == len(self.model) - 1 else {}
        if self.checkpointed and torch.is_grad_enabled():
            return checkpoint(m, inp, use_reentrant=False, **kw)
        return m(inp, **kw)

    def forward(self, x):
        input_h = x.shape[2]
        ys, out = [], x
        for i, f in enumerate(self.froms):
            inp = out if f == -1 else (ys[f % i] if isinstance(f, int)
                                       else [out if j == -1 else ys[j % i] for j in f])
            out = self._run(i, inp, input_h)
            ys.append(out if i in self.save else None)
        return out

    @property
    def head(self) -> M.AYHead:
        return self.model[-1]


def build(yaml_path: str | Path, scale: str, device="cpu") -> Detector:
    """The flagship at ``scale`` with its constructors' weights, on ``device``
    (``meta`` builds no storage). Its strides are the AYHead's (8, 16, 32)."""
    d = yaml.safe_load(Path(yaml_path).read_text())
    with torch.device(device):
        return Detector(d, scale)
