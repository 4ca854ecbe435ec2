"""Yaml -> layer-graph compiler.

Counterpart of ``yolo_ad_refine_tpu/models/parser.py`` (reference
ultralytics/nn/tasks.py:943-1108 parse_model): the same channel
bookkeeping, for the modules this port has so far.

- depth gain: n = max(round(n * depth), 1) for n > 1
- width gain: c2 = make_divisible(min(c2, max_channels) * width, 8) unless
  c2 == nc, for the conv family including bare nn.Conv2d /
  nn.ConvTranspose2d rows (fork extension)
- yaml-level variables (``head_channel``, ``fusion_mode``, ``kpt_shape``)
  resolved by name
- Segment's proto channels ``npr`` width-scaled and capped at max_channels
- HGBlock and RepC3 take the row's repeats as their inner ``n``; the
  RTDETRDecoder row's extras after nc are hd, nq, ndl and d_ffn
- C3k2 forces c3k=True at scales m/l/x
- a Bottleneck row of n > 1 repeats becomes a chain of n distinct blocks
  (``SequentialBlocks``); RepNCSPELAN4 takes its repeats from its 4th
  argument, max(round(n * depth), 1); the GELAN rows width-scale only c2;
  CBAM and its two gates keep their input's channels
- C2fAttn's embed channels and head count take their own width gains
  (reference tasks.py:1021-1024); ImagePoolingAttn keeps the channels of
  its first input, and its output replaces the text stream
  (``models/model.py``)
- the attention rows (``nn/attention.py``, ``nn/attention_zoo.py``,
  ``nn/dsan.py``) keep their input's channels; a ``concat`` Fusion gives
  the sum of its inputs' channels, any other mode its first input's
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from torch import nn

from yolo_ad_refine_tpu_torch.nn import attention, attention_zoo, dsan  # noqa: F401 (registry)
from yolo_ad_refine_tpu_torch.nn import block as B
from yolo_ad_refine_tpu_torch.nn import common as C
from yolo_ad_refine_tpu_torch.nn import conv_extras as CE
from yolo_ad_refine_tpu_torch.nn import head as H
from yolo_ad_refine_tpu_torch.nn import transformer as TR
from yolo_ad_refine_tpu_torch.nn import tssa as T
from yolo_ad_refine_tpu_torch.nn.common import make_divisible
from yolo_ad_refine_tpu_torch.nn.registry import MODULE_REGISTRY
from yolo_ad_refine_tpu_torch.utils import LOGGER, ROOT, yaml_load

HEAD_MODULES = {"Detect", "AYHead", "AYHead1", "OBB", "Segment", "Pose", "Classify",
                "v10Detect", "WorldDetect", "RTDETRDecoder"}
# modules whose first yaml arg is an out-channel subject to width scaling
WIDTH_SCALED = {"Conv", "DWConv", "SPPF", "SPP", "C2f", "C3", "C3k2", "C2PSA", "C3k2_MLCA",
                "C2TSSA_DYT_Mona_EDFFN", "C2SFA", "C2PTSSA", "C2PSA_EDFFN",
                "C2AdaptiveTSSA_Enhanced", "C2ProgressiveTSSA_Fusion1", "nn.Conv2d",
                "nn.ConvTranspose2d", "C2fAttn", "GSConv", "SCDown", "C2fCIB", "PSA", "Bottleneck",
                "Conv2", "LightConv", "Focus", "GhostConv", "RepConv"}
# YOLOv9's GELAN rows: c2 width-scaled, their other channel arguments as written
GELAN_MODULES = {"RepNCSPELAN4", "ELAN1", "ADown", "AConv", "SPPELAN"}
# channel-keeping attention gates of nn/conv_extras.py
GATE_MODULES = {"CBAM", "ChannelAttention", "SpatialAttention"}
# rows that read YOLO-World's text stream: a graph with them has text embeddings
TEXT_MODULES = {"C2fAttn", "ImagePoolingAttn"}
CSP_MODULES = {"C2f": B.C2f, "C3": B.C3, "C3k2": B.C3k2, "C3k2_MLCA": B.C3k2MLCA}
PSA_MODULES = {"C2PSA": B.C2PSA, "C2PTSSA": T.C2PTSSA, "C2TSSA_DYT_Mona_EDFFN": T.C2TSSADyTMonaEDFFN,
               "C2SFA": T.C2SFA, "C2PSA_EDFFN": T.C2PSAEDFFN,
               "C2AdaptiveTSSA_Enhanced": T.C2AdaptiveTSSAEnhanced,
               "C2ProgressiveTSSA_Fusion1": T.C2ProgressiveTSSAFusion1}
# channel-keeping attention rows (JAX models/parser.py:341-372), built from
# the registry with their input's channels
ATTENTION_MODULES = {
    "EMA", "SimAM", "TripletAttention", "LSKBlock", "SEAttention", "EfficientChannelAttention",
    "SpatialGroupEnhance", "EffectiveSEModule", "ELA", "CAA", "MPCA", "AFGCAttention",
    "BAMBlock", "LSKBlockSA", "LSKA", "SegNext_Attention", "CPCA", "deformable_LKA",
    "DAttention", "FocusedLinearAttention", "CascadedGroupAttention", "LocalWindowAttention",
    "DualDomainSelectionMechanism", "EfficientAttention", "BiLevelRoutingAttention",
    "BiLevelRoutingAttention_nchw", "DSAN", "DSA"}


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
    text_graph = any(row[2] in TEXT_MODULES for row in d["backbone"] + d["head"])

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
            elif name == "DWConv":
                # torch signature: (c2, k, s, d, act)
                module = C.DWConv(c1, c2, _arg(rest, 0, 1), _arg(rest, 1, 1), _arg(rest, 2, 1),
                                  _arg(rest, 3, True))
            elif name == "SPPF":
                module = B.SPPF(c1, c2, _arg(rest, 0, 5))
            elif name == "SPP":
                module = B.SPP(c1, c2, tuple(_arg(rest, 0, (5, 9, 13))))
            elif name == "Bottleneck":
                # a YOLOv3 row of n > 1 becomes a chain of n distinct blocks
                shortcut = _arg(rest, 0, True)
                blocks = [B.Bottleneck(c1 if j == 0 else c2, c2, shortcut) for j in range(n)]
                module = B.SequentialBlocks(blocks) if n > 1 else blocks[0]
            elif name == "Conv2":
                module = CE.Conv2(c1, c2, _arg(rest, 0, 3), _arg(rest, 1, 1))
            elif name == "LightConv":
                module = CE.LightConv(c1, c2, _arg(rest, 0, 1))
            elif name in ("Focus", "GhostConv", "RepConv"):
                module = getattr(CE, name)(c1, c2, _arg(rest, 0, 3 if name == "RepConv" else 1),
                                           _arg(rest, 1, 1))
            elif name in ("C2f", "C3"):
                module = CSP_MODULES[name](c1, c2, n, _arg(rest, 0, name == "C3"))
            elif name in ("C3k2", "C3k2_MLCA"):
                c3k = _arg(rest, 0, False)
                if name == "C3k2" and scale in ("m", "l", "x"):
                    c3k = True  # reference tasks.py:1050-1051
                module = CSP_MODULES[name](c1, c2, n, c3k=c3k, e=_arg(rest, 1, 0.5),
                                           shortcut=_arg(rest, 2, True))
            elif name == "SCDown":
                module = CE.SCDown(c1, c2, _arg(rest, 0, 3), _arg(rest, 1, 2))
            elif name == "C2fCIB":
                module = CE.C2fCIB(c1, c2, n, shortcut=_arg(rest, 0, False),
                                   lk=_arg(rest, 1, False))
            elif name == "PSA":
                module = CE.PSA(c1, c2, _arg(rest, 0, 0.5))
            elif name == "GSConv":
                module = B.GSConv(c1, c2, _arg(rest, 0, 1), _arg(rest, 1, 1))
            elif name == "C2fAttn":
                # reference tasks.py:1021-1024: the embed channels and the head
                # count take their own width gains
                ec = make_divisible(min(_arg(rest, 0, 128), max_channels / 2) * width, 8)
                nh = _arg(rest, 1, 1)
                if nh > 1:
                    nh = int(max(round(min(nh, max_channels / 64)) * width, 1))
                module = B.C2fAttn(c1, c2, n, ec=ec, nh=nh, gc=_arg(rest, 2, 512))
            elif name in PSA_MODULES:
                e = _arg(rest, 0, 0.5)
                module = PSA_MODULES[name](c1, c2, n, e if isinstance(e, float) else 0.5)
            elif name == "nn.Conv2d":
                module = C.plain_conv2d(c1, c2, _arg(rest, 0, 1), _arg(rest, 1, 1))
            else:  # nn.ConvTranspose2d
                module = C.plain_conv_transpose2d(c1, c2, _arg(rest, 0, 3), _arg(rest, 1, 2),
                                                  _arg(rest, 2, 1), _arg(rest, 3, 1))
        elif name in GELAN_MODULES:
            c2 = args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            if name == "RepNCSPELAN4":
                # its repeats come from its own 4th argument, not the row's n
                module = CE.RepNCSPELAN4(c1, c2, args[1], args[2],
                                         n=max(round(_arg(args, 3, 1) * depth), 1))
            elif name == "ELAN1":
                module = CE.ELAN1(c1, c2, args[1], args[2])
            elif name == "SPPELAN":
                module = CE.SPPELAN(c1, c2, args[1], _arg(args, 2, 5))
            else:
                module = getattr(CE, name)(c1, c2)
        elif name in GATE_MODULES:
            if name == "CBAM":
                module = CE.CBAM(c1, _arg(args, 1, 7))
            elif name == "ChannelAttention":
                module = CE.ChannelAttention(c1)
            else:
                module = CE.SpatialAttention(_arg(args, 0, 7))
        elif name in ATTENTION_MODULES:
            module = MODULE_REGISTRY[name](c1)
        elif name == "ImagePoolingAttn":
            # the text-refinement row (reference tasks.py:1082, its ec unscaled):
            # its output replaces the text stream; the rows after it route
            # around it by index
            module = B.ImagePoolingAttn(ec=_arg(args, 0, 256), ch=tuple(ch_list[j] for j in f))
            c2 = ch_list[f[0]]
        elif name == "HGStem":
            c2 = args[1]
            module = B.HGStem(c1, args[0], c2)
        elif name == "HGBlock":
            # yaml: [cm, c2, k, lightconv, shortcut]; the repeats become the inner n
            c2 = args[1]
            module = B.HGBlock(c1, args[0], c2, _arg(args, 2, 3), n, _arg(args, 3, False),
                               _arg(args, 4, False))
        elif name == "RepC3":
            c2 = args[0]
            module = B.RepC3(c1, c2, n, _arg(args, 1, 1.0))
        elif name == "AIFI":
            module = TR.AIFI(c1, _arg(args, 0, 2048), _arg(args, 1, 8))
        elif name == "ELA_HSFPN":
            module = B.ELAHSFPN(c1, _arg(args, 0, True))
        elif name == "Multiply":
            module = B.Multiply()
        elif name == "Add":
            module = B.Add()
        elif name == "Fusion":
            inc_list = tuple(ch_list[x] for x in f)
            mode = _arg(args, 0, "bifpn")
            c2 = sum(inc_list) if mode == "concat" else inc_list[0]
            module = B.Fusion(inc_list, mode)
        elif name == "Concat":
            c2 = sum(ch_list[x] for x in f)
            module = C.Concat()
        elif name == "nn.Upsample":
            module = nn.Upsample(size=_arg(args, 0, None), scale_factor=_arg(args, 1, 2),
                                 mode=_arg(args, 2, "nearest"))
        elif name == "Classify":
            c2 = _arg(args, 0, nc)
            module = H.Classify(c1, nc=c2)
        elif name in HEAD_MODULES:
            head_ch = tuple(ch_list[x] for x in f)
            head_nc = _arg(args, 0, nc)
            if name == "v10Detect":
                module = H.v10Detect(nc=head_nc, ch=head_ch)
            elif name == "RTDETRDecoder":
                # optional extras after nc (JAX models/parser.py:294-302): hd, nq,
                # ndl, d_ffn, which tiny test configs shrink
                extra = {k: int(v) for k, v in zip(("hd", "nq", "ndl", "d_ffn"), args[1:])}
                module = TR.RTDETRDecoder(nc=head_nc, ch=head_ch, **extra)
            elif name == "WorldDetect":
                # the learned default_text exists only where no row gives text
                module = H.WorldDetect(nc=head_nc, embed=_arg(args, 1, 512),
                                       with_bn=_arg(args, 2, True), ch=head_ch,
                                       default_text=not text_graph)
            elif name == "OBB":
                module = H.OBB(nc=head_nc, ne=_arg(args, 1, 1), ch=head_ch)
            elif name == "Segment":
                # reference tasks.py:1041: the proto channels are width-scaled
                npr = make_divisible(min(_arg(args, 2, 256), max_channels) * width, 8)
                module = H.Segment(nc=head_nc, nm=_arg(args, 1, 32), npr=npr, ch=head_ch)
            elif name == "Pose":
                module = H.Pose(nc=head_nc, kpt_shape=tuple(_arg(args, 1, (17, 3))), ch=head_ch)
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
