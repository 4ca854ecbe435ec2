"""Every yaml module name the JAX parser accepts builds in the port's
parser, with the JAX parameter count, row for row.

The names are read from the JAX parser's own source
(``yolo_ad_refine_tpu/models/parser.py``: its WIDTH_SCALED, REPEAT_MODULES
and HEAD_MODULES sets and every name its branches compare against), so a
name added there without a case here fails the coverage test. The rows
are built into a few small graphs at imgsz 56 (P3 is 7 x 7, the map
CascadedGroupAttention attends): one graph holds every single-input and
multi-input row, each reading P3 (Focus, whose space-to-depth takes even
sides, reads P2), and each head has a graph of its own. The JAX side is
counted on abstract shapes (``jax.eval_shape``), the port's on the meta
device. The port's registry holds every name of the JAX registry.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_ad_refine_tpu.models.model import DetectionModel as JaxDetectionModel
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree

REPO = Path(__file__).resolve().parents[1]
IMGSZ, NC = 56, 4

STEM = [[-1, 1, "Conv", [16, 3, 2]],   # 0  28 x 28
        [-1, 1, "Conv", [32, 3, 2]],   # 1  P2 14 x 14
        [-1, 1, "Conv", [64, 3, 2]],   # 2  P3 7 x 7
        [-1, 1, "Conv", [64, 3, 2]],   # 3  P4 4 x 4
        [-1, 1, "Conv", [64, 3, 2]]]   # 4  P5 2 x 2

# name -> (from, repeats, args) of its row in the rows graph
ROWS = {
    "Conv": (2, 1, [64, 3]), "DWConv": (2, 1, [64, 3]), "SPPF": (2, 1, [64, 5]),
    "SPP": (2, 1, [64, [5, 9, 13]]), "C2f": (2, 2, [64, True]), "C3": (2, 2, [64]),
    "C3k2": (2, 2, [64, False, 0.25]), "C2PSA": (2, 2, [64]), "C3k2_MLCA": (2, 2, [64, True]),
    "C2TSSA_DYT_Mona_EDFFN": (2, 2, [128]), "C2SFA": (2, 2, [64]), "C2PTSSA": (2, 2, [128]),
    "C2PSA_EDFFN": (2, 2, [64]), "C2AdaptiveTSSA_Enhanced": (2, 1, [128]),
    "C2ProgressiveTSSA_Fusion1": (2, 1, [64]), "nn.Conv2d": (2, 1, [64, 1]),
    "nn.ConvTranspose2d": (2, 1, [64, 3, 2, 1, 1]), "GSConv": (2, 1, [64, 3, 1]),
    "Conv2": (2, 1, [64, 3]), "LightConv": (2, 1, [64, 3]), "Focus": (1, 1, [64, 3]),
    "GhostConv": (2, 1, [64, 3]), "RepConv": (2, 1, [64, 3]), "SCDown": (2, 1, [64, 3, 2]),
    "C2fCIB": (2, 2, [64, True]), "PSA": (2, 1, [64]), "Bottleneck": (2, 3, [64]),
    "HGStem": (2, 1, [16, 32]), "HGBlock": (2, 2, [16, 64, 3]), "RepC3": (2, 2, [64]),
    "AIFI": (2, 1, [128, 4]), "RepNCSPELAN4": (2, 1, [64, 64, 32, 1]),
    "ELAN1": (2, 1, [64, 64, 32]), "ADown": (2, 1, [64]), "AConv": (2, 1, [64]),
    "SPPELAN": (2, 1, [64, 32]), "CBAM": (2, 1, [64, 7]), "ChannelAttention": (2, 1, [64]),
    "SpatialAttention": (2, 1, [7]), "ELA_HSFPN": (2, 1, []), "nn.Upsample": (2, 1, [None, 2]),
    "Multiply": ([2, 2], 1, []), "Add": ([2, 2, 2], 1, []), "Concat": ([2, 2, 2], 1, [1]),
    **{f"Fusion_{m}": ([2, 2], 1, [m]) for m in ("weight", "adaptive", "concat", "bifpn",
                                                  "SDI")},
    **{n: (2, 1, []) for n in (
        "EMA", "SimAM", "TripletAttention", "LSKBlock", "SEAttention",
        "EfficientChannelAttention", "SpatialGroupEnhance", "EffectiveSEModule", "ELA", "CAA",
        "MPCA", "AFGCAttention", "BAMBlock", "LSKBlockSA", "LSKA", "SegNext_Attention", "CPCA",
        "deformable_LKA", "DAttention", "FocusedLinearAttention", "CascadedGroupAttention",
        "LocalWindowAttention", "DualDomainSelectionMechanism", "EfficientAttention",
        "BiLevelRoutingAttention", "BiLevelRoutingAttention_nchw", "DSAN", "DSA")},
}
# head name -> its row
HEADS = {
    "Detect": [[2, 3, 4], 1, "Detect", [NC]],
    "AYHead": [[2, 3, 4], 1, "AYHead", [NC]],
    "AYHead1": [[2, 3, 4], 1, "AYHead1", [NC]],
    "Segment": [[2, 3, 4], 1, "Segment", [NC, 16, 64]],
    "Pose": [[2, 3, 4], 1, "Pose", [NC, [17, 3]]],
    "OBB": [[2, 3, 4], 1, "OBB", [NC, 1]],
    "v10Detect": [[2, 3, 4], 1, "v10Detect", [NC]],
    "RTDETRDecoder": [[2, 3, 4], 1, "RTDETRDecoder", [NC, 64, 30, 2, 128]],
    "Classify": [4, 1, "Classify", [NC]],
}
# the text-stream rows and head, in one YOLO-World graph
WORLD = [[2, 1, "C2fAttn", [64, 32, 2]],                  # 5
         [[5, 3, 4], 1, "ImagePoolingAttn", [64]],         # 6
         [[5, 3, 4], 1, "WorldDetect", [NC, 512, True]]]   # 7
WORLD_NAMES = ("C2fAttn", "ImagePoolingAttn", "WorldDetect")


def jax_parser_names() -> set:
    """The module names the JAX parser accepts, read from its source."""
    tree = ast.parse((REPO / "yolo_ad_refine_tpu" / "models" / "parser.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ("WIDTH_SCALED", "REPEAT_MODULES", "HEAD_MODULES")):
            parts = [node.value]
        elif (isinstance(node, ast.Compare) and isinstance(node.left, ast.Name)
              and node.left.id == "name"):
            parts = node.comparators
        else:
            continue
        names |= {c.value for p in parts for c in ast.walk(p)
                  if isinstance(c, ast.Constant) and isinstance(c.value, str)}
    return names


def _counts(cfg: dict):
    """{row index: parameter count} of the JAX graph and of the port's."""
    jm = JaxDetectionModel(dict(cfg))
    kw = {} if jm.text_feats is None else {"text_feats": jnp.asarray(jm.text_feats)}
    shapes = jax.eval_shape(lambda: jm.graph.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False, **kw))
    jax_rows: dict = {}
    for k, v in flatten_tree(shapes["params"]).items():
        i = int(k.split("/")[0].split("_")[1])
        jax_rows[i] = jax_rows.get(i, 0) + int(np.prod(v.shape))
    with torch.device("meta"):
        port = DetectionModel(dict(cfg))
    port_rows = {i: sum(p.numel() for p in m.parameters()) for i, m in enumerate(port.model)}
    return jax_rows, {i: n for i, n in port_rows.items() if n}


def _row(name):
    f, n, args = ROWS[name]
    return [f, n, name.split("_")[0] if name.startswith("Fusion_") else name, args]


@pytest.fixture(scope="module")
def rows_graph():
    names = list(ROWS)
    cfg = {"nc": NC, "backbone": STEM, "head": [_row(n) for n in names]
           + [[[2, 3, 4], 1, "Detect", [NC]]]}
    jax_rows, port_rows = _counts(cfg)
    return {n: (jax_rows.get(5 + i, 0), port_rows.get(5 + i, 0)) for i, n in enumerate(names)}


def test_every_jax_parser_name_has_a_case():
    covered = {n.split("_")[0] if n.startswith("Fusion_") else n for n in ROWS}
    covered |= set(HEADS) | set(WORLD_NAMES)
    missing = jax_parser_names() - covered
    assert not missing, sorted(missing)


@pytest.mark.parametrize("name", list(ROWS))
def test_row_builds_with_the_jax_parameter_count(rows_graph, name):
    n_jax, n_port = rows_graph[name]
    assert n_port == n_jax, (name, n_port, n_jax)


@pytest.mark.parametrize("name", list(HEADS))
def test_head_builds_with_the_jax_parameter_count(name):
    cfg = {"nc": NC, "backbone": STEM, "head": [HEADS[name]]}
    jax_rows, port_rows = _counts(cfg)
    assert port_rows == jax_rows and jax_rows[5] > 0


def test_world_rows_build_with_the_jax_parameter_count():
    cfg = {"nc": NC, "backbone": STEM, "head": WORLD}
    jax_rows, port_rows = _counts(cfg)
    assert port_rows == jax_rows and all(jax_rows[i] > 0 for i in (5, 6, 7))


def test_port_registry_holds_the_jax_registry():
    import yolo_ad_refine_tpu.models.parser  # noqa: F401
    from yolo_ad_refine_tpu.nn import attention, attention_zoo, dsan  # noqa: F401
    from yolo_ad_refine_tpu.nn.registry import MODULE_REGISTRY as JAX_REGISTRY
    from yolo_ad_refine_tpu_torch.nn.registry import MODULE_REGISTRY

    import yolo_ad_refine_tpu_torch.models.parser  # noqa: F401

    missing = set(JAX_REGISTRY) - set(MODULE_REGISTRY)
    assert not missing, sorted(missing)
