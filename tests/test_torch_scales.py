"""The flagship at every published scale, JAX package against the port.

``yolo11{s,m,l,x}-701-YOLO-AD-Refine.yaml`` resolve to the flagship yaml
at that scale's depth, width and channel cap (``models/parser.py``). For
each scale the JAX model's variables are taken by shape alone
(``jax.eval_shape``: no XLA compile of the forward), filled from a numpy
seed and loaded strictly into the port, which must have the same leaves
and parameter count. The AYHead's DCN runs at ``max(ch) // 2`` channels,
C = Cout = 128 at scale s, 256 at m and l and 384 at x: the widths whose
backward runs K1 bwd's wide path on the card from scale m on.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_weights import jax_shapes, randomize
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.models.parser import load_model_cfg
from yolo_ad_refine_tpu_torch.ops.deform import k1_launch
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables


@pytest.mark.parametrize("scale,dcn_width,wide", [("s", 128, False), ("m", 256, True),
                                                  ("l", 256, True), ("x", 384, True)])
def test_flagship_scale_loads_jax_leaves(scale, dcn_width, wide):
    name = f"yolo11{scale}-701-YOLO-AD-Refine.yaml"
    _, shapes = jax_shapes(name, 256)
    variables = randomize(shapes, seed=1)
    port = DetectionModel(load_model_cfg(name))
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))  # strict: every leaf, both ways
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert port.num_params() == n_jax
    head = port.model[port.head_idx]
    w = head.DyDCNV2.conv.weight
    assert tuple(w.shape) == (dcn_width, dcn_width, 3, 3)
    assert k1_launch("bwd", dcn_width, dcn_width, torch.float32)["wide"] == wide
    # the loaded DCN weight holds the seeded values (HWIO in JAX), not the port's own init
    leaf = next(v for k, v in flatten_tree(variables["params"]).items()
                if k.endswith("DyDCNV2/weight"))
    np.testing.assert_array_equal(w.detach().permute(2, 3, 1, 0).numpy(), leaf)
