"""Weight transfer between the JAX package and its PyTorch port.

Also holds the helpers the other ``test_torch_*`` files share: every JAX
param and batch_stat is randomised with numpy before a transfer, because
init values (BN stats 0/1, Fusion and Scale weights 1) would hide a
mis-mapped leaf.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from yolo_ad_refine_tpu.models.model import DetectionModel as JaxDetectionModel
from yolo_ad_refine_tpu.utils.torch_import import import_torch_state_dict
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.nn.common import Conv
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = "yolo11-701-YOLO-AD-Refine.yaml"


def randomize(variables, seed: int = 0):
    """Numpy-random copy of a flax variables tree (params + batch_stats).
    Kernels ~ N(0, 1/fan_in), norm scales and positive weights in
    [0.5, 1.5], biases and means ~ N(0, 0.2^2), variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        shape = tuple(x.shape)
        name = path[-1]
        if name == "kernel" or (name == "weight" and len(shape) == 4):
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            if len(shape) == 3 and path[-2] in ("query", "key", "value"):
                fan_in = shape[0]
            v = rng.normal(0.0, 1.0 / np.sqrt(max(fan_in, 1)), shape)
        elif name in ("bias", "mean"):
            v = rng.normal(0.0, 0.2, shape)
        else:  # scale, var, alphas, temps, fusion_weight, fft, scale{i}, ...
            v = rng.uniform(0.5, 1.5, shape)
        return np.asarray(v, np.float32)

    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else leaf(path + (k,), v)
                for k, v in tree.items()}

    return {c: walk(dict(variables[c])) for c in ("params", "batch_stats") if c in variables}


def transfer(port_module: nn.Module, variables: dict, wrap: bool = True) -> nn.Module:
    """Load (randomised) flax variables into a port module. ``wrap`` puts
    a single module at yaml row 0 (``model.0``), as a model would."""
    target = port_module
    if wrap:
        target = nn.Module()
        target.model = nn.ModuleList([port_module])
        variables = {c: {"modules_0": v} for c, v in variables.items()}
    load_jax_variables(target, flatten_tree(variables["params"]),
                       flatten_tree(variables.get("batch_stats", {})))
    return port_module.eval()


def jax_shapes(cfg: str, imgsz: int):
    """The JAX model and its variables' shapes, without running init."""
    m = JaxDetectionModel(cfg)
    shapes = jax.eval_shape(
        lambda: m.graph.init(jax.random.PRNGKey(0), jnp.zeros((1, imgsz, imgsz, 3)), train=False))
    return m, {c: shapes[c] for c in ("params", "batch_stats")}


def test_yaml_copies_identical():
    for name in (FLAGSHIP, "yolo11.yaml", "yolo11-obb.yaml"):
        ours = (REPO / "yolo_ad_refine_tpu_torch" / "cfg" / "models" / name).read_bytes()
        ref = (REPO / "yolo_ad_refine_tpu" / "cfg" / "models" / name).read_bytes()
        assert ours == ref, name


def _conv_case():
    from yolo_ad_refine_tpu.nn.common import Conv as JConv

    v = JConv(16, 3).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8)))
    return randomize(v)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_strict_transfer_raises(fault):
    v = _conv_case()
    if fault == "missing":
        del v["batch_stats"]["bn"]["var"]
    elif fault == "extra":
        v["params"]["bn"]["stray"] = np.zeros(16, np.float32)
    else:
        v["params"]["conv"]["kernel"] = np.zeros((3, 3, 8, 8), np.float32)
    with pytest.raises(KeyError):
        transfer(Conv(8, 16, 3), v)


def test_transfer_fills_every_tensor():
    v = _conv_case()
    m = transfer(Conv(8, 16, 3), v)
    np.testing.assert_array_equal(m.conv.weight.detach().numpy(),
                                  v["params"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(m.bn.running_var.numpy(), v["batch_stats"]["bn"]["var"])
    np.testing.assert_array_equal(m.bn.weight.detach().numpy(), v["params"]["bn"]["scale"])


@pytest.mark.parametrize("cfg,imgsz", [(FLAGSHIP, 128), ("yolo11n.yaml", 64)])
def test_state_dict_round_trips_through_reference_importer(cfg, imgsz):
    """The port's state_dict carries reference-style names: the JAX
    package's torch importer places every one of them back on its leaf."""
    jm, shapes = jax_shapes(cfg, imgsz)
    rand = randomize(shapes, seed=1)
    port = DetectionModel(cfg)
    load_jax_variables(port, flatten_tree(rand["params"]), flatten_tree(rand["batch_stats"]))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    back = import_torch_state_dict(
        {k: v.detach().numpy() for k, v in port.state_dict().items()}, zeros, strict=True,
        deconv_layers=jm.deconv_layer_indices)
    assert port.deconv_layer_indices == jm.deconv_layer_indices
    flat_back = {c: flatten_tree(back[c]) for c in ("params", "batch_stats")}
    for c in ("params", "batch_stats"):
        flat_rand = flatten_tree(rand[c])
        assert flat_back[c].keys() == flat_rand.keys()
        for k, a in flat_rand.items():
            np.testing.assert_array_equal(np.asarray(flat_back[c][k]), a, err_msg=f"{c}:{k}")
