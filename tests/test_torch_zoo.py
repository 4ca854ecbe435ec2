"""The stock model zoo in the PyTorch port against the JAX package, fp32
on the CPU; the model for the cases is ``tests/test_zoo.py``.

- Each of the seven bundled yamls (yolov8, -seg, -pose, -obb, yolov5,
  yolov3, yolov9c) is byte-identical to the JAX file, builds by its
  unified name (``yolov8n.yaml`` -> ``yolov8.yaml`` at scale n), has the
  JAX model's parameter count and the JAX variables' exact leaf layout
  (every port tensor's flax leaf at its shape, every flax leaf used: what
  the strict loader checks), counted on abstract shapes
  (``jax.eval_shape``), as the full yolov3 (98.5 M parameters) and
  yolov9c (21.4 M) would take minutes to compile.
- Their outputs after a strict load of numpy-randomised weights equal the
  JAX model's at imgsz 64: the eval output (decoded predictions and the
  head's maps) at rtol / atol 1e-4, the flagship's tolerance
  (``tests/test_torch_slice.py``), and the train-mode maps (batch
  statistics over 2 images) at 1e-3 of the largest |JAX| value. yolov3 and
  yolov9c run as a copy of their yaml dict narrowed by an added ``scales``
  entry (yolov9c's GELAN rows also have their c3 / c4 arguments divided:
  the parser width-scales only c2), with yolov3's 8-block Bottleneck rows
  kept as chains of 3.
- One backward through the narrowed yolov9c (every block of it) in train
  mode: each parameter's gradient of the maps' mean squares against
  ``jax.grad``: the port within 1e-4 of the same step in fp64, or within
  4 times the JAX step's distance from it.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import jax_shapes, randomize
from yolo_ad_refine_tpu.models.model import DetectionModel as JaxDetectionModel
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.models.parser import load_model_cfg, resolve_cfg
from yolo_ad_refine_tpu_torch.nn.block import SequentialBlocks
from yolo_ad_refine_tpu_torch.utils.jax_weights import (
    flatten_tree, jax_leaf_map, jax_to_port, load_jax_variables)

REPO = Path(__file__).resolve().parents[1]
IMGSZ = 64
# name -> (bundled file, task, the JAX parameter count at nc 80 (pose: nc 1) where known)
ZOO = {
    "yolov8n.yaml": ("yolov8.yaml", "detect", 2_724_432),
    "yolov8n-seg.yaml": ("yolov8-seg.yaml", "segment", 2_977_200),
    "yolov8n-pose.yaml": ("yolov8-pose.yaml", "pose", None),
    "yolov8n-obb.yaml": ("yolov8-obb.yaml", "obb", None),
    "yolov5n.yaml": ("yolov5.yaml", "detect", 2_222_048),
    "yolov3.yaml": ("yolov3.yaml", "detect", 98_539_408),
    "yolov9c.yaml": ("yolov9c.yaml", "detect", 21_419_120),
}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _leaves(out):
    """The arrays of a model output (either side's), in order; the port's
    NCHW maps as NHWC."""
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in _leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _leaves(o)]
    if isinstance(out, torch.Tensor):
        a = out.detach().numpy()
        return [a.transpose(0, 2, 3, 1) if a.ndim == 4 else a]
    return [np.asarray(out)]


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_yaml_builds_by_name_with_the_jax_layout(name):
    bundled, task, count = ZOO[name]
    ours = REPO / "yolo_ad_refine_tpu_torch" / "cfg" / "models" / bundled
    assert ours.read_bytes() == (REPO / "yolo_ad_refine_tpu" / "cfg" / "models" /
                                 bundled).read_bytes()
    assert resolve_cfg(name) == ours
    with torch.device("meta"):
        port = DetectionModel(load_model_cfg(name))
    assert port.task == task
    _, shapes = jax_shapes(name, 64)
    flat = {(c, k): tuple(v.shape) for c in ("params", "batch_stats")
            for k, v in flatten_tree(shapes[c]).items()}
    n_jax = sum(int(np.prod(s)) for (c, _), s in flat.items() if c == "params")
    assert port.num_params() == n_jax
    if count is not None:
        assert n_jax == count
    used, errors = set(), []
    for pname, _, targets in jax_leaf_map(port):
        for coll, key, _, fshape in targets:
            if (coll, key) not in flat:
                errors.append(f"no flax leaf {coll}:{key} for {pname}")
            elif fshape is not None and tuple(fshape) != flat[(coll, key)]:
                errors.append(f"{pname}: {fshape} != {flat[(coll, key)]}")
            used.add((coll, key))
    assert not errors, errors[:5]
    assert used == set(flat), sorted(set(flat) - used)[:5]


def test_yolov3_rows_become_bottleneck_chains():
    """yolov3's rows of 2, 4 and 8 Bottlenecks are chains of distinct blocks
    (``blocks.i``, flax's ``blocks_i``); its rows of 1 stay one block."""
    with torch.device("meta"):
        port = DetectionModel(load_model_cfg("yolov3.yaml"))
    chains = {i: len(m.blocks) for i, m in enumerate(port.model) if isinstance(m, SequentialBlocks)}
    assert chains == {4: 2, 6: 8, 8: 8, 10: 4, 27: 2}
    assert type(port.model[2]).__name__ == "Bottleneck"


def test_yolo_facade_builds_the_zoo_by_scale():
    """``YOLO`` resolves a scaled name and takes the head's task."""
    m = YOLO("yolov8s-seg.yaml", device="cpu", imgsz=IMGSZ)
    _, shapes = jax_shapes("yolov8s-seg.yaml", IMGSZ)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    assert m.task == "segment" and m.model.num_params() == n_jax == 10_524_400
    assert m.model.strides == (8, 16, 32)
    with pytest.raises(FileNotFoundError):
        YOLO("yolov8n-nope.yaml", device="cpu")


def _narrow(name):
    """A copy of a yaml dict narrowed for a cheap JAX compile."""
    d = copy.deepcopy(JaxDetectionModel(name).yaml)
    d.pop("yaml_file", None)
    if name == "yolov3.yaml":
        d["scales"], d["scale"] = {"t": [0.34, 0.0625, 1024]}, "t"
    elif name == "yolov9c.yaml":
        d["scales"], d["scale"] = {"t": [1.0, 0.125, 1024]}, "t"
        for row in d["backbone"] + d["head"]:
            if row[2] in ("RepNCSPELAN4", "SPPELAN"):
                row[3] = [row[3][0], *(a // 8 for a in row[3][1:3]), *row[3][3:]]
    return d


def _cfg(name):
    return _narrow(name) if name in ("yolov3.yaml", "yolov9c.yaml") else name


@pytest.fixture(scope="module")
def built():
    """{name: (JAX model with randomised variables, port model)} built lazily."""
    cache = {}

    def get(name):
        if name not in cache:
            jm, shapes = jax_shapes(_cfg(name), IMGSZ)
            variables = randomize(shapes, seed=5)
            jm.variables = jax.tree.map(jnp.asarray, variables)
            port = DetectionModel(copy.deepcopy(jm.yaml))
            load_jax_variables(port, flatten_tree(variables["params"]),
                               flatten_tree(variables["batch_stats"]))
            port.strides = (8, 16, 32)
            jm.strides = (8, 16, 32)
            cache[name] = (jm, variables, port.eval())
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_outputs_match_jax(built, name):
    jm, _, port = built(name)
    if name == "yolov3.yaml":
        assert any(isinstance(m, SequentialBlocks) and len(m.blocks) == 3 for m in port.model)
    x = np.random.default_rng(2).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    # one compile for both modes
    (want, want_train) = jax.jit(lambda v, a: (jm.apply(v, a, train=False),
                                               jm.apply(v, a, train=True, mutable=True)[0]))(
        jm.variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(_nchw(x))
        port.train()
        got_train = port(_nchw(x))
        port.eval()
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w) >= 4
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    g, w = _leaves(got_train), _leaves(want_train)
    assert len(g) == len(w) >= 3
    for a, b in zip(g, w):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()


def test_yolov9c_gradients_match_jax(built):
    """The port's fp32 step within 1e-4 (relative norm) of the same step
    in fp64, or within 4 times the JAX fp32 step's distance from it, leaf
    by leaf and for the loss. Random weights and batch statistics over 2
    images (8 values a channel at P5) put the fp32 gradients 1e-3 to 1e-1
    from fp64 on most leaves, the JAX step's up to 10 times further than
    the port's (so the v10 file's two-sided rule, which also bounds the
    JAX side by the port's, does not apply)."""
    jm, variables, port = built("yolov9c.yaml")
    x = np.random.default_rng(3).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)

    def loss(params):
        feats, _ = jm.graph.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  jnp.asarray(x), train=True, mutable=["batch_stats"])
        return sum(jnp.mean(f * f) for f in feats)

    jl, jg = jax.jit(jax.value_and_grad(loss))(jm.variables["params"])
    model, model64 = copy.deepcopy(port).train(), copy.deepcopy(port).double().train()
    total = sum((f * f).mean() for f in model(_nchw(x)))
    total.backward()
    total64 = sum((f * f).mean() for f in model64(_nchw(x).double()))
    total64.backward()

    def within(port_off, jax_off, lim):
        return port_off <= max(lim, 4 * jax_off)

    ex = total64.item()
    assert within(abs(total.item() - ex), abs(float(jl) - ex), 1e-4 * abs(ex))
    want = jax_to_port(model, flatten_tree(jax.tree.map(np.asarray, jg)),
                       collections=("params",))
    named, named64 = dict(model.named_parameters()), dict(model64.named_parameters())
    assert want.keys() == named.keys()
    bad = []
    for k, w in want.items():
        exact = named64[k].grad.numpy()
        port_off = np.linalg.norm(named[k].grad.numpy() - exact)
        jax_off = np.linalg.norm(w - exact)
        if not within(port_off, jax_off, 1e-4 * np.linalg.norm(exact)):
            bad.append(f"{k}: |port - fp64| {port_off:.2e}, |jax - fp64| {jax_off:.2e}")
    assert not bad, bad[:5]
