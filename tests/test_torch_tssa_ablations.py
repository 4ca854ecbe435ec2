"""The paper's TSSA / Mona ablation family in the PyTorch port against the
JAX package, fp32 on the CPU, with numpy-randomised weights and batch
statistics carried over by the strict loader.

- Each module of ``nn/tssa.py`` alone on an odd, non-square map
  (9 x 11; TSSA blocks at 128 channels, two 64-channel heads; the C2
  wrappers at c2 = 128, an inner width of 64, the narrowest that
  ``c // 64`` heads allow): eval within 1e-4 of the largest |JAX| value;
  train mode (batch statistics, Mona's dropout with JAX's own keep masks
  replayed into the port) the same, the updated running statistics
  within 1e-5.
- The ablation models, each the flagship yaml with layer 10 swapped (the
  697 model: ``C2TSSA_DYT_Mona_EDFFN``), at scale n: the JAX parameter
  counts, and at imgsz 256 the decoded predictions at rtol / atol 1e-4
  (the flagship's tolerance, ``tests/test_torch_slice.py``); the 697
  model also through ``YOLO(...).predict`` against the JAX facade
  (detections within 1e-3).
- The 697 state dict through the JAX importer (``import_torch_state_dict``)
  leaf for leaf; every new leaf's optimizer group against the JAX
  ``param_group_label``; ``c // 64 == 0`` heads raising on both sides;
  the statistics of the TSSA attentions in fp32 under bf16 autocast.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_weights import FLAGSHIP, jax_shapes, randomize, transfer
from torch_dropout_masks import FixedDropout, dropout_modules, set_masks
from yolo_ad_refine_tpu import YOLO as JaxYOLO
from yolo_ad_refine_tpu.nn import tssa as JT
from yolo_ad_refine_tpu.train.optim import param_group_label as jax_label
from yolo_ad_refine_tpu.utils.torch_import import import_torch_state_dict
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.models.parser import load_model_cfg
from yolo_ad_refine_tpu_torch.nn import tssa as PT
from yolo_ad_refine_tpu_torch.train.optim import param_group_label
from yolo_ad_refine_tpu_torch.utils.jax_weights import (
    _module_path, flatten_tree, jax_leaf_map, jax_to_port, load_jax_variables)

IMGSZ = 256
# layer-10 module -> the JAX parameter count of the flagship with it, scale n
ABLATIONS = {"C2TSSA_DYT_Mona_EDFFN": 3_667_813, "C2SFA": 3_576_547, "C2PSA_EDFFN": 3_632_225,
             "C2AdaptiveTSSA_Enhanced": 4_159_519, "C2ProgressiveTSSA_Fusion1": 4_192_373}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def ablation_cfg(name: str) -> dict:
    """The flagship yaml with ``name`` at layer 10 (the reference's
    ablation yamls differ from it only there)."""
    d = copy.deepcopy(load_model_cfg(FLAGSHIP))
    d["backbone"][10] = [-1, 2, name, [1024]]
    return d


def capture_dropout(store: dict):
    """A flax interceptor that runs each train-mode ``nn.Dropout`` exactly
    as flax does (the same rng, the same mask, the same select) and puts its
    keep mask into ``store`` under the module's scope path. The masks arrive
    through ``jax.debug.callback``, which may run after the jitted call has
    returned: a caller waits with ``jax.effects_barrier()`` before reading
    ``store``."""

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, fnn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        x = args[0]
        det = fnn.merge_param("deterministic", mod.deterministic, kwargs.get("deterministic"))
        if det or mod.rate == 0.0:
            return x
        keep_prob = 1.0 - mod.rate
        keep = jax.random.bernoulli(mod.make_rng(mod.rng_collection), p=keep_prob,
                                    shape=x.shape)
        jax.debug.callback(lambda k, p=mod.scope.path: store.__setitem__(p, np.asarray(k)), keep)
        return jax.lax.select(keep, x / keep_prob, jnp.zeros_like(x))

    return fnn.intercept_methods(interceptor)


def port_masks(model: torch.nn.Module, store: dict, prefix=()) -> dict:
    """The captured JAX keep masks (NHWC) by the port's dropout names (NCHW):
    ``model.10.m.0.mona1.dropout`` is flax's ``modules_10/m0/mona1/Dropout_0``.
    ``prefix``: flax scope components to drop (a module applied alone has
    none of the wrapper's ``modules_0``)."""
    out = {}
    for name in dropout_modules(model):
        path = tuple(_module_path(name.rpartition(".")[0]))[len(prefix):] + ("Dropout_0",)
        out[name] = torch.from_numpy(store[path]).permute(0, 3, 1, 2)
    assert len(out) == len(store) > 0
    return out


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


S64, S128 = (2, 9, 11, 64), (2, 9, 11, 128)
CASES = {
    "DynamicTanh": (lambda: JT.DynamicTanh(), lambda: PT.DynamicTanh(64), S64),
    "AttentionTSSA": (lambda: JT.AttentionTSSA(128, 2), lambda: PT.AttentionTSSA(128, 2),
                      (2, 99, 128)),
    "MonaOp": (lambda: JT.MonaOp(), lambda: PT.MonaOp(64), S64),
    "Mona": (lambda: JT.Mona(), lambda: PT.Mona(64), S64),
    "TSSAlockDyTMonaEDFFN": (lambda: JT.TSSAlockDyTMonaEDFFN(128, 2),
                             lambda: PT.TSSAlockDyTMonaEDFFN(128, 2), S128),
    "C2TSSA_DYT_Mona_EDFFN": (lambda: JT.C2TSSADyTMonaEDFFN(128, n=2),
                              lambda: PT.C2TSSADyTMonaEDFFN(64, 128, 2), S64),
    "SEBlock": (lambda: JT.SEBlock(), lambda: PT.SEBlock(64), S64),
    "StandardFFN": (lambda: JT.StandardFFN(), lambda: PT.StandardFFN(64), S64),
    "SimpleFeatureProcessor": (lambda: JT.SimpleFeatureProcessor(),
                               lambda: PT.SimpleFeatureProcessor(64), S64),
    "ProgressiveTSSAFusion0": (lambda: JT.ProgressiveTSSAFusion0(64),
                               lambda: PT.ProgressiveTSSAFusion0(64), S64),
    "C2SFA": (lambda: JT.C2SFA(128, n=2), lambda: PT.C2SFA(64, 128, 2), S64),
    "PSABlockEDFFN": (lambda: JT.PSABlockEDFFN(64, 0.5, 1), lambda: PT.PSABlockEDFFN(64, 0.5, 1),
                      S64),
    "C2PSA_EDFFN": (lambda: JT.C2PSAEDFFN(128, n=1), lambda: PT.C2PSAEDFFN(64, 128, 1), S64),
    "HierarchicalMona": (lambda: JT.HierarchicalMona(), lambda: PT.HierarchicalMona(64), S64),
    "AdaptiveTSSAEnhanced": (lambda: JT.AdaptiveTSSAEnhanced(64, 1),
                             lambda: PT.AdaptiveTSSAEnhanced(64, 1), S64),
    "C2AdaptiveTSSA_Enhanced": (lambda: JT.C2AdaptiveTSSAEnhanced(128, n=1),
                                lambda: PT.C2AdaptiveTSSAEnhanced(64, 128, 1), S64),
    "ProgressiveTSSAFusion1": (lambda: JT.ProgressiveTSSAFusion1(64, 2),
                               lambda: PT.ProgressiveTSSAFusion1(64, 2), S64),
    "C2ProgressiveTSSA_Fusion1": (lambda: JT.C2ProgressiveTSSAFusion1(128, n=1),
                                  lambda: PT.C2ProgressiveTSSAFusion1(64, 128, 1), S64),
}
# with dropout (Mona) or batch statistics: also held in train mode
TRAIN_CASES = ["Mona", "TSSAlockDyTMonaEDFFN", "C2TSSA_DYT_Mona_EDFFN", "C2SFA", "C2PSA_EDFFN",
               "C2AdaptiveTSSA_Enhanced", "C2ProgressiveTSSA_Fusion1"]


def _setup(name, seed=3):
    jf, pf, shape = CASES[name]
    jmod, pmod = jf(), pf()
    x = _x(shape)
    shapes = jax.eval_shape(lambda a: jmod.init(jax.random.PRNGKey(0), a, train=False),
                            jnp.asarray(x))
    variables = randomize(shapes, seed=seed)
    transfer(pmod, variables)
    return jmod, pmod, x, variables


def _to_port(a):
    return torch.from_numpy(a) if a.ndim == 3 else _nchw(a)


def _from_port(t):
    t = t.detach()
    return (t if t.ndim == 3 else t.permute(0, 2, 3, 1)).numpy()


def _hold(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", list(CASES))
def test_tssa_module_matches_jax(name):
    jmod, pmod, x, variables = _setup(name)
    want = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = _from_port(pmod(_to_port(x)))
    _hold(got, want)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in pmod.parameters()) == n_jax


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_tssa_module_train_mode_matches_jax(name):
    """Train mode: batch statistics, and every Mona dropping the units the
    JAX module's own dropout rng dropped."""
    jmod, pmod, x, variables = _setup(name)
    store = {}
    with capture_dropout(store):
        want, updated = jax.jit(lambda v, a: jmod.apply(
            v, a, train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(5)}))(
            {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})},
            jnp.asarray(x))
        # the masks reach ``store`` through debug callbacks, which may still be
        # running when the call returns: wait for them before reading it
        jax.block_until_ready((want, updated))
        jax.effects_barrier()
    wrapped = torch.nn.Module()
    wrapped.model = torch.nn.ModuleList([pmod])
    if dropout_modules(pmod):
        set_masks(wrapped, port_masks(wrapped, store, prefix=("modules_0",)))
        assert all(0.85 < m.keep.float().mean() < 0.95 for m in wrapped.modules()
                   if isinstance(m, FixedDropout))
    pmod.train()
    with torch.no_grad():
        got = _from_port(pmod(_to_port(x)))
    _hold(got, want)
    if updated.get("batch_stats"):
        stats = jax_to_port(wrapped, {}, flatten_tree(
            {"modules_0": jax.tree.map(np.asarray, dict(updated["batch_stats"]))}),
            collections=("batch_stats",))
        state = wrapped.state_dict()
        assert stats
        for k, v in stats.items():
            np.testing.assert_allclose(state[k].numpy(), v, atol=1e-5, err_msg=k)


def test_mona_dropout_rate_and_scaling():
    """The port's own Mona dropout: rate 0.1, kept units scaled by 1 / 0.9,
    only in train mode."""
    m = PT.Mona(64)
    assert isinstance(m.dropout, torch.nn.Dropout) and m.dropout.p == 0.1
    x = torch.ones(4, 64, 32, 32)
    torch.manual_seed(0)
    y = m.dropout.train()(x)
    kept = y != 0
    assert 0.88 < kept.float().mean() < 0.92
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert torch.equal(m.dropout.eval()(x), x)


def test_heads_below_64_channels_raise_on_both_sides():
    """``C2TSSA_DYT_Mona_EDFFN`` takes c // 64 heads with no floor (JAX
    nn/tssa.py:246-247): an inner width under 64 gives 0 heads, and both
    sides raise (ROADMAP reference hazard)."""
    with pytest.raises(ZeroDivisionError):
        PT.C2TSSADyTMonaEDFFN(64, 96, 1)
    jmod = JT.C2TSSADyTMonaEDFFN(96, n=1)
    with pytest.raises(ZeroDivisionError):
        jax.eval_shape(lambda a: jmod.init(jax.random.PRNGKey(0), a), jnp.zeros((1, 8, 8, 64)))


class _EinsumDtypes(torch.overrides.TorchFunctionMode):
    """The result types of the TSSA statistics' einsums ("bhn,bhnd->bhd")."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.einsum and args and args[0] == "bhn,bhnd->bhd":
            self.seen.append(out.dtype)
        return out


@pytest.mark.parametrize("module", ["C2PTSSA", "C2TSSA_DYT_Mona_EDFFN"])
def test_tssa_statistics_stay_fp32_under_bf16_autocast(module):
    """The JAX modules compute the token statistics in fp32 whatever the
    compute type (nn/tssa.py:75-85, :276-283); under bf16 autocast the
    port's einsums over the tokens must not run in bf16."""
    m = {"C2PTSSA": PT.C2PTSSA, "C2TSSA_DYT_Mona_EDFFN": PT.C2TSSADyTMonaEDFFN}[module](
        128, 128, 1).eval()
    x = torch.randn(1, 128, 8, 8)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16), _EinsumDtypes() as mode:
        y = m(x)
    assert mode.seen and set(mode.seen) == {torch.float32}
    assert torch.isfinite(y.float()).all()


@pytest.mark.parametrize("name", list(ABLATIONS))
def test_ablation_model_matches_jax(name):
    cfg = ablation_cfg(name)
    jm, shapes = jax_shapes(cfg, IMGSZ)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    assert n_jax == ABLATIONS[name]
    variables = randomize(shapes, seed=9)
    port = DetectionModel(cfg)
    assert port.num_params() == n_jax
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    x = np.random.default_rng(0).random((1, IMGSZ, IMGSZ, 3)).astype(np.float32)
    want, _ = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got, _ = port.eval()(_nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def facades(tmp_path_factory):
    """The 697 model in both facades with the same randomised weights: the
    JAX one from a yaml file of the swapped dict, the port's from the dict."""
    cfg = ablation_cfg("C2TSSA_DYT_Mona_EDFFN")
    path = tmp_path_factory.mktemp("cfg") / "yolo11-697-ablation.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    jy = JaxYOLO(str(path), imgsz=IMGSZ)
    variables = randomize(jy.model.variables, seed=13)
    jy.model.variables = jax.tree.map(jnp.asarray, variables)
    port = YOLO(cfg, device="cpu", imgsz=IMGSZ)
    load_jax_variables(port.model, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    return jy, port


def test_697_predict_matches_jax(facades):
    jy, port = facades
    assert port.model.num_params() == 3_667_813 and port.model.strides == (8, 16, 32)
    r = np.random.default_rng(4)
    imgs = [r.integers(0, 256, (IMGSZ, IMGSZ, 3), dtype=np.uint8) for _ in range(2)]
    want = jy.predict(imgs, imgsz=IMGSZ, conf=0.001, batch=2)
    got = port.predict(imgs, imgsz=IMGSZ, conf=0.001, batch=2)
    assert sum(len(g) for g in got) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_allclose(g.boxes.data, w.boxes.data, rtol=0, atol=1e-3)


def test_697_state_dict_imports_into_jax_leaf_for_leaf(facades):
    """The port's 697 state dict through the JAX importer (strict) gives
    back every flax leaf the port was filled from."""
    jy, port = facades
    sd = {k: v.detach().numpy() for k, v in port.model.state_dict().items()}
    shapes = jax.tree.map(np.asarray, jy.model.variables)
    got = import_torch_state_dict(sd, shapes, strict=True,
                                  deconv_layers=port.model.deconv_layer_indices)
    for coll in ("params", "batch_stats"):
        want, back = flatten_tree(shapes[coll]), flatten_tree(got[coll])
        assert set(want) == set(back)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(back[k]), v, err_msg=k)


def test_new_leaves_take_the_jax_optimizer_groups():
    """Every parameter of the ablation blocks, the attention rows and the
    DSAN rows falls in the group the JAX ``param_group_label`` gives its
    flax leaf (bias / nodecay / decay)."""
    from test_torch_attention import CASES as ATTENTION
    from test_torch_fusion_modes import CASES as FUSION

    cases = [(n, CASES[n]) for n in CASES] + list(ATTENTION.items()) + list(FUSION.items())
    checked = 0
    for name, (jf, pf, shape) in cases:
        jmod, pmod = jf(), pf()
        if isinstance(shape, tuple):
            arg = jnp.zeros(shape)
        else:  # the fusion cases' input lists; a one-input case takes the map itself
            arg = [jnp.zeros(s) for s in shape] if len(shape) > 1 else jnp.zeros(shape[0])
        shapes = jax.eval_shape(lambda a: jmod.init(jax.random.PRNGKey(0), a, train=False), arg)
        params = shapes.get("params", {})
        labels = jax.tree_util.tree_flatten_with_path(
            jax.tree_util.tree_map_with_path(jax_label, dict(params)))[0]
        want = {"/".join(str(getattr(k, "key", k)) for k in path): lab for path, lab in labels}
        wrapped = torch.nn.Module()
        wrapped.model = torch.nn.ModuleList([pmod])
        for pname, t, targets in jax_leaf_map(wrapped):
            if targets[0][0] != "params":
                continue
            for _, key, _, _ in targets:
                leaf = key.split("/", 1)[1]
                assert param_group_label(pname, t) == want[leaf], (name, pname, leaf)
                checked += 1
    assert checked > 400
