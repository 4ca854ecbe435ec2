"""The conv extras and GELAN blocks of ``nn/conv_extras.py`` (and the
parser's SPP and Bottleneck chain of ``nn/block.py``) against their JAX
counterparts, each alone, fp32 on the CPU, with numpy-randomised weights
carried over by the strict loader; the model for the cases is
``tests/test_torch_modules.py``.

Inputs are odd and non-square maps (17 x 23, 9 x 6; Focus, whose
space-to-depth takes even sides, 18 x 22): ADown and AConv
average-pool 2x2 at stride 1 (17 x 23 -> 16 x 22) before their stride-2
conv and max pool, where an off-by-one in either padding shows. Both
copies of the two classes that have one (``LightConv``, ``RepConv``: the
yaml rows' here, HGBlock's and RepC3's in ``nn/block.py``) are held to
their own JAX class. Tolerance 1e-5 absolute in eval mode; in train mode
(batch statistics) 1e-4 absolute, and the updated running statistics
1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import randomize, transfer
from yolo_ad_refine_tpu.nn import block as JB
from yolo_ad_refine_tpu.nn import conv_extras as JCE
from yolo_ad_refine_tpu_torch.nn import block as PB
from yolo_ad_refine_tpu_torch.nn import conv_extras as PCE
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, jax_to_port


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


ODD = (2, 17, 23, 16)    # odd, non-square
SMALL = (2, 9, 6, 12)    # odd height, even width
EVEN = (2, 18, 22, 16)   # Focus's space-to-depth takes even sides


def _case(name):
    """(flax module, port module, NHWC input shape)."""
    c = ODD[-1]
    cases = {
        "Conv2": (JCE.Conv2(24, 3, 1), PCE.Conv2(c, 24, 3, 1), ODD),
        "Conv2_s2_noact": (JCE.Conv2(24, 3, 2, act=False), PCE.Conv2(c, 24, 3, 2, act=False), ODD),
        "LightConv": (JCE.LightConv(24, 3), PCE.LightConv(c, 24, 3), ODD),
        "LightConv_hgblock": (JB.LightConv(24, 3), PB.LightConv(c, 24, 3), ODD),
        "Focus": (JCE.Focus(24, 3), PCE.Focus(c, 24, 3), EVEN),
        "GhostConv": (JCE.GhostConv(24, 3, 2), PCE.GhostConv(c, 24, 3, 2), ODD),
        "RepConv": (JCE.RepConv(24), PCE.RepConv(c, 24), ODD),
        "RepConv_bn_identity": (JCE.RepConv(16, use_bn_identity=True),
                                PCE.RepConv(c, 16, use_bn_identity=True), ODD),
        "RepConv_s2_noact": (JCE.RepConv(24, 3, 2, act=False),
                             PCE.RepConv(c, 24, 3, 2, act=False), ODD),
        "RepConv_repc3": (JB.RepConv(24), PB.RepConv(c, 24), ODD),
        "ChannelAttention": (JCE.ChannelAttention(), PCE.ChannelAttention(c), ODD),
        "SpatialAttention": (JCE.SpatialAttention(7), PCE.SpatialAttention(7), ODD),
        "SpatialAttention_k3": (JCE.SpatialAttention(3), PCE.SpatialAttention(3), SMALL),
        "CBAM": (JCE.CBAM(7), PCE.CBAM(c, 7), ODD),
        "RepBottleneck": (JCE.RepBottleneck(16), PCE.RepBottleneck(c, 16), ODD),
        "RepCSP": (JCE.RepCSP(24, n=2), PCE.RepCSP(c, 24, n=2), ODD),
        "RepNCSPELAN4": (JCE.RepNCSPELAN4(32, 24, 16, n=2), PCE.RepNCSPELAN4(c, 32, 24, 16, 2),
                         ODD),
        "RepNCSPELAN4_odd_split": (JCE.RepNCSPELAN4(16, 10, 8), PCE.RepNCSPELAN4(12, 16, 10, 8),
                                   SMALL),
        "ELAN1": (JCE.ELAN1(32, 24, 16), PCE.ELAN1(c, 32, 24, 16), ODD),
        "AConv": (JCE.AConv(24), PCE.AConv(c, 24), ODD),
        "AConv_small": (JCE.AConv(16), PCE.AConv(12, 16), SMALL),
        "ADown": (JCE.ADown(24), PCE.ADown(c, 24), ODD),
        "ADown_small": (JCE.ADown(16), PCE.ADown(12, 16), SMALL),
        "ADown_odd_channels": (JCE.ADown(16), PCE.ADown(11, 16), (2, 9, 6, 11)),
        "SPPELAN": (JCE.SPPELAN(24, 8), PCE.SPPELAN(c, 24, 8), ODD),
        "SPP": (JB.SPP(24), PB.SPP(c, 24), ODD),
        "Bottleneck_chain": (JB.SequentialBlocks(tuple(JB.Bottleneck(16) for _ in range(3))),
                             PB.SequentialBlocks([PB.Bottleneck(c, 16) for _ in range(3)]), ODD),
    }
    return cases[name]


CASES = ["Conv2", "Conv2_s2_noact", "LightConv", "LightConv_hgblock", "Focus", "GhostConv",
         "RepConv", "RepConv_bn_identity", "RepConv_s2_noact", "RepConv_repc3",
         "ChannelAttention", "SpatialAttention", "SpatialAttention_k3", "CBAM", "RepBottleneck",
         "RepCSP", "RepNCSPELAN4", "RepNCSPELAN4_odd_split", "ELAN1", "AConv", "AConv_small",
         "ADown", "ADown_small", "ADown_odd_channels", "SPPELAN", "SPP", "Bottleneck_chain"]


def _setup(name, seed=3):
    jmod, pmod, shape = _case(name)
    x = _x(shape, seed=1)
    shapes = jax.eval_shape(lambda a: jmod.init(jax.random.PRNGKey(0), a, train=False),
                            jnp.asarray(x))
    variables = randomize(shapes, seed=seed)
    transfer(pmod, variables)
    return jmod, pmod, x, variables


@pytest.mark.parametrize("name", CASES)
def test_block_matches_jax(name):
    jmod, pmod, x, variables = _setup(name)
    want = np.asarray(jax.jit(lambda v, a: jmod.apply(v, a, train=False))(variables,
                                                                          jnp.asarray(x)))
    with torch.no_grad():
        got = pmod(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_adown_and_aconv_shapes_on_odd_maps():
    """17 x 23 -> pool 16 x 22 -> stride 2, pad 1: 8 x 11 on both halves."""
    x = _nchw(_x(ODD))
    assert PCE.ADown(16, 24)(x).shape == (2, 24, 8, 11)
    assert PCE.AConv(16, 24)(x).shape == (2, 24, 8, 11)
    y = _nchw(_x((1, 160, 160, 4)))
    assert PCE.avg_pool_2x2_s1(y).shape[-2:] == (159, 159)
    assert PCE.ADown(4, 8)(y).shape[-2:] == (80, 80)


@pytest.mark.parametrize("name", ["Conv2", "RepConv_bn_identity", "RepNCSPELAN4", "ADown",
                                  "GhostConv"])
def test_block_train_mode_matches_jax(name):
    """Batch-statistics BatchNorm: the output and the updated running
    statistics (Conv2's and RepConv's own ``bn`` among them)."""
    jmod, pmod, x, variables = _setup(name)
    want, updated = jax.jit(lambda v, a: jmod.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    pmod.train()
    with torch.no_grad():
        got = pmod(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    wrapped = _wrapped(pmod)
    stats = jax_to_port(wrapped, {}, flatten_tree(
        {"modules_0": jax.tree.map(np.asarray, dict(updated["batch_stats"]))}),
        collections=("batch_stats",))
    state = wrapped.state_dict()
    assert stats
    for k, v in stats.items():
        np.testing.assert_allclose(state[k].numpy(), v, atol=1e-5, err_msg=k)


def _wrapped(pmod):
    w = torch.nn.Module()
    w.model = torch.nn.ModuleList([pmod])
    return w


def test_gelan_gradients_match_jax():
    """One backward through a GELAN chain (RepNCSPELAN4, ADown, SPPELAN,
    AConv, ELAN1) in train mode: every parameter's gradient of the summed
    squares against ``jax.grad`` at 1e-4 relative norm."""
    import flax.linen as fnn

    class JChain(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool = False):
            x = JCE.RepNCSPELAN4(24, 16, 8, n=1, name="a")(x, train)
            x = JCE.ADown(24, name="b")(x, train)
            x = JCE.SPPELAN(16, 8, name="c")(x, train)
            x = JCE.AConv(16, name="d")(x, train)
            return JCE.ELAN1(16, 16, 8, name="e")(x, train)

    class PChain(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = PCE.RepNCSPELAN4(16, 24, 16, 8, 1)
            self.b = PCE.ADown(24, 24)
            self.c = PCE.SPPELAN(24, 16, 8)
            self.d = PCE.AConv(16, 16)
            self.e = PCE.ELAN1(16, 16, 16, 8)

        def forward(self, x):
            return self.e(self.d(self.c(self.b(self.a(x)))))

    x = _x(ODD, seed=4)
    jmod, pmod = JChain(), PChain()
    variables = randomize(jax.eval_shape(
        lambda a: jmod.init(jax.random.PRNGKey(0), a, train=False), jnp.asarray(x)), seed=6)

    def loss(params):
        y, _ = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(y * y)

    jl, jg = jax.jit(jax.value_and_grad(loss))(variables["params"])
    wrapped = _wrapped(pmod)
    transfer(pmod, variables).train()
    out = pmod(_nchw(x))
    total = (out * out).sum()
    total.backward()
    assert abs(total.item() - float(jl)) <= 1e-5 * abs(float(jl))
    want = jax_to_port(wrapped, flatten_tree({"modules_0": jax.tree.map(np.asarray, jg)}),
                       collections=("params",))
    named = dict(wrapped.named_parameters())
    assert want.keys() == named.keys()
    for k, w in want.items():
        g = named[k].grad.numpy()
        assert np.linalg.norm(g - w) <= 1e-4 * max(np.linalg.norm(w), 1e-12), k


ROWS = {  # one yaml row of each block the parser builds from nn/conv_extras.py and SPP / chains
    "nc": 3,
    "backbone": [[-1, 1, "Focus", [16, 3]], [-1, 1, "Conv2", [32, 3, 2]],
                 [-1, 1, "LightConv", [32, 3]], [-1, 1, "GhostConv", [32, 3, 1]],
                 [-1, 1, "RepConv", [32, 3, 1]], [-1, 1, "CBAM", [32, 7]],
                 [-1, 1, "AConv", [48]], [-1, 1, "ELAN1", [48, 32, 16]],
                 [-1, 1, "ChannelAttention", [48]], [-1, 1, "ADown", [64]],
                 [-1, 1, "RepNCSPELAN4", [64, 32, 16, 2]], [-1, 1, "SpatialAttention", [7]],
                 [-1, 1, "SPP", [64, [3, 5, 7]]], [-1, 1, "SPPELAN", [64, 32]],
                 [-1, 2, "Bottleneck", [64]]],
    "head": [[[4, 8, 14], 1, "Detect", ["nc"]]],
}


def test_every_row_builds_the_jax_graph():
    """The parser's rows for these blocks, in one graph against the JAX
    model after a strict load: the yaml rows' LightConv and RepConv (not
    HGBlock's and RepC3's), the channel-keeping gates, RepNCSPELAN4's own
    repeat count, SPP's kernel list and a Bottleneck row of 2 (a chain).
    Eval output at 1e-4 (the flagship's tolerance, tests/test_torch_slice.py)."""
    from test_torch_weights import jax_shapes
    from yolo_ad_refine_tpu_torch.models.model import DetectionModel
    from yolo_ad_refine_tpu_torch.utils.jax_weights import load_jax_variables

    jm, shapes = jax_shapes(ROWS, 64)
    variables = randomize(shapes, seed=4)
    port = DetectionModel(ROWS)
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    assert type(port.model[2]) is PCE.LightConv and type(port.model[4]) is PCE.RepConv
    assert isinstance(port.model[14], PB.SequentialBlocks) and len(port.model[14].blocks) == 2
    assert len(port.model[10].cv2[0].m) == 2
    x = np.random.default_rng(6).random((2, 64, 64, 3)).astype(np.float32)
    want, _ = jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
    with torch.no_grad():
        got, _ = port.eval()(_nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
