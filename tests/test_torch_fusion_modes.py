"""The flagship's other ``fusion_mode``s (weight, adaptive, concat, SDI),
GSConv and SDI, in the PyTorch port against the JAX package, fp32 on the
CPU with numpy-randomised weights through the strict loader.

- GSConv (its channel shuffle out[j * c_ + i] = cat[2i + j]), SDI
  (adaptive average pooling down, align-corners bilinear up, by width)
  and Fusion in all five modes, each alone on odd, non-square maps: eval
  within 1e-5 of the largest |JAX| value; train mode (batch statistics)
  within 1e-4, the updated running statistics within 1e-5.
- The flagship yaml with its ``fusion_mode`` variable set, at scale n:
  the JAX parameter counts (4,164,733 / 4,165,765 / 4,130,941 /
  4,138,365), and at imgsz 256 the decoded predictions at rtol / atol
  1e-4, the flagship's tolerance (``tests/test_torch_slice.py``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import FLAGSHIP, jax_shapes, randomize, transfer
from yolo_ad_refine_tpu.nn import block as JB
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.models.parser import load_model_cfg, parse_model_yaml
from yolo_ad_refine_tpu_torch.nn import block as PB
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, jax_to_port, load_jax_variables

IMGSZ = 256
COUNTS = {"weight": 4_164_733, "adaptive": 4_165_765, "concat": 4_130_941, "SDI": 4_138_365}


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


def _maps(shapes, seed=1):
    r = np.random.default_rng(seed)
    return [r.normal(0, 1, s).astype(np.float32) for s in shapes]


# three inputs of 16 channels: the target 9 x 11, a larger 17 x 22 (pooled
# down) and a smaller 5 x 6 (bilinear up); the same-size ones for the
# element-wise modes
SDI_IN = [(2, 9, 11, 16), (2, 17, 22, 16), (2, 5, 6, 16)]
SAME_IN = [(2, 9, 11, 16)] * 3
MIXED_IN = [(2, 9, 11, 16), (2, 9, 11, 24), (2, 9, 11, 8)]

CASES = {
    "GSConv": (lambda: JB.GSConv(24, 3, 2), lambda: PB.GSConv(16, 24, 3, 2), [(2, 9, 11, 16)]),
    "GSConv_odd_half": (lambda: JB.GSConv(20), lambda: PB.GSConv(16, 20), [(2, 9, 11, 16)]),
    "SDI": (lambda: JB.SDI((16, 16, 16)), lambda: PB.SDI((16, 16, 16)), SDI_IN),
    "Fusion_SDI": (lambda: JB.Fusion((16, 16, 16), "SDI"),
                   lambda: PB.Fusion((16, 16, 16), "SDI"), SDI_IN),
    "Fusion_weight": (lambda: JB.Fusion((16, 16, 16), "weight"),
                      lambda: PB.Fusion((16, 16, 16), "weight"), SAME_IN),
    "Fusion_adaptive": (lambda: JB.Fusion((16, 16, 16), "adaptive"),
                        lambda: PB.Fusion((16, 16, 16), "adaptive"), SAME_IN),
    "Fusion_concat": (lambda: JB.Fusion((16, 24, 8), "concat"),
                      lambda: PB.Fusion((16, 24, 8), "concat"), MIXED_IN),
    "Fusion_bifpn": (lambda: JB.Fusion((16, 16, 16), "bifpn"),
                     lambda: PB.Fusion((16, 16, 16), "bifpn"), SAME_IN),
}
TRAIN_CASES = ["GSConv", "Fusion_SDI", "Fusion_weight", "Fusion_adaptive"]


def _setup(name):
    jf, pf, shapes = CASES[name]
    jmod, pmod = jf(), pf()
    xs = _maps(shapes)
    arg = xs[0] if len(xs) == 1 else [jnp.asarray(a) for a in xs]
    v = jax.eval_shape(lambda a: jmod.init(jax.random.PRNGKey(0), a, train=False), arg)
    variables = {"params": {}, **randomize(v, seed=4)}  # concat has none
    transfer(pmod, variables)
    parg = _nchw(xs[0]) if len(xs) == 1 else [_nchw(a) for a in xs]
    return jmod, pmod, arg, parg, variables


@pytest.mark.parametrize("name", list(CASES))
def test_block_matches_jax(name):
    jmod, pmod, arg, parg, variables = _setup(name)
    want = np.asarray(jax.jit(lambda v, a: jmod.apply(v, a, train=False))(variables, arg))
    with torch.no_grad():
        got = pmod(parg).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in pmod.parameters()) == n_jax


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_block_train_mode_matches_jax(name):
    jmod, pmod, arg, parg, variables = _setup(name)
    want, updated = jax.jit(lambda v, a: jmod.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, arg)
    pmod.train()
    with torch.no_grad():
        got = pmod(parg).permute(0, 2, 3, 1).numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    wrapped = torch.nn.Module()
    wrapped.model = torch.nn.ModuleList([pmod])
    stats = jax_to_port(wrapped, {}, flatten_tree(
        {"modules_0": jax.tree.map(np.asarray, dict(updated["batch_stats"]))}),
        collections=("batch_stats",))
    state = wrapped.state_dict()
    assert stats
    for k, v in stats.items():
        np.testing.assert_allclose(state[k].numpy(), v, atol=1e-5, err_msg=k)


def test_gsconv_shuffle_interleaves_the_halves():
    """out[j * c_ + i] = cat[2i + j]: with the dense half the input (0..3)
    and the depthwise half the input + 100, the output reads
    a0 a2 b0 b2 a1 a3 b1 b3."""
    class Plus100(torch.nn.Module):
        def forward(self, t):
            return t + 100

    m = PB.GSConv(4, 8)
    m.cv1, m.cv2 = torch.nn.Identity(), Plus100()
    out = m(torch.arange(4.0).view(1, 4, 1, 1)).flatten().tolist()
    assert out == [0, 2, 100, 102, 1, 3, 101, 103]


def test_fusion_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="none of"):
        PB.Fusion((16, 16), "sum")


def _cfg(mode):
    d = copy.deepcopy(load_model_cfg(FLAGSHIP))
    d["fusion_mode"] = mode
    return d


def test_concat_fusion_rows_carry_the_summed_channels():
    """A concat Fusion row's output channels are its inputs' sum (JAX
    models/parser.py:374-378); the rows after it are built on them."""
    specs, meta = parse_model_yaml(_cfg("concat"))
    fusions = [s for s in specs if s.name == "Fusion"]
    assert fusions
    for s in fusions:
        ins = [meta["ch"][j if j >= 0 else s.i + j] for j in s.f]
        assert s.c2 == sum(ins) > ins[0]
        assert meta["ch"][s.i] == s.c2


@pytest.mark.parametrize("mode", list(COUNTS))
def test_fusion_mode_flagship_matches_jax(mode):
    cfg = _cfg(mode)
    jm, shapes = jax_shapes(cfg, IMGSZ)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    assert n_jax == COUNTS[mode]
    variables = randomize(shapes, seed=7)
    port = DetectionModel(cfg)
    assert port.num_params() == n_jax
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    x = np.random.default_rng(0).random((1, IMGSZ, IMGSZ, 3)).astype(np.float32)
    want, _ = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got, feats = port.eval()(_nchw(x))
    assert [f.shape[2] for f in feats] == [32, 16, 8]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
