"""The attention rows of ``nn/attention.py``, ``nn/attention_zoo.py`` and
the DSAN rows of ``nn/dsan.py`` against their JAX counterparts, each alone,
fp32 on the CPU, with numpy-randomised weights carried over by the strict
loader; the model for the cases is ``tests/test_torch_conv_extras.py``.

Inputs are odd, non-square maps (9 x 11 x 32) except where the module
fixes the map: CascadedGroupAttention attends a 7 x 7 map (its
``resolution``, the JAX test's shape), LocalWindowAttention's windows are
7 x 7 (9 x 11 pads to four of them). Eval outputs within 1e-4 of the
largest |JAX| value; train mode (batch statistics) the same, and the
updated running statistics within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import randomize, transfer
from yolo_ad_refine_tpu.nn import attention as JA
from yolo_ad_refine_tpu.nn import attention_zoo as JZ
from yolo_ad_refine_tpu.nn import dsan as JD
from yolo_ad_refine_tpu_torch.nn import attention as PA
from yolo_ad_refine_tpu_torch.nn import attention_zoo as PZ
from yolo_ad_refine_tpu_torch.nn import dsan as PD
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, jax_to_port

ODD = (2, 9, 11, 32)
WIN = (2, 7, 7, 32)
C = 32


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


# name -> (JAX module, port module, NHWC input shape)
CASES = {
    "EMA": (lambda: JA.EMA(), lambda: PA.EMA(C), ODD),
    "SimAM": (lambda: JA.SimAM(), lambda: PA.SimAM(C), ODD),
    "TripletAttention": (lambda: JA.TripletAttention(), lambda: PA.TripletAttention(C), ODD),
    "TripletAttention_no_spatial": (lambda: JA.TripletAttention(no_spatial=True),
                                    lambda: PA.TripletAttention(C, no_spatial=True), ODD),
    "LSKBlock": (lambda: JA.LSKBlock(), lambda: PA.LSKBlock(C), ODD),
    "SEAttention": (lambda: JA.SEAttention(), lambda: PA.SEAttention(C), ODD),
    "EfficientChannelAttention": (lambda: JA.EfficientChannelAttention(),
                                  lambda: PA.EfficientChannelAttention(C), ODD),
    "SpatialGroupEnhance": (lambda: JZ.SpatialGroupEnhance(),
                            lambda: PZ.SpatialGroupEnhance(C), ODD),
    "EffectiveSEModule": (lambda: JZ.EffectiveSEModule(), lambda: PZ.EffectiveSEModule(C), ODD),
    "EffectiveSEModule_maxpool": (lambda: JZ.EffectiveSEModule(add_maxpool=True),
                                  lambda: PZ.EffectiveSEModule(C, add_maxpool=True), ODD),
    "ELA": (lambda: JZ.ELA(), lambda: PZ.ELA(C), ODD),
    "CAA": (lambda: JZ.CAA(), lambda: PZ.CAA(C), ODD),
    "MPCA": (lambda: JZ.MPCA(), lambda: PZ.MPCA(C), ODD),
    "AFGCAttention": (lambda: JZ.AFGCAttention(), lambda: PZ.AFGCAttention(C), ODD),
    "BAMBlock": (lambda: JZ.BAMBlock(), lambda: PZ.BAMBlock(C), ODD),
    "LSKBlockSA": (lambda: JZ.LSKBlockSA(), lambda: PZ.LSKBlockSA(C), ODD),
    "LSKA": (lambda: JZ.LSKA(), lambda: PZ.LSKA(C), ODD),
    "LSKA_23": (lambda: JZ.LSKA(k_size=23), lambda: PZ.LSKA(C, k_size=23), ODD),
    "SegNext_Attention": (lambda: JZ.SegNextAttention(), lambda: PZ.SegNextAttention(C), ODD),
    "CPCA": (lambda: JZ.CPCA(), lambda: PZ.CPCA(C), ODD),
    "deformable_LKA": (lambda: JZ.DeformableLKA(), lambda: PZ.DeformableLKA(C), ODD),
    "DAttention": (lambda: JZ.DAttention(), lambda: PZ.DAttention(C), ODD),
    "DAttention_no_off": (lambda: JZ.DAttention(no_off=True),
                          lambda: PZ.DAttention(C, no_off=True), ODD),
    "DAttention_log_cpb": (lambda: JZ.DAttention(dwc_pe=False, log_cpb=True),
                           lambda: PZ.DAttention(C, dwc_pe=False, log_cpb=True), ODD),
    "DAttention_grid": (lambda: JZ.DAttention(dwc_pe=False),
                        lambda: PZ.DAttention(C, dwc_pe=False, q_size=ODD[1:3]), ODD),
    "DAttention_fixed_s2": (lambda: JZ.DAttention(dwc_pe=False, fixed_pe=True, q_size=ODD[1:3],
                                                  stride=2),
                            lambda: PZ.DAttention(C, dwc_pe=False, fixed_pe=True,
                                                  q_size=ODD[1:3], stride=2), ODD),
    "FocusedLinearAttention": (lambda: JZ.FocusedLinearAttention(),
                               lambda: PZ.FocusedLinearAttention(C), ODD),
    "CascadedGroupAttention": (lambda: JZ.CascadedGroupAttention(),
                               lambda: PZ.CascadedGroupAttention(C), WIN),
    "LocalWindowAttention": (lambda: JZ.LocalWindowAttention(),
                             lambda: PZ.LocalWindowAttention(C), ODD),
    "LocalWindowAttention_one_window": (lambda: JZ.LocalWindowAttention(),
                                        lambda: PZ.LocalWindowAttention(C), WIN),
    "DualDomainSelectionMechanism": (lambda: JZ.DualDomainSelectionMechanism(),
                                     lambda: PZ.DualDomainSelectionMechanism(C), ODD),
    "EfficientAttention": (lambda: JZ.EfficientAttention(), lambda: PZ.EfficientAttention(C),
                           ODD),
    "EfficientAttention_no_global": (
        lambda: JZ.EfficientAttention(group_split=(4, 0), window_size=1),
        lambda: PZ.EfficientAttention(C, group_split=(4, 0), window_size=1), ODD),
    "BiLevelRoutingAttention": (lambda: JZ.BiLevelRoutingAttention(),
                                lambda: PZ.BiLevelRoutingAttention(C), ODD),
    "BiLevelRoutingAttention_small_win": (
        lambda: JZ.BiLevelRoutingAttention(num_heads=4, n_win=2, topk=2),
        lambda: PZ.BiLevelRoutingAttention(C, num_heads=4, n_win=2, topk=2), ODD),
    "DSA": (lambda: JD.DSA(), lambda: PD.DSA(C), ODD),
    "DSAN": (lambda: JD.DSAN(), lambda: PD.DSAN(C), ODD),
}
# the rows with batch statistics (BatchNorm), also held in train mode
TRAIN_CASES = ["TripletAttention", "CAA", "MPCA", "BAMBlock", "CascadedGroupAttention",
               "LocalWindowAttention", "DualDomainSelectionMechanism", "DSAN"]


def _setup(name, seed=3):
    jf, pf, shape = CASES[name]
    jmod, pmod = jf(), pf()
    x = _x(shape)
    shapes = jax.eval_shape(lambda a: jmod.init(jax.random.PRNGKey(0), a, train=False),
                            jnp.asarray(x))
    variables = {"params": {}, **randomize(shapes, seed=seed)}  # SimAM has none
    transfer(pmod, variables)
    return jmod, pmod, x, variables


def _hold(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", list(CASES))
def test_attention_row_matches_jax(name):
    jmod, pmod, x, variables = _setup(name)
    want = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = pmod(_nchw(x)).permute(0, 2, 3, 1).numpy()
    _hold(got, want)
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(variables["params"]))
    assert sum(p.numel() for p in pmod.parameters()) == n_jax


def _wrapped(pmod):
    w = torch.nn.Module()
    w.model = torch.nn.ModuleList([pmod])
    return w


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_attention_row_train_mode_matches_jax(name):
    jmod, pmod, x, variables = _setup(name)
    want, updated = jax.jit(lambda v, a: jmod.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    pmod.train()
    with torch.no_grad():
        got = pmod(_nchw(x)).permute(0, 2, 3, 1).numpy()
    _hold(got, want)
    wrapped = _wrapped(pmod)
    stats = jax_to_port(wrapped, {}, flatten_tree(
        {"modules_0": jax.tree.map(np.asarray, dict(updated["batch_stats"]))}),
        collections=("batch_stats",))
    state = wrapped.state_dict()
    assert stats
    for k, v in stats.items():
        np.testing.assert_allclose(state[k].numpy(), v, atol=1e-5, err_msg=k)


def test_dsm_takes_the_tanh_gelu():
    """DSM's GELUs are JAX's default (tanh) form, not the reference
    FocalNet's exact one (ROADMAP reference hazard): the port matches the
    JAX module, and the same weights under the exact GELU do not."""
    jmod, pmod, x, variables = _setup("DualDomainSelectionMechanism")
    acts = [m.act for m in (*pmod.dw1, pmod.dw2)]
    assert all(a.approximate == "tanh" for a in acts)
    want = np.asarray(jax.jit(lambda v, a: jmod.apply(v, a, train=False))(variables,
                                                                           jnp.asarray(x)))
    for a in acts:
        a.approximate = "none"
    with torch.no_grad():
        exact = pmod(_nchw(x)).permute(0, 2, 3, 1).numpy()
    with pytest.raises(AssertionError):
        _hold(exact, want)


def test_routing_ties_keep_lax_top_k_order():
    """A constant map makes every window mean equal, so all routing logits
    tie: the windows picked are lax.top_k's (the lowest indices first)."""
    jmod, pmod, _, variables = _setup("BiLevelRoutingAttention_small_win")
    x = np.full(ODD, 0.5, np.float32)
    want = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = pmod(_nchw(x)).permute(0, 2, 3, 1).numpy()
    _hold(got, want)


def test_local_window_attention_rejects_a_small_map():
    """A map smaller than a window gets biases sized from it in JAX; the
    port's are sized at construction, so it raises there."""
    with pytest.raises(ValueError, match="window"):
        PZ.LocalWindowAttention(C)(torch.zeros(1, C, 5, 5))


def test_dattention_fixed_and_grid_tables_need_q_size():
    with pytest.raises(ValueError, match="q_size"):
        PZ.DAttention(C, dwc_pe=False)


@pytest.mark.parametrize("name", ["DAttention", "deformable_LKA", "BiLevelRoutingAttention",
                                  "FocusedLinearAttention"])
def test_attention_row_gradients_match_jax(name):
    """The summed squares' gradient to every parameter and to the input,
    eval mode, within 1e-4 relative norm of ``jax.grad``'s (the sampling
    rows through their bilinear weights, the routing through its gather).
    A leaf whose gradient cancels to rounding (DAttention's key bias shifts
    every logit of a query alike, which the softmax ignores) is held at
    1e-6 of the largest leaf's norm instead."""
    jmod, pmod, x, variables = _setup(name)

    def loss(params, a):
        y = jmod.apply({**variables, "params": params}, a, train=False)
        return jnp.sum(y * y)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    y = pmod(xt)
    (y * y).sum().backward()
    wrapped = _wrapped(pmod)
    want = jax_to_port(wrapped, flatten_tree({"modules_0": jax.tree.map(np.asarray, gp)}),
                       collections=("params",))
    got = {n: p.grad for n, p in wrapped.named_parameters()}
    assert set(got) == set(want)
    top = max(np.linalg.norm(w) for w in want.values())
    for n, w in want.items():
        g = got[n].numpy()
        assert np.linalg.norm(g - w) <= max(1e-4 * np.linalg.norm(w), 1e-6 * top), n
    g = xt.grad.permute(0, 2, 3, 1).numpy()
    assert np.linalg.norm(g - np.asarray(gx)) <= 1e-4 * np.linalg.norm(np.asarray(gx))
