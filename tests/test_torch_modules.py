"""Port modules against their JAX counterparts with transferred weights.

Each case builds the flax module and the port module at narrow widths,
randomises the flax variables with numpy, carries them over and runs both
in fp32 on the CPU on the same numpy input (NHWC for JAX, NCHW
channels_last for the port). Tolerance 1e-5 absolute (AYHead 1e-4: its
deeper GroupNorm chain sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import randomize, transfer
from yolo_ad_refine_tpu.nn import block as JB
from yolo_ad_refine_tpu.nn import common as JC
from yolo_ad_refine_tpu.nn import head as JH
from yolo_ad_refine_tpu.nn import tssa as JT
from yolo_ad_refine_tpu_torch.nn import block as PB
from yolo_ad_refine_tpu_torch.nn import common as PC
from yolo_ad_refine_tpu_torch.nn import head as PH
from yolo_ad_refine_tpu_torch.nn import tssa as PT


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _case(name):
    """(flax module, flax call args, port module, port call args, atol)."""
    x = _x((2, 12, 12, 16))
    if name == "Conv":
        return JC.Conv(24, 3, 2), (x,), PC.Conv(16, 24, 3, 2), (_nchw(x),), 1e-5
    if name == "C3k2":
        return (JB.C3k2(32, n=1, c3k=False, e=0.25), (x,), PB.C3k2(16, 32, 1, c3k=False, e=0.25),
                (_nchw(x),), 1e-5)
    if name == "C3k2_c3k":
        return (JB.C3k2(32, n=1, c3k=True), (x,), PB.C3k2(16, 32, 1, c3k=True), (_nchw(x),), 1e-5)
    if name == "C3k2_MLCA_b2":
        return (JB.C3k2MLCA(32, n=1, c3k=True), (x,), PB.C3k2MLCA(16, 32, 1, c3k=True),
                (_nchw(x),), 1e-5)
    if name == "C3k2_MLCA_b3":
        x3 = _x((3, 10, 14, 16), seed=3)
        return (JB.C3k2MLCA(16, n=1, c3k=False), (x3,), PB.C3k2MLCA(16, 16, 1, c3k=False),
                (_nchw(x3),), 1e-5)
    if name in ("ELA_HSFPN", "ELA_HSFPN_map"):
        flag = name == "ELA_HSFPN"
        return JB.ELAHSFPN(flag=flag), (x,), PB.ELAHSFPN(16, flag), (_nchw(x),), 1e-5
    if name == "Fusion":
        x2 = _x((2, 12, 12, 16), seed=2)
        return (JB.Fusion(inc_list=(16, 16), fusion="bifpn"), ([x, x2],),
                PB.Fusion((16, 16), "bifpn"), ([_nchw(x), _nchw(x2)],), 1e-5)
    if name == "ConvTranspose2d":
        return (JC.PlainConvTranspose2d(8, 3, 2, 1, 1), (x,), PC.plain_conv_transpose2d(16, 8),
                (_nchw(x),), 1e-5)
    if name == "Conv2d":
        return JC.PlainConv2d(8, 1), (x,), PC.plain_conv2d(16, 8, 1), (_nchw(x),), 1e-5
    if name == "SPPF":
        return JB.SPPF(24, 5), (x,), PB.SPPF(16, 24, 5), (_nchw(x),), 1e-5
    if name == "C2PSA":
        xp = _x((2, 8, 8, 128))
        return JB.C2PSA(128, n=1), (xp,), PB.C2PSA(128, 128, 1), (_nchw(xp),), 1e-5
    if name == "C2PTSSA":
        # 12x12 reflect-pads to 16 in EDFFN; scales 2 and 4 pool to 6x6 / 3x3
        xt = _x((2, 12, 12, 32))
        return JT.C2PTSSA(32, n=1), (xt,), PT.C2PTSSA(32, 32, 1), (_nchw(xt),), 1e-5
    if name == "DyDCNv2":
        off = _x((2, 12, 12, 18), seed=4, scale=5.0)
        mask = 1 / (1 + np.exp(-_x((2, 12, 12, 9), seed=5)))
        mask = mask.astype(np.float32)
        return (JH.DyDCNv2(16), (x, off, mask), PH.DyDCNv2(16, 16),
                (_nchw(x), _nchw(off), _nchw(mask)), 1e-5)
    if name in ("AYHead", "Detect"):
        xs = [_x((2, s, s, 32), seed=10 + i) for i, s in enumerate((16, 8, 4))]
        if name == "AYHead":
            return (JH.AYHead(nc=5, ch=(32, 32, 32)), (xs,), PH.AYHead(5, (32, 32, 32)),
                    ([_nchw(a) for a in xs],), 1e-4)
        return (JH.Detect(nc=5, ch=(32, 32, 32)), (xs,), PH.Detect(5, (32, 32, 32)),
                ([_nchw(a) for a in xs],), 1e-5)
    raise KeyError(name)


CASES = ["Conv", "C3k2", "C3k2_c3k", "C3k2_MLCA_b2", "C3k2_MLCA_b3", "ELA_HSFPN",
         "ELA_HSFPN_map", "Fusion", "ConvTranspose2d", "Conv2d", "SPPF", "C2PSA", "C2PTSSA",
         "DyDCNv2", "AYHead", "Detect"]


def _to_np(t):
    if isinstance(t, (tuple, list)):
        return [_to_np(a) for a in t]
    a = t.detach().numpy()
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


@pytest.mark.parametrize("name", CASES)
def test_module_matches_jax(name):
    jmod, jargs, pmod, pargs, atol = _case(name)
    jargs = jax.tree.map(jnp.asarray, jargs)
    shapes = jax.eval_shape(lambda *a: jmod.init(jax.random.PRNGKey(0), *a, train=False), *jargs)
    variables = randomize(shapes, seed=7)
    want = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False))(variables, *jargs)
    transfer(pmod, variables)
    with torch.no_grad():
        got = pmod(*pargs)
    if name in ("AYHead", "Detect"):  # (decoded y, per-level maps)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=atol, atol=atol)
        for g, w in zip(_to_np(got[1]), want[1]):
            np.testing.assert_allclose(g, np.asarray(w), rtol=atol, atol=atol)
        return
    np.testing.assert_allclose(_to_np(got), np.asarray(want), atol=atol)
