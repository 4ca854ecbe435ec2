"""Helpers the SAM family's port tests share (test_torch_sam.py,
test_torch_mobile_sam.py, test_torch_sam2.py): seeded inputs, numpy-
randomised JAX variables carried strictly into a port module, and the
shape-only check of a full-width variant's carry."""

import jax
import numpy as np
import torch

from test_torch_weights import randomize
from yolo_ad_refine_tpu_torch.utils.jax_weights import (
    flatten_tree, load_sam_variables, sam_leaf_map)


def x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(0, 1, shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def nchw(a):
    """NHWC numpy -> NCHW torch."""
    return t(a).permute(0, 3, 1, 2).contiguous()


def nhwc(p):
    """NCHW torch -> NHWC numpy."""
    return p.detach().permute(0, 2, 3, 1).numpy()


def rel(a, b):
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def jax_variables(jmod, *args, seed=0, method=None, **kwargs):
    """``jmod``'s variables, each leaf numpy-random (``randomize``), without
    running its init."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args, method=method,
                                              **kwargs))
    return randomize(shapes, seed=seed)


def carry(pmod, variables):
    """Load ``variables`` strictly into the port module; returns it in eval mode."""
    load_sam_variables(pmod, flatten_tree(variables["params"]),
                       flatten_tree(variables.get("batch_stats", {})))
    return pmod.eval()


def japply(jmod, variables, *args, method=None, **kwargs):
    out = jmod.apply(variables, *args, method=method, **kwargs)
    return jax.tree.map(np.asarray, out)


def carry_by_shape(pmod, shapes):
    """The strict carry of a full-width variant, by shape alone: every port
    tensor's flax leaf exists with the shape its converter expects, and no
    flax leaf is left over. Returns the count of flax values."""
    want = {f"{c}:{k}": tuple(v.shape) for c in ("params", "batch_stats") if c in shapes
            for k, v in flatten_tree(shapes[c]).items()}
    got = {}
    for name, tensor, targets in sam_leaf_map(pmod):
        for coll, key, _, fshape in targets:
            got[f"{coll}:{key}"] = tuple(fshape)
            assert int(np.prod(fshape)) == tensor.numel(), name
    assert got == want, (sorted(set(got) ^ set(want))[:10],
                         [k for k in got if k in want and got[k] != want[k]][:10])
    return sum(int(np.prod(s)) for k, s in want.items() if k.startswith("params:"))


def port_params(pmod):
    """The port's parameters plus the PE gaussian buffer(s), which the JAX
    package counts as params."""
    n = sum(p.numel() for p in pmod.parameters())
    return n + sum(b.numel() for name, b in pmod.named_buffers()
                   if name.endswith("positional_encoding_gaussian_matrix"))


def masks_agree(got, want, logits, tol=1e-3):
    """Boolean masks equal except where the JAX logit lies within ``tol`` of 0."""
    diff = got != want
    return bool(np.all(np.abs(logits[diff]) <= tol)), int(diff.sum())



def jax_sam_facade(variant: str, img_size: int, seed: int):
    """The JAX ``SAM`` facade with numpy-randomised variables, its init
    traced abstractly (jax.eval_shape) instead of run."""
    from yolo_ad_refine_tpu.models.sam import model as JM

    real = JM.build_sam

    def abstract_build(variant, img_size, dtype, _seed):
        shapes = jax.eval_shape(lambda: real(variant, img_size, dtype)[1])
        model = JM.SAMModel(img_size=img_size, dtype=dtype, **JM.SAM_VARIANTS[variant])
        return model, jax.tree.map(jax.numpy.asarray, randomize(shapes, seed=seed))

    JM.build_sam = abstract_build
    try:
        return JM.SAM(variant, img_size=img_size)
    finally:
        JM.build_sam = real


def jax_sam2(cls, variant: str, seed: int):
    """A JAX SAM2 predictor (``SAM2Predictor`` or ``SAM2VideoPredictor``)
    with numpy-randomised variables, its init traced abstractly."""
    from yolo_ad_refine_tpu.models.sam import sam2 as JS2

    real = JS2.build_sam2

    def abstract_build(variant, image_size=None, dtype=jax.numpy.float32, rng=None):
        shapes = jax.eval_shape(lambda: real(variant, image_size, dtype)[1])
        cfg = dict(JS2.SAM2_CONFIGS[variant])
        if image_size is not None:
            cfg["image_size"] = image_size
        return JS2.SAM2Net(dtype=dtype, **cfg), jax.tree.map(jax.numpy.asarray,
                                                              randomize(shapes, seed=seed))

    JS2.build_sam2 = abstract_build
    try:
        return cls(variant=variant)
    finally:
        JS2.build_sam2 = real


def record(obj, attr: str, pick):
    """Wrap ``obj.attr`` (a callable) so each call's ``pick(output)`` lands
    in the returned list, as numpy."""
    calls, fn = [], getattr(obj, attr)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(np.asarray(pick(out)))
        return out

    setattr(obj, attr, wrapped)
    return calls
