"""Seeded weights for a configuration, made on the device in one draw.

The names, shapes and draw order come from the frozen reference
(``reference/model.py``), never from the program: every convolution,
linear and attention projection weight is drawn from one normal sample of
a ``torch.Generator`` on the device, scaled by ``1 / sqrt(fan_in)``;
every other tensor keeps its constructor's value (norm scales 1, biases 0,
the modules' own constants); the AYHead's box biases are 1 and its class
biases take the prior 0.01 (its ``bias_init``), class 0's the
configuration's ``class0_prior`` (training); serving sets them with
``calibrate`` instead. The same seed gives the same tensors on the same
device type. The harness loads the result into the program and into
the reference alike.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from portbench.reference import modules as M
from portbench.reference.model import build

DRAWN = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear, M.ModulatedDeformConv)
# calibrate: class 0's CANDIDATES-th highest anchor an image at conf, each other
# class's highest anchor OTHER_MARGIN logits under it
CANDIDATES, OTHER_MARGIN = 48, 1.0


def logit(p: float) -> float:
    return math.log(p / (1 - p))


def _fan_in(m: nn.Module, w: torch.Tensor) -> int:
    if isinstance(m, nn.ConvTranspose2d):  # (in, out / g, k, k): each output reads in·k²/s²
        return max(1, round(w.shape[0] * w.shape[2] * w.shape[3] / (m.stride[0] * m.stride[1])))
    return math.prod(w.shape[1:])


@torch.no_grad()
def make_state(cfg: dict, seed: int, device, cls_bias: torch.Tensor | None = None) -> dict:
    """The state dict of ``cfg``'s model for ``seed`` on ``device``;
    ``cls_bias`` (nc,) replaces the head's class biases (``calibrate``)."""
    ref = build(cfg["yaml_path"], cfg["scale"], device="meta")
    names = {id(p): n for n, p in ref.named_parameters()}
    drawn = []  # (name, shape, std)
    for m in ref.modules():
        tensors = [m.weight] if isinstance(m, DRAWN) else []
        if isinstance(m, nn.MultiheadAttention):
            tensors = [m.in_proj_weight]
        for w in tensors:
            drawn.append((names[id(w)], tuple(w.shape), 1.0 / math.sqrt(_fan_in(m, w))))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(math.prod(s) for _, s, _ in drawn), generator=gen, device=device)
    state = {}
    at = 0
    for name, shape, std in drawn:
        n = math.prod(shape)
        state[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    for name, t in ref.state_dict().items():
        if name not in state:  # constructor values, remade off the meta device
            state[name] = constructor_value(ref, name, t, device)
    head = f"model.{len(ref.model) - 1}"
    state[f"{head}.cv2.bias"].fill_(1.0)
    if cls_bias is not None:
        state[f"{head}.cv3.bias"].copy_(cls_bias)
    else:
        state[f"{head}.cv3.bias"].fill_(logit(0.01))
        state[f"{head}.cv3.bias"][0] = logit(cfg["class0_prior"])
    return state


@torch.no_grad()
def calibrate(cfg: dict, seed: int, images: list, conf: float, device) -> torch.Tensor:
    """Class biases that give every seed the same amount of NMS work: from
    the reference's class logits without biases on the probe ``images``
    (fp32, TF32 off), class 0's puts its ``CANDIDATES``-th highest anchor an
    image (the median over the images) at ``conf``, and each other class's
    its highest anchor ``OTHER_MARGIN`` logits under ``conf``.
    Drawn weights alone pass conf at no anchor for one seed and at every
    anchor for another (0 to 300 rows an image at x)."""
    from portbench.harness import tf32_off
    from portbench.reference.postprocess import preprocess

    ref = build(cfg["yaml_path"], cfg["scale"], device=device)
    state = make_state(cfg, seed, device, cls_bias=torch.zeros(cfg["nc"]))
    ref.load_state_dict(state)
    with tf32_off():
        x, _ = preprocess(images, cfg["imgsz"], device)
        z = torch.logit(ref.eval()(x)[0][..., 4:].double())  # (B, N, nc)
    del ref, state
    t = logit(conf)
    bias = t - OTHER_MARGIN - z.amax(dim=(0, 1))
    bias[0] = t - z[..., 0].topk(CANDIDATES, dim=1).values[:, -1].median()
    return bias.float().cpu()


def constructor_value(ref: nn.Module, name: str, t: torch.Tensor, device) -> torch.Tensor:
    """The value ``name`` takes when the reference's module is constructed,
    rebuilt on ``device`` (the meta tensors hold none)."""
    owner = ref.get_submodule(name.rsplit(".", 1)[0])
    leaf = name.rsplit(".", 1)[1]
    with torch.device(device):
        if isinstance(owner, (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)):
            if leaf in ("weight", "running_var"):
                return torch.ones(t.shape)
            return torch.zeros(t.shape, dtype=t.dtype)
        if leaf == "bias" or leaf == "in_proj_bias":
            return torch.zeros(t.shape)
        value = _CONSTANTS.get((type(owner).__name__, leaf))
        if value is None:
            raise KeyError(f"no constructor value for {type(owner).__name__}.{leaf}")
        return value(t.shape).to(t.dtype)


# the constants the flagship's modules set in their constructors
_CONSTANTS = {
    ("Fusion", "fusion_weight"): lambda s: torch.ones(s),
    ("Scale", "scale"): lambda s: torch.ones(s),
    ("ProgressiveTSSAFusion", "residual_weight1"): lambda s: torch.full(s, 0.1),
    ("ProgressiveTSSAFusion", "residual_weight2"): lambda s: torch.full(s, 0.1),
    ("ProgressiveFeatureFusion", "stage_attention"): lambda s: torch.full(s, 1.0 / s[0]),
    ("AdaptiveDynamicTanh", "alphas"): lambda s: torch.linspace(0.3, 1.0, s[1]).view(s),
    ("AdaptiveDynamicTanh", "scale_weights"): lambda s: torch.full(s, 1.0 / s[0]),
    ("AdaptiveDynamicTanh", "weight"): lambda s: torch.ones(s),
    ("CrossScaleAttentionTSSA", "temps"): lambda s: torch.ones(s),
    ("EDFFN", "fft"): lambda s: torch.ones(s),
}
