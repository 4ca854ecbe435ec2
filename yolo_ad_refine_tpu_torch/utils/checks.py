"""Runtime checks: the image-size rounding, a version comparison, and the
bf16 canary of the trainer.

Counterpart of ``yolo_ad_refine_tpu/utils/checks.py`` (reference
utils/checks.py:132 check_imgsz, :244 check_version, :651 check_amp). The
canary runs the model's eval forward on one random image in fp32 and under
bf16 autocast; if the decoded boxes or class probabilities diverge, bf16 is
unsafe for this model and training falls back to fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_ad_refine_tpu_torch.utils import LOGGER, colorstr


def check_imgsz(imgsz: int, stride: int = 32, min_dim: int = 0, floor: int = 0) -> int:
    """``imgsz`` rounded up to a multiple of ``stride``, at least ``floor``
    (reference checks.py:132); ``min_dim`` is accepted and unused, as in
    the JAX package."""
    sz = max(int(np.ceil(imgsz / stride) * stride), floor)
    if sz != imgsz:
        LOGGER.warning(f"imgsz={imgsz} must be a multiple of stride {stride}; updating to {sz}")
    del min_dim
    return sz


def check_version(current: str, required: str = "") -> bool:
    """Whether version ``current`` meets ``required`` (">=1.2", "==2.0",
    "<3"; a bare version means >=), comparing the numeric fields."""
    if not required:
        return True

    def parse(v):
        return tuple(int(x) for x in v.strip("<>=!, ").split(".") if x.isdigit())

    op = "".join(c for c in required if c in "<>=!") or ">="
    cur, want = parse(current), parse(required)
    return {">=": cur >= want, ">": cur > want, "<=": cur <= want, "<": cur < want,
            "==": cur == want, "!=": cur != want}[op]


@torch.no_grad()
def check_amp(model: torch.nn.Module, imgsz: int = 256, atol: float = 0.5) -> bool:
    """True when bf16 autocast is safe for ``model`` (on its device)."""
    dev = next(model.parameters()).device
    training = model.training
    model.eval()
    x = torch.from_numpy(np.random.default_rng(0).random((1, 3, imgsz, imgsz), np.float32))
    x = x.to(dev).contiguous(memory_format=torch.channels_last)
    y32 = model(x)[0].float()
    with torch.autocast(dev.type, dtype=torch.bfloat16):
        y16 = model(x)[0].float()
    model.train(training)
    dprob = (y32[..., 4:] - y16[..., 4:]).abs().max().item()
    dbox = (y32[..., :4] - y16[..., :4]).abs().max().item()
    ok = dprob < atol and dbox < imgsz * 0.02
    if ok:
        LOGGER.info(f"{colorstr('AMP:')} bf16 canary passed")
    else:
        LOGGER.warning(f"{colorstr('AMP:')} bf16 canary FAILED (dprob {dprob:.3f}, "
                       f"dbox {dbox:.1f}px); falling back to float32 training")
    return ok
