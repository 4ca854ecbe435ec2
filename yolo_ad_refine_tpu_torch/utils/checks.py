"""The bf16 canary of the trainer.

Counterpart of ``check_amp`` in ``yolo_ad_refine_tpu/utils/checks.py``
(reference utils/checks.py:651): the model's eval forward on one random
image in fp32 and under bf16 autocast; if the decoded boxes or class
probabilities diverge, bf16 is unsafe for this model and training falls
back to fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_ad_refine_tpu_torch.utils import LOGGER, colorstr


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
