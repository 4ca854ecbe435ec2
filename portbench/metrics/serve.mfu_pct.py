"""The served forward's share of the card's peak in the precision that
serving runs in (TF32 where cuDNN's TF32 is on, as PyTorch's default has
it, else fp32): the frozen reference's forward FLOPs an image times the
window's images/s. The window's rate, not the traced tail's: the profiler
slows the host's side of a batch, about twofold on these paths."""

from portbench.work import PEAK_FLOPS, forward_flops


def read(run):
    import torch

    peak = PEAK_FLOPS["tf32" if torch.backends.cudnn.allow_tf32 else "fp32"]
    rate = run.out["e2e"]["serve_images_per_s"]
    return 100.0 * forward_flops(run.config, run.config["imgsz"]) * rate / peak
