"""The whole training step's share of the card's bf16 peak: 3x the frozen
reference's forward FLOPs an image (FlopCounterMode) times the window's
images/s, over 989 TFLOP/s. The window's rate, not the traced tail's: the
profiler slows the host's side of a step."""

from portbench.work import PEAK_FLOPS, forward_flops


def read(run):
    flops = 3 * forward_flops(run.config, run.config["imgsz"])
    return 100.0 * flops * run.out["e2e"]["train_images_per_s"] / PEAK_FLOPS["bf16"]
