"""PyTorch / CUDA port of yolo_ad_refine_tpu for NVIDIA Hopper.

Imports torch and never JAX or the JAX package. ``YOLO(...).predict(...)``
runs the flagship YOLO-AD-Refine detector with hand-written CUDA kernels for
the deformable conv and the NMS suppression; ``FastSAM`` and ``NAS`` (its
postprocess) ride the same NMS, and ``models.sam`` holds SAM, MobileSAM and
SAM2.
"""

__version__ = "0.1.0"

from yolo_ad_refine_tpu_torch.models.yolo import YOLO  # noqa: E402
from yolo_ad_refine_tpu_torch.models.fastsam import FastSAM  # noqa: E402
from yolo_ad_refine_tpu_torch.models.nas import NAS  # noqa: E402

__all__ = ["YOLO", "FastSAM", "NAS", "__version__"]
