"""PyTorch / CUDA port of yolo_ad_refine_tpu for NVIDIA Hopper.

Imports torch and never JAX or the JAX package. ``YOLO(...).predict(...)``
runs the flagship YOLO-AD-Refine detector with hand-written CUDA kernels for
the deformable conv and the NMS suppression.
"""

__version__ = "0.1.0"

from yolo_ad_refine_tpu_torch.models.yolo import YOLO  # noqa: E402

__all__ = ["YOLO", "__version__"]
