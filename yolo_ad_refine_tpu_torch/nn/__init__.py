"""The module library of the PyTorch port (counterpart of
``yolo_ad_refine_tpu/nn``; reference ultralytics/nn/modules). Modules are
registered by name for the yaml parser in ``models/parser.py``.
"""

from yolo_ad_refine_tpu_torch.nn import block, common, head  # noqa: F401
from yolo_ad_refine_tpu_torch.nn.registry import MODULE_REGISTRY, register  # noqa: F401
