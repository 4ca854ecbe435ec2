"""Model construction of the PyTorch port: yaml -> torch graph, task
models, and the YOLO facade."""

from yolo_ad_refine_tpu_torch.models.parser import parse_model_yaml  # noqa: F401
from yolo_ad_refine_tpu_torch.models.model import DetectionModel, build_detection_model  # noqa: F401
