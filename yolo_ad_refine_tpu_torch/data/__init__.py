"""The data pipeline of the PyTorch port: datasets, augmentations, loaders
(counterpart of ``yolo_ad_refine_tpu/data``; reference ultralytics/data/).
"""

from yolo_ad_refine_tpu_torch.data.dataset import YOLODataset, check_det_dataset  # noqa: F401
from yolo_ad_refine_tpu_torch.data.build import DataLoader, build_dataloader  # noqa: F401
