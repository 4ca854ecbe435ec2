"""SAM family of the PyTorch port: SAM (vit-b / l / h), MobileSAM (TinyViT)
and SAM2 (Hiera; image and video predictors in ``sam2``)."""

from yolo_ad_refine_tpu_torch.models.sam.model import SAM, SAMModel, build_sam  # noqa: F401

__all__ = ["SAM", "SAMModel", "build_sam"]
