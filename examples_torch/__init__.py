"""The example scripts of the PyTorch / CUDA port (README.md here): each
the counterpart of the JAX package's script of the same name in
``examples/``, importing only ``yolo_ad_refine_tpu_torch``."""
