"""Solution apps over detection / tracking results, in the PyTorch port
(counterpart of ``yolo_ad_refine_tpu/solutions``).

Parity surface: reference ultralytics/solutions/ — all ten apps
(object_counter, heatmap, speed_estimation, distance_calculation,
queue_management, ai_gym, analytics, parking_management,
streamlit_inference, plus the shared geometry helpers the reference keeps
in solutions.py). Each consumes per-frame Results (with track ids where
counting is identity-based) and maintains host-side state; none touch the
device path.
"""

from yolo_ad_refine_tpu_torch.solutions.object_counter import ObjectCounter  # noqa: F401
from yolo_ad_refine_tpu_torch.solutions.heatmap import Heatmap  # noqa: F401
from yolo_ad_refine_tpu_torch.solutions.speed_estimator import SpeedEstimator  # noqa: F401
from yolo_ad_refine_tpu_torch.solutions.queue_manager import QueueManager  # noqa: F401
from yolo_ad_refine_tpu_torch.solutions.distance_calculator import DistanceCalculator  # noqa: F401
from yolo_ad_refine_tpu_torch.solutions.ai_gym import AIGym  # noqa: F401
from yolo_ad_refine_tpu_torch.solutions.analytics import Analytics  # noqa: F401
from yolo_ad_refine_tpu_torch.solutions.parking_manager import ParkingManager  # noqa: F401
from yolo_ad_refine_tpu_torch.solutions.inference_app import run_headless  # noqa: F401
