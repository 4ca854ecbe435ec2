"""Multi-object trackers of the PyTorch port.

Counterpart of ``yolo_ad_refine_tpu/trackers`` (reference
ultralytics/trackers/): BYTETracker (Kalman-filtered two-stage IoU
association) and BOTSORT (BYTE with sparse-optical-flow camera-motion
compensation). Host numpy / scipy / cv2: tracking reads the NMS's rows,
not device tensors; ``engine/track.py`` drives them frame by frame.
"""

from yolo_ad_refine_tpu_torch.trackers.bot_sort import BOTSORT  # noqa: F401
from yolo_ad_refine_tpu_torch.trackers.byte_tracker import BYTETracker, STrack  # noqa: F401

TRACKER_MAP = {"bytetrack": BYTETracker, "botsort": BOTSORT}
