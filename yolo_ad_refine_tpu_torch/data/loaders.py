"""Inference source loaders: image files, directories, videos and streams.

Counterpart of ``yolo_ad_refine_tpu/data/loaders.py:20-117`` (reference
data/loaders.py:33-523 and build.py:148): every loader yields (path, BGR
frame, metadata) on the host, with metadata {"frame": n, "video": bool}.
``LoadImagesNative``, the JAX package's threaded C++ JPEG loader, is not
ported: it raises.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

import cv2
import numpy as np

from yolo_ad_refine_tpu_torch.data.dataset import IMG_FORMATS
from yolo_ad_refine_tpu_torch.utils import LOGGER, not_ported

VID_FORMATS = {"asf", "avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "ts", "wmv", "webm"}
STREAM_PREFIXES = ("rtsp://", "rtmp://", "http://", "https://", "tcp://")


class LoadImagesAndVideos:
    """Iterate an image or video file, or the images and videos of a
    directory tree in sorted order; a video yields every ``vid_stride``-th
    frame, numbered from 1 (reference loaders.py:251)."""

    def __init__(self, source: str | Path, vid_stride: int = 1):
        p = Path(source)
        if p.is_dir():
            files = sorted(f for f in p.rglob("*")
                           if f.suffix[1:].lower() in IMG_FORMATS | VID_FORMATS)
        elif p.is_file():
            files = [p]
        else:
            raise FileNotFoundError(f"source not found: {source}")
        self.files = files
        self.vid_stride = vid_stride

    def __iter__(self):
        for f in self.files:
            if f.suffix[1:].lower() in VID_FORMATS:
                cap = cv2.VideoCapture(str(f))
                idx = 0
                while cap.grab():
                    idx += 1
                    if idx % self.vid_stride:
                        continue
                    ok, frame = cap.retrieve()
                    if not ok:
                        break
                    yield str(f), frame, {"frame": idx, "video": True}
                cap.release()
            else:
                im = cv2.imread(str(f))
                if im is None:
                    LOGGER.warning(f"skipping unreadable {f}")
                    continue
                yield str(f), im, {"frame": 0, "video": False}


class LoadStreams:
    """Threaded webcam / RTSP reader (reference loaders.py:33): a thread
    grabs every frame and keeps the newest of every ``vid_stride``-th;
    iteration yields each kept frame once, the newest when the consumer is
    slower than the stream, and ends when the stream does or ``close`` is
    called. (The JAX reader yields the newest frame again and again and
    never ends.)"""

    def __init__(self, source: str = "0", vid_stride: int = 1, buffer: bool = False):
        self.source = int(source) if str(source).isdigit() else source
        self.vid_stride = vid_stride
        self.buffer = buffer
        self.cap = cv2.VideoCapture(self.source)
        if not self.cap.isOpened():
            raise ConnectionError(f"failed to open stream {source}")
        self.frame, self.count = None, 0
        self.running = True
        self.lock = threading.Lock()
        self.thread = threading.Thread(target=self._reader, daemon=True)
        self.thread.start()

    def _reader(self):
        n = 0
        while self.running and self.cap.grab():
            n += 1
            if n % self.vid_stride == 0:
                ok, frame = self.cap.retrieve()
                if ok:
                    with self.lock:
                        self.frame, self.count = frame, self.count + 1
            time.sleep(0.0)
        self.running = False  # the stream ended, or close() asked

    def __iter__(self):
        seen = 0
        while True:
            alive = self.running  # read first: the last frame is stored before it turns False
            with self.lock:
                frame, count = self.frame, self.count
            if count > seen:
                seen = count
                yield str(self.source), frame.copy(), {"frame": seen, "video": True}
            elif not alive:
                self.close()
                return
            else:
                time.sleep(0.001)

    def close(self):
        self.running = False
        self.thread.join(timeout=1)
        self.cap.release()


def load_inference_source(source, vid_stride: int = 1):
    """The loader for ``source`` (reference build.py:148 check_source): a
    numpy image, a camera index or stream URL (``LoadStreams``), or a file
    or directory path (``LoadImagesAndVideos``)."""
    if isinstance(source, np.ndarray):
        def gen():
            yield "image0.jpg", source, {"frame": 0, "video": False}

        return gen()
    s = str(source)
    if s.isdigit() or s.startswith(STREAM_PREFIXES):
        return LoadStreams(s, vid_stride)
    return LoadImagesAndVideos(source, vid_stride)


class LoadImagesNative:
    """The JAX package's threaded C++ JPEG decode and letterbox
    (``csrc/yat_loader.cpp``), not ported: it needs libjpeg on the card's
    machine."""

    def __init__(self, *args, **kwargs):
        not_ported("LoadImagesNative (the C++ JPEG loader, csrc/yat_loader.cpp)",
                   "ROADMAP Queue 1 item 15")
