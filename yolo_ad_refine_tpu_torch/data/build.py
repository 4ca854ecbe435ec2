"""Batched, prefetching data loader with a fixed-shape padded collate.

Counterpart of ``yolo_ad_refine_tpu/data/build.py`` (reference
ultralytics/data/build.py:28-147): a thread pool (cv2 and numpy release the
GIL) fills a bounded prefetch queue; the epoch order is a permutation drawn
from ``seed + epoch`` and every sample gets its own generator seeded from
(seed + epoch, index), so a run's batches do not depend on the number of
workers; labels are padded to (B, max_boxes) with a validity mask. A
``batch_plan`` (rect validation's buckets) replaces the epoch order with
its own list of batches. With ``rank_slice`` (data-parallel training,
``parallel.multihost.per_host_batch_slice``) a rank loads only its
contiguous part of every global batch: the same samples, drawn from the
same generators, as the one-process batch holds there.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from yolo_ad_refine_tpu_torch.data.dataset import YOLODataset
from yolo_ad_refine_tpu_torch.train.segment import polygons_to_index_mask
from yolo_ad_refine_tpu_torch.utils import LOGGER

NUM_THREADS = min(8, max(1, (os.cpu_count() or 1) - 1))


def collate(samples: list[dict], max_boxes: int) -> dict:
    """Stack samples into numpy batch arrays: img (B, H, W, 3) uint8 RGB
    (the BGR -> RGB flip happens here, once), cls (B, N, 1), bboxes
    (B, N, 4) xyxy px or (B, N, 5) xywhr px for OBB, mask (B, N, 1); boxes
    past max_boxes are dropped. Pose samples add keypoints (B, N, K, 3)
    pixels; segment samples add masks (B, H/4, W/4) int32, each image's
    polygons (its first max_boxes) drawn at a quarter scale into an
    overlap-encoded index mask (``train/segment.py
    polygons_to_index_mask``, i + 1 for row i), the prototypes' size."""
    b = len(samples)
    h, w = samples[0]["img"].shape[:2]
    img = np.stack([s["img"][..., ::-1] for s in samples])  # BGR -> RGB
    cls = np.zeros((b, max_boxes, 1), np.float32)
    bboxes = np.zeros((b, max_boxes, samples[0]["bboxes"].shape[-1]), np.float32)
    mask = np.zeros((b, max_boxes, 1), np.float32)
    overflow = 0
    for i, s in enumerate(samples):
        n = len(s["cls"])
        if n > max_boxes:
            overflow += n - max_boxes
            n = max_boxes
        if n:
            cls[i, :n, 0] = s["cls"][:n]
            bboxes[i, :n] = s["bboxes"][:n]
            mask[i, :n, 0] = 1.0
    if overflow:
        LOGGER.warning(f"collate: dropped {overflow} boxes over max_boxes={max_boxes}")
    out = {"img": img, "cls": cls, "bboxes": bboxes, "mask": mask,
           "ori_shape": [s["ori_shape"] for s in samples],
           "ratio_pad": [s["ratio_pad"] for s in samples],
           "im_file": [s["im_file"] for s in samples]}
    if "keypoints" in samples[0]:
        nk = max((s["keypoints"].shape[1] for s in samples if len(s["keypoints"])), default=0)
        kpts = np.zeros((b, max_boxes, nk, 3), np.float32)
        for i, s in enumerate(samples):
            n = min(len(s["keypoints"]), max_boxes)
            if n and nk:
                kpts[i, :n] = s["keypoints"][:n]
        out["keypoints"] = kpts
    if "segments" in samples[0]:
        masks = np.zeros((b, h // 4, w // 4), np.int32)
        for i, s in enumerate(samples):
            if s["segments"]:
                masks[i] = polygons_to_index_mask([p / 4.0 for p in s["segments"][:max_boxes]],
                                                  (h // 4, w // 4))
        out["masks"] = masks
    return out


class DataLoader:
    """Thread-prefetching epoch iterator over a YOLODataset."""

    def __init__(self, dataset: YOLODataset, batch_size: int = 16, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False, workers: int | None = None,
                 prefetch: int = 4, max_boxes: int | None = None,
                 batch_plan: list | None = None, rank_slice: tuple[int, int] | None = None):
        self.dataset = dataset
        self.rank_slice = rank_slice  # (start, stop): this rank's part of every batch
        self.batch_plan = batch_plan  # explicit batches of indices, e.g. rect buckets
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.workers = workers or NUM_THREADS
        self.prefetch = prefetch
        self.max_boxes = max_boxes or dataset.max_boxes
        self.epoch = 0

    def __len__(self):
        if self.batch_plan is not None:
            return len(self.batch_plan)
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def close_mosaic(self):
        """Turn mosaic and mixup off for the last epochs."""
        self.dataset.mosaic_enabled = False
        self.dataset.hyp = {**self.dataset.hyp, "mosaic": 0.0, "mixup": 0.0, "copy_paste": 0.0}

    def indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        if self.drop_last:
            idx = idx[: (n // self.batch_size) * self.batch_size]
        return idx

    def __iter__(self):
        if self.batch_plan is not None:
            batches = self.batch_plan
        else:
            idx = self.indices()
            batches = [idx[i: i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.rank_slice is not None:
            batches = [b[self.rank_slice[0]: self.rank_slice[1]] for b in batches]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        rngs = [np.random.default_rng((self.seed + self.epoch) * 1_000_003 + int(j))
                                for j in batch_idx]
                        samples = list(pool.map(
                            lambda a: self.dataset.get_sample(int(a[0]), a[1]),
                            zip(batch_idx, rngs)))
                        q.put(collate(samples, self.max_boxes))
                q.put(None)
            except BaseException as e:  # noqa: BLE001 - handed to the consumer, which raises it
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():  # unblock a producer waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.05)


def build_dataloader(dataset, batch_size: int = 16, shuffle: bool = True, seed: int = 0,
                     workers: int | None = None, max_boxes: int | None = None) -> DataLoader:
    """A ``DataLoader`` over ``dataset`` (reference data/build.py:127)."""
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle, seed=seed,
                      workers=workers, max_boxes=max_boxes)
