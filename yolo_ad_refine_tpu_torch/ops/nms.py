"""Fixed-shape non-maximum suppression on torch tensors.

Counterpart of ``yolo_ad_refine_tpu/ops/nms.py`` (reference
ultralytics/utils/ops.py:163): confidence filter -> top ``max_nms``
candidates -> class-offset boxes -> greedy suppression -> a fixed
(max_det, 6) output per image plus counts.

The suppression is a TPU kernel of ``ops/nms_pallas.py``, ported to Hopper
in ``csrc/nms.cu``:

- axis-aligned IoU, ``_suppress_kernel`` (K4): ``suppress`` launches its
  port on CUDA tensors and runs ``suppress_plain``, a port of ``_suppress``,
  on CPU tensors;
- rotated boxes (OBB), probiou as the overlap, ``_suppress_rotated_kernel``
  (K5): ``suppress_rotated`` and ``suppress_rotated_plain``, a port of
  ``_suppress_rotated``.

Candidate selection uses a stable descending sort, which keeps
``jax.lax.top_k``'s tie order (lower index first); ``torch.topk`` leaves
ties unspecified.
"""

from __future__ import annotations

import ctypes
import math

import torch

from yolo_ad_refine_tpu_torch.ops.boxes import xywh2xyxy
from yolo_ad_refine_tpu_torch.ops.iou import _obb_covariance, probiou
from yolo_ad_refine_tpu_torch.utils import kernels


def suppress_plain(boxes, scores, iou_thres: float, conf_thres: float):
    """Greedy NMS keep mask in plain PyTorch. boxes (B, K, 4) xyxy, already
    class-offset; scores (B, K) descending. Returns keep (B, K) bool, the
    mask of the JAX ``_suppress`` for each image."""
    area = (boxes[..., 2:4] - boxes[..., :2]).clamp(min=0).prod(-1)  # (B, K)
    lt = torch.maximum(boxes[:, :, None, :2], boxes[:, None, :, :2])
    rb = torch.minimum(boxes[:, :, None, 2:4], boxes[:, None, :, 2:4])
    inter = (rb - lt).clamp(min=0).prod(-1)  # (B, K, K): row i, column j
    iou = inter / (area[:, :, None] + area[:, None, :] - inter + 1e-7)
    return _greedy_walk(iou > iou_thres, scores, conf_thres)


def _greedy_walk(over, scores, conf_thres: float, forced=None):
    """Keep mask (B, K) of the greedy walk: candidate i is kept if it is
    alive and its score > conf_thres, and then kills every later j with
    ``over[:, i, j]``. ``forced`` ({i: bool}) sets candidate i's decision
    in every image instead."""
    b, k = scores.shape
    over = over & torch.ones(k, k, dtype=torch.bool, device=over.device).triu(1)
    alive = torch.ones(b, k, dtype=torch.bool, device=over.device)
    keep = torch.zeros(b, k, dtype=torch.bool, device=over.device)
    valid = scores > conf_thres
    for i in range(k):
        cur = alive[:, i] & valid[:, i]
        if forced and i in forced:
            cur = torch.full_like(cur, forced[i])
        keep[:, i] = cur
        alive &= ~(over[:, i] & cur[:, None])
    return keep


# csrc/nms.cu's launch: candidates a mask word, threads of a mask block (one
# row of each of 4 tiles a thread) and of a walk block (one image), the
# walk's fixed shared bytes (kept word and kept list of two rounds), a
# block's shared memory without opting in, and grid.y (the image) bound
NMS_WORD, NMS_MASK_THREADS, NMS_WALK_THREADS = 64, 256, 512
NMS_WALK_FIXED_SMEM, NMS_SMEM_DEFAULT, NMS_GRID_Y_MAX = 2 * 8 + 2 * 64, 48 * 1024, 65535


def nms_launch(b: int, k: int) -> dict:
    """The launch arithmetic of K4 and K5 (``csrc/nms.cu``, whose
    ``nms_launch_plan`` computes the same) for B images of K candidates:
    ``nwords`` mask words a row, ``tiles`` 64 x 64 mask tiles an image (the
    upper triangle the walk reads, nwords * (nwords + 1) / 2),
    ``mask_blocks`` / ``mask_threads`` of the mask kernel (4 tiles a block),
    ``walk_blocks`` / ``walk_threads`` and ``walk_smem`` bytes of the walk
    (one block an image, the removed bitmask in shared memory). Raises
    ValueError, naming the bound, for a shape that cannot launch."""
    if b < 1 or k < 1:
        raise ValueError(f"nms: B={b} and K={k} must both be at least 1")
    nwords = -(-k // NMS_WORD)
    tiles = nwords * (nwords + 1) // 2
    tiles_per_block = NMS_MASK_THREADS // NMS_WORD
    smem = 8 * nwords + NMS_WALK_FIXED_SMEM
    if smem > NMS_SMEM_DEFAULT:
        raise ValueError(f"nms: K={k} needs {smem} bytes of shared memory for the walk's removed "
                         f"bitmask, more than the {NMS_SMEM_DEFAULT} a block takes without opting "
                         f"in (K <= {NMS_WORD * ((NMS_SMEM_DEFAULT - NMS_WALK_FIXED_SMEM) // 8)})")
    if b > NMS_GRID_Y_MAX:
        raise ValueError(f"nms: B={b} images exceed the mask grid's y dimension, "
                         f"{NMS_GRID_Y_MAX}")
    return {"nwords": nwords, "tiles": tiles, "mask_blocks": -(-tiles // tiles_per_block) * b,
            "mask_threads": NMS_MASK_THREADS, "walk_blocks": b, "walk_threads": NMS_WALK_THREADS,
            "walk_smem": smem}


def nms_tile(index: int, nwords: int) -> tuple[int, int]:
    """(row block, column block) of mask tile ``index`` of an image, as the
    mask kernels number the upper triangle: from the last tile row up, row
    rb holding the tiles cb = rb .. nwords - 1."""
    r = (math.isqrt(8 * index + 1) - 1) // 2
    rb = nwords - 1 - r
    return rb, rb + index - r * (r + 1) // 2


def _check_inputs(what: str, boxes, scores, width: int) -> None:
    """What a kernel takes: CUDA fp32 contiguous (B, K, width) and (B, K)."""
    if boxes.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {boxes.device}")
    if (boxes.dim() != 3 or boxes.shape[-1] != width
            or tuple(scores.shape) != tuple(boxes.shape[:2])):
        raise ValueError(f"{what}: boxes (B, K, {width}) and scores (B, K) expected, got "
                         f"{tuple(boxes.shape)}, {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"{what}: boxes and scores must be float32, got {boxes.dtype}, "
                        f"{scores.dtype}")
    if scores.device != boxes.device:
        raise ValueError(f"{what}: boxes and scores must be on one device")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError(f"{what}: boxes and scores must be contiguous")


def _launch(entry: str, data, scores, iou_thres: float, conf_thres: float):
    """Run the C entry ``entry`` of ``csrc/nms.cu`` on ``data`` (boxes or
    planes) and scores; the wrapper allocates the keep mask and the
    (B, K, ceil(K / 64)) uint64 mask scratch. Returns keep (B, K) bool."""
    b, k = scores.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=scores.device)
    if b == 0 or k == 0:
        return keep
    nms_launch(b, k)
    mask_ws = torch.empty((b, k, -(-k // 64)), dtype=torch.int64, device=scores.device)
    lib = kernels.load("nms")
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p]
    status = fn(data.data_ptr(), scores.data_ptr(), mask_ws.data_ptr(), keep.data_ptr(), b, k,
                float(iou_thres), float(conf_thres),
                torch.cuda.current_stream(scores.device).cuda_stream)
    kernels.check(lib, status, entry)
    return keep


def suppress(boxes, scores, iou_thres: float, conf_thres: float):
    """Greedy NMS keep mask (B, K) bool. A CPU tensor runs
    ``suppress_plain``; a CUDA tensor launches ``csrc/nms.cu``."""
    if boxes.device.type == "cpu":
        return suppress_plain(boxes, scores, iou_thres, conf_thres)
    _check_inputs("suppress", boxes, scores, 4)
    keep = _launch("nms_suppress", boxes, scores, iou_thres, conf_thres)
    suppress.launches += 1
    return keep


suppress.launches = 0


def rotated_planes(rboxes):
    """(B, K, 5) xywhr -> (B, 6, K) fp32 planes [x, y, a, b, c,
    clip(a*b - c^2, 0)] of the boxes' Gaussians, the terms ``probiou``
    computes from each box, as the wrapper of the TPU kernel precomputes
    them (ops/nms_pallas.py:153-160)."""
    rb = rboxes.float()
    a, b, c = _obb_covariance(rb)
    return torch.stack([rb[..., 0], rb[..., 1], a, b, c, (a * b - c**2).clamp(min=0)], 1)


def rotated_rounding_ties(got, want, rboxes, scores, iou_thres: float, conf_thres: float,
                          tol: float = 1e-5) -> int:
    """Hold K5's keep mask ``got`` against the plain version's ``want`` for
    the same inputs. Each difference must be a rounding tie: the candidate's
    (plain) probiou against a candidate kept before it lies within ``tol``
    of ``iou_thres``, where exp / log from another library may decide the
    pair the other way. After each tie the plain walk of that image is
    replayed with the candidate's decision forced to K5's, and the next
    difference is taken against the replay, so a later one that does not
    follow from the tie must be a tie of its own. Returns the number of
    ties; raises AssertionError on any other difference."""
    ties = 0
    for b in torch.nonzero((got != want).any(dim=1)).flatten().tolist():
        rb = rboxes[b: b + 1].float()
        iou = probiou(rb[:, :, None], rb[:, None, :])[0]
        ref, forced = want[b], {}
        while not torch.equal(got[b], ref):
            j = int(torch.nonzero(got[b] != ref)[0])
            near = ((iou[:j, j] - iou_thres).abs() <= tol) & ref[:j]
            if not bool(near.any()):
                raise AssertionError(
                    f"keep masks differ at image {b}, candidate {j}, with no probiou within "
                    f"{tol} of iou_thres {iou_thres} against an earlier kept candidate")
            ties += 1
            forced[j] = bool(got[b, j])
            ref = _greedy_walk(iou[None] > iou_thres, scores[b: b + 1], conf_thres, forced)[0]
    return ties


def suppress_rotated_plain(rboxes, scores, iou_thres: float, conf_thres: float):
    """Rotated greedy NMS keep mask in plain PyTorch. rboxes (B, K, 5) xywhr
    with class-offset centres; scores (B, K) descending. Returns keep
    (B, K) bool, the mask of the JAX ``_suppress_rotated`` for each image."""
    rb = rboxes.float()
    return _greedy_walk(probiou(rb[:, :, None], rb[:, None, :]) > iou_thres, scores, conf_thres)


def suppress_rotated(rboxes, scores, iou_thres: float, conf_thres: float):
    """Rotated greedy NMS keep mask (B, K) bool. A CPU tensor runs
    ``suppress_rotated_plain``; a CUDA tensor computes the planes with
    ``rotated_planes`` and launches K5 (``csrc/nms.cu``), whose probiou
    repeats ``ops/iou.py:probiou`` operation by operation on those planes."""
    if rboxes.device.type == "cpu":
        return suppress_rotated_plain(rboxes, scores, iou_thres, conf_thres)
    _check_inputs("suppress_rotated", rboxes, scores, 5)
    planes = rotated_planes(rboxes).contiguous()
    keep = _launch("nms_rotated_suppress", planes, scores, iou_thres, conf_thres)
    suppress_rotated.launches += 1
    return keep


suppress_rotated.launches = 0


def select_candidates(prediction, conf_thres: float, max_nms: int = 2048,
                      max_wh: float = 7680.0, multi_label: bool = False,
                      agnostic: bool = False, nc: int = 80, rotated: bool = False):
    """The suppression's input: the top ``max_nms`` candidates by a stable
    descending sort of the scores (those at or under ``conf_thres`` set to
    -1). Returns (boxes, scores, rows, cls, anchor): boxes (B, K, 4) xyxy,
    or (B, K, 5) xywhr for ``rotated``, class-offset and contiguous, as the
    kernels take them; scores (B, K); rows (B, K, 4), the boxes of the
    output rows (xyxy, or xywh for ``rotated``) without the offset; the
    class (B, K) as float and the anchor index (B, K) of each candidate."""
    pred = prediction[..., : 4 + nc].float()
    b, n = pred.shape[:2]
    scores_all = pred[..., 4: 4 + nc]
    if multi_label and nc > 1:
        flat = scores_all.reshape(b, -1)
        flat = torch.where(flat > conf_thres, flat, torch.full_like(flat, -1.0))
        k = min(max_nms, flat.shape[1])
        top_scores, top_idx = torch.sort(flat, dim=1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        anchor_idx = top_idx // nc
        cls_idx = (top_idx % nc).float()
    else:
        conf, cls = scores_all.max(dim=-1)
        conf = torch.where(conf > conf_thres, conf, torch.full_like(conf, -1.0))
        k = min(max_nms, n)
        top_scores, anchor_idx = torch.sort(conf, dim=1, descending=True, stable=True)
        top_scores, anchor_idx = top_scores[:, :k], anchor_idx[:, :k]
        cls_idx = torch.gather(cls, 1, anchor_idx).float()

    offset = torch.zeros_like(cls_idx) if agnostic else cls_idx * max_wh
    cand = torch.gather(pred[..., :4], 1, anchor_idx[..., None].expand(b, k, 4))
    if rotated:  # only the centres take the offset; the angle is the first extra column
        angle = torch.gather(prediction[..., 4 + nc: 5 + nc].float(), 1, anchor_idx[..., None])
        boxes = torch.cat([cand[..., :2] + offset[..., None], cand[..., 2:4], angle], -1)
        rows = cand
    else:
        rows = xywh2xyxy(cand)
        boxes = rows + offset[..., None]
    return boxes.contiguous(), top_scores.contiguous(), rows, cls_idx, anchor_idx


def non_max_suppression(prediction, conf_thres: float = 0.25, iou_thres: float = 0.45,
                        max_det: int = 300, max_nms: int = 2048, max_wh: float = 7680.0,
                        multi_label: bool = False, agnostic: bool = False, nc: int = 80,
                        rotated: bool = False):
    """Batched fixed-shape NMS.

    prediction: (B, N, 4+nc[+E]) xywh boxes + sigmoided class scores; columns
    beyond 4+nc are carried through. Returns detections (B, max_det, 6) rows
    of (x1, y1, x2, y2, conf, cls) with zero rows past each image's count,
    counts (B,) int32 and extras (B, max_det, E). ``rotated`` (OBB): the
    first extra column is the angle, suppression is by probiou, only the
    centres take the class offset, and the detection rows stay
    (cx, cy, w, h, conf, cls) (reference ops.py:279-299).
    """
    boxes, top_scores, cand_boxes, cls_idx, anchor_idx = select_candidates(
        prediction, conf_thres, max_nms, max_wh, multi_label, agnostic, nc, rotated)
    keep = (suppress_rotated if rotated else suppress)(boxes, top_scores, iou_thres, conf_thres)

    b, k = top_scores.shape
    extra = prediction[..., 4 + nc:]
    rows = torch.cat([cand_boxes, top_scores[..., None], cls_idx[..., None]], dim=-1)
    rank = torch.cumsum(keep.long(), dim=1) - 1
    dst = torch.where(keep & (rank < max_det), rank, torch.full_like(rank, max_det))
    out = torch.zeros((b, max_det + 1, 6), dtype=rows.dtype, device=rows.device)
    out.scatter_(1, dst[..., None].expand(b, k, 6), rows)
    counts = keep.sum(dim=1).clamp(max=max_det).to(torch.int32)
    e = extra.shape[-1]
    extra_rows = torch.gather(extra, 1, anchor_idx[..., None].expand(b, k, e))
    extra_out = torch.zeros((b, max_det + 1, e), dtype=extra.dtype, device=extra.device)
    extra_out.scatter_(1, dst[..., None].expand(b, k, e), extra_rows)
    return out[:, :max_det], counts, extra_out[:, :max_det]


def nms_free_rows(det, conf_thres: float):
    """YOLOv10's rows without suppression (the JAX validator's NMS-free
    branch, its engine/validator.py:127-135): ``det`` (B, K, 6) xywh, score,
    class, score-sorted, as v10Detect selects them -> xyxy rows, those at or
    under ``conf_thres`` zeroed, their counts (B,) int32 and empty extras
    (B, K, 0)."""
    keep = det[..., 4] > conf_thres
    out = torch.cat([xywh2xyxy(det[..., :4]), det[..., 4:6]], -1) * keep[..., None]
    return out, keep.sum(-1).to(torch.int32), det.new_zeros((*det.shape[:2], 0))


def rtdetr_rows(y, conf_thres: float, imgsz: int):
    """RT-DETR's rows without suppression (the JAX validator's branch, its
    engine/validator.py:111-126): ``y`` (B, nq, 4+nc) normalised xywh and
    scores -> rows of xyxy in input pixels (x imgsz), the best class's score
    and its id (the first among ties), in descending score order (a stable
    sort, as jnp.argsort), those at or under ``conf_thres`` zeroed, their
    counts (B,) int32 and empty extras (B, nq, 0)."""
    boxes = xywh2xyxy(y[..., :4].float()) * imgsz
    scores = y[..., 4:].float()
    score, cls = scores.max(-1).values, scores.argmax(-1)
    order = torch.sort(-score, dim=-1, stable=True).indices
    d = torch.cat([boxes, score[..., None], cls[..., None].float()], -1)
    d = torch.gather(d, 1, order[..., None].expand(-1, -1, 6))
    keep = d[..., 4] > conf_thres
    return d * keep[..., None], keep.sum(-1).to(torch.int32), d.new_zeros((*d.shape[:2], 0))
