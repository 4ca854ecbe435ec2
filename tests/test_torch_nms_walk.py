"""The algorithm of K4 / K5 (``csrc/nms.cu``), modelled in numpy, against
the plain versions and the JAX ``_suppress``, bit for bit.

The kernels cannot run here, so this file models what they do and holds
the model to the reference: the mask kernel writes, for each valid row (score
> conf), only the 64 x 64 tiles of the upper triangle in the order
``nms_tile`` numbers them, and masks j <= i and j >= K; every other word of
the scratch stays garbage (random bits here). The walk then takes the
candidates a 64-bit word at a time: within a word it starts from all
candidates as kept and repeats kept = candidates minus the OR of the kept
ones' diagonal words until kept holds still; then it ORs the kept rows'
later words into the removed bitmask. ``nms_launch`` is the launch
arithmetic both kernels use.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_ad_refine_tpu.ops.nms import _suppress
from yolo_ad_refine_tpu_torch.ops.iou import probiou
from yolo_ad_refine_tpu_torch.ops.nms import (
    NMS_SMEM_DEFAULT, _launch, nms_launch, nms_tile, suppress_plain, suppress_rotated_plain)

W = 64
ALL = (1 << W) - 1


def _iou_over(boxes, iou_thres):
    """(K, K) bool IoU > iou_thres of (K, 4) fp32 xyxy boxes, in the plain
    version's order of fp32 operations, computed in row chunks."""
    area = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(boxes[:, 3] - boxes[:, 1], 0)
    over = np.zeros((len(boxes), len(boxes)), bool)
    for s in range(0, len(boxes), 512):
        b = boxes[s: s + 512, None]
        iw = np.maximum(np.minimum(b[..., 2], boxes[:, 2]) - np.maximum(b[..., 0], boxes[:, 0]), 0)
        ih = np.maximum(np.minimum(b[..., 3], boxes[:, 3]) - np.maximum(b[..., 1], boxes[:, 1]), 0)
        inter = iw * ih
        den = area[s: s + 512, None] + area[None, :] - inter + np.float32(1e-7)
        over[s: s + 512] = inter / den > np.float32(iou_thres)
    return over


def _mask_model(over, valid, rng):
    """The (K, nwords) uint64 scratch as the mask kernel leaves it: garbage
    except each valid row's words of the upper tiles. Returns it and the
    number of words written."""
    k = len(valid)
    nw = -(-k // W)
    bits = np.zeros((k, nw * W), bool)
    bits[:, :k] = np.triu(over, 1)
    words = np.packbits(bits.reshape(k, nw, W), axis=-1, bitorder="little").view("<u8")[..., 0]
    mask = rng.integers(0, 2**64 - 1, (k, nw), dtype=np.uint64, endpoint=True)
    written = 0
    for idx in range(nw * (nw + 1) // 2):
        rb, cb = nms_tile(idx, nw)
        rows = np.arange(rb * W, min(rb * W + W, k))
        rows = rows[valid[rows]]
        mask[rows, cb] = words[rows, cb]
        written += len(rows)
    return mask, written


def _walk_model(mask, valid, rng):
    """The word-blocked walk over the scratch. Returns the keep mask and the
    passes of the in-word loop."""
    k, nw = mask.shape
    removed = [0] * nw
    keep = np.zeros(k, bool)
    rounds = 0
    for t in range(nw):
        lo, n = t * W, min(W, k - t * W)
        # the diagonal words of the word's lanes; past K the kernel reads stale registers
        diag = [int(v) for v in mask[lo: lo + n, t]] + [int(v) for v in rng.integers(
            0, 2**63, W - n, dtype=np.uint64)]
        cand = sum(1 << jj for jj in range(n) if valid[lo + jj]) & ~removed[t]
        kept = cand
        while cand:  # passes until no kept candidate kills a kept one
            rounds += 1
            killed = 0
            for jj in range(W):
                if kept >> jj & 1:
                    killed |= diag[jj]
            if cand & ~killed & ALL == kept:
                break
            kept = cand & ~killed & ALL
        rows = [lo + jj for jj in range(W) if kept >> jj & 1]
        keep[rows] = True
        if rows and t + 1 < nw:
            for w, v in enumerate(np.bitwise_or.reduce(mask[rows, t + 1:], axis=0), t + 1):
                removed[w] |= int(v)
    return keep, rounds


def _case(kind, k, seed):
    """(boxes (K, 4) fp32 xyxy, scores (K,) fp32, conf, iou) of one case."""
    r = np.random.default_rng(seed)
    if kind == "cluster":  # every pair overlaps far above iou: one kept
        c = 100 + r.uniform(-0.5, 0.5, (k, 2))
        wh = 50 + r.uniform(-0.5, 0.5, (k, 2))
    elif kind == "chain":  # each box kills the next one alone: every other one kept
        c = np.stack([np.arange(k) * 7.0, np.zeros(k)], -1) + 15
        wh = np.full((k, 2), 30.0)
    elif kind == "disjoint":  # a grid of boxes that touch no other: all valid ones kept
        idx = np.arange(k)
        c = np.stack([idx % 64 * 10.0, idx // 64 * 10.0], -1) + 5
        wh = np.full((k, 2), 8.0)
    else:
        c = r.uniform(0, 300, (k, 2))
        wh = r.uniform(4, 80, (k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    s = r.random(k)
    conf = 0.1
    if kind == "ties":
        s = np.round(s * 8) / 8
    elif kind == "chain":
        s = np.linspace(1.0, 0.2, k)
    elif kind == "none":  # at or under conf, some exactly at it
        conf = 0.5
        s = np.where(r.random(k) < 0.3, 0.5, s * 0.5)
    elif kind == "chain":  # the longest chain: a pass for each candidate of a word
        assert got[::2].all() and not got[1::2].any()
        assert rounds == k
    elif kind == "unsorted":  # valid and invalid candidates interleaved, out of order
        conf = 0.5
    if kind != "unsorted":
        s = np.sort(s)[::-1]
    return boxes, s.astype(np.float32).copy(), conf, 0.5


CASES = [("ties", k) for k in (1, 63, 64, 65, 1000, 2048, 4100)]
CASES += [(kind, k) for kind in ("cluster", "disjoint", "none", "unsorted") for k in (63, 65, 2048)]
CASES += [("unsorted", 4100)] + [("chain", k) for k in (63, 65, 2048)]


@pytest.mark.parametrize("kind,k", CASES)
def test_word_walk_matches_plain_and_jax(kind, k):
    boxes, scores, conf, iou = _case(kind, k, seed=k)
    rng = np.random.default_rng(k + 1)
    valid = scores > conf
    mask, written = _mask_model(_iou_over(boxes, iou), valid, rng)
    got, rounds = _walk_model(mask, valid, rng)
    nwords = -(-k // W)
    assert written == int((nwords - np.arange(k) // W)[valid].sum())  # a word a tile of the row
    want = suppress_plain(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None], iou,
                          conf)[0].numpy()
    np.testing.assert_array_equal(got, want)
    jax_keep = np.asarray(_suppress(jnp.asarray(boxes), jnp.asarray(scores), iou, conf))
    np.testing.assert_array_equal(got, jax_keep)
    if kind == "cluster":  # one pass keeps the first, the next holds
        assert got.sum() == 1 and rounds == 2
    elif kind == "disjoint":
        words_with_valid = len(np.unique(np.nonzero(valid)[0] // W))
        assert np.array_equal(got, valid) and rounds == words_with_valid
    elif kind == "none":
        assert not got.any() and rounds == 0
    elif kind == "chain":  # the longest chain: a pass for each candidate of a word
        assert got[::2].all() and not got[1::2].any()
        assert rounds == k
    elif kind == "unsorted":
        assert 0 < got.sum() <= valid.sum() and not got[~valid].any()


@pytest.mark.parametrize("k", [65, 1000, 2048])
def test_word_walk_matches_rotated_plain(k):
    """K5's walk is K4's over a probiou matrix: the model on the plain
    version's own probiou > iou equals ``suppress_rotated_plain``."""
    r = np.random.default_rng(k)
    xy = r.uniform(0, 300, (k, 2))
    wh = r.uniform(8, 80, (k, 2))
    ang = r.uniform(-np.pi / 4, 3 * np.pi / 4, (k, 1))
    rb = torch.from_numpy(np.concatenate([xy, wh, ang], -1).astype(np.float32))[None]
    scores = torch.from_numpy(r.random((1, k)).astype(np.float32))
    over = (probiou(rb[:, :, None], rb[:, None, :]) > 0.5)[0].numpy()
    valid = scores[0].numpy() > 0.3
    mask, _ = _mask_model(over, valid, r)
    got, _ = _walk_model(mask, valid, r)
    want = suppress_rotated_plain(rb, scores, 0.5, 0.3)[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()


@pytest.mark.parametrize("b,k,nwords,tiles,blocks,smem", [
    (1, 1, 1, 1, 1, 152),
    (1, 2048, 32, 528, 132, 400),              # a tracked frame at 640: one image
    (1, 84, 2, 3, 1, 160),                     # a tracked frame at 64
    (32, 2048, 32, 528, 132 * 32, 400),        # a flagship serving batch
    (16, 2048, 32, 528, 132 * 16, 400),        # an OBB batch
    (2, 4096, 64, 2080, 520 * 2, 656),         # max_nms 4096
    (3, 4100, 65, 2145, 537 * 3, 664),         # a ragged last word past 64 words
])
def test_nms_launch(b, k, nwords, tiles, blocks, smem):
    got = nms_launch(b, k)
    assert got == {"nwords": nwords, "tiles": tiles, "mask_blocks": blocks, "mask_threads": 256,
                   "walk_blocks": b, "walk_threads": 512, "walk_smem": smem}


def test_nms_launch_raises_naming_the_bound():
    k_max = W * ((NMS_SMEM_DEFAULT - 144) // 8)
    assert nms_launch(1, k_max)["walk_smem"] <= NMS_SMEM_DEFAULT
    with pytest.raises(ValueError, match="shared memory"):
        nms_launch(1, k_max + 1)
    with pytest.raises(ValueError, match="grid"):
        nms_launch(65536, 64)
    with pytest.raises(ValueError, match="at least 1"):
        nms_launch(0, 64)


def test_launch_raises_before_the_build():
    """An unlaunchable K raises in the wrapper before anything is built or
    allocated beyond the keep mask."""
    k = W * ((NMS_SMEM_DEFAULT - 144) // 8) + 1
    with pytest.raises(ValueError, match="shared memory"):
        _launch("nms_suppress", torch.zeros(1, k, 4), torch.zeros(1, k), 0.5, 0.1)


@pytest.mark.parametrize("nwords", [1, 2, 7, 32, 65])
def test_nms_tile_numbers_the_upper_triangle_once(nwords):
    tiles = [nms_tile(i, nwords) for i in range(nwords * (nwords + 1) // 2)]
    assert sorted(tiles) == [(rb, cb) for rb in range(nwords) for cb in range(rb, nwords)]


def test_profile_nms_raises_when_cuda_is_absent(monkeypatch):
    from yolo_ad_refine_tpu_torch.engine import profile_nms

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        profile_nms.main([])


def test_predict_candidates_on_the_cpu():
    """``profile_nms.predict_candidates``: the suppression's input of one
    predict batch, as ``non_max_suppression`` selects it, at each conf."""
    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.engine.profile_nms import predict_candidates

    model = YOLO("yolo11n.yaml", device="cpu", imgsz=64, seed=0)
    imgs = [np.random.default_rng(i).integers(0, 256, (48, 80, 3), dtype=np.uint8)
            for i in range(2)]
    got = predict_candidates(model, imgs, 64, (0.0, 2.0))
    for conf, (boxes, scores) in got.items():
        assert boxes.shape == (2, 84, 4) and scores.shape == (2, 84) and boxes.is_contiguous()
    assert (got[0.0][1] > 0).all() and (got[2.0][1] == -1).all()
