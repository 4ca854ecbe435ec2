"""The training and validation options of a user's yaml in the PyTorch
port, against the JAX package (which is the oracle):

- ``multi_scale_batch``: the same drawn size, images (bit for bit) and
  boxes as the JAX function under the same generator, the passthrough
  size included;
- the image cache (``cache=ram`` / ``disk``, True -> ram): cached samples
  bit-equal to the JAX ones and to the uncached ones, a caller's change to
  a returned image does not reach the cache, and the disk sidecar's name
  holds imgsz;
- rect validation: ``set_rectangle`` gives the JAX shapes and plan integer
  for integer, the loader's rect batches are the JAX batches bit for bit,
  and a whole rect validation with ``save_json`` on a small detector
  (seeded weights, labels from its own detections so mAP is not 0) gives
  mAP50 / mAP50-95 within the val slice's 1e-3 of JAX's and the same
  predictions.json entries, matched by image and rank, within 1e-3 px
  and 1e-4 in score;
- autobatch: the pick equals the JAX package's loop for the same peaks
  (hypothesis over base, slope, fraction and limit), and ``batch=-1``
  raises on the CPU, where there is no card memory to measure.
"""

import json
from collections import defaultdict
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_weights import randomize
from yolo_ad_refine_tpu.data.build import DataLoader as JaxDataLoader
from yolo_ad_refine_tpu.data.dataset import YOLODataset as JaxDataset
from yolo_ad_refine_tpu.engine.validator import DetectionValidator as JaxValidator
from yolo_ad_refine_tpu.models.model import DetectionModel as JaxDetectionModel
from yolo_ad_refine_tpu.train.trainer import multi_scale_batch as jax_multi_scale_batch
from yolo_ad_refine_tpu.utils import autobatch as jax_autobatch
from yolo_ad_refine_tpu_torch.data.build import DataLoader
from yolo_ad_refine_tpu_torch.data.dataset import YOLODataset
from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
from yolo_ad_refine_tpu_torch.engine.predictor import DetectionPredictor
from yolo_ad_refine_tpu_torch.engine.validator import DetectionValidator
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.train.trainer import DetectionTrainer, multi_scale_batch
from yolo_ad_refine_tpu_torch.utils.autobatch import autobatch, fit_peaks, pick_batch
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

MAP_TOL, BOX_TOL, SCORE_TOL = 1e-3, 1e-3, 1e-4


# -- multi_scale -------------------------------------------------------------

@pytest.mark.parametrize("imgsz,seed", [(128, 3), (128, 11), (320, 0), (64, 5)])
def test_multi_scale_batch_matches_jax(imgsz, seed):
    """imgsz 64 draws only 64: the batch passes unchanged on both sides."""
    r = np.random.default_rng(seed + 100)
    xy = r.uniform(0, imgsz / 2, (3, 6, 2))
    boxes = np.concatenate([xy, xy + r.uniform(2, imgsz / 2, (3, 6, 2))], -1)
    batch = {"img": r.integers(0, 256, (3, imgsz, imgsz, 3), dtype=np.uint8),
             "bboxes": np.concatenate([boxes, r.uniform(0, 1.5, (3, 6, 1))], -1).astype(
                 np.float32),
             "cls": r.integers(0, 3, (3, 6, 1)).astype(np.float32),
             "mask": np.ones((3, 6, 1), np.float32)}
    ours, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
    sizes = set()
    for _ in range(8):
        got, want = multi_scale_batch(batch, imgsz, ours), jax_multi_scale_batch(batch, imgsz,
                                                                                theirs)
        assert got["img"].shape == want["img"].shape
        sizes.add(got["img"].shape[1])
        np.testing.assert_array_equal(got["img"], want["img"])
        np.testing.assert_array_equal(got["bboxes"], want["bboxes"])
        np.testing.assert_array_equal(got["bboxes"][..., 4], batch["bboxes"][..., 4])
        if got["img"].shape[1] == imgsz:
            assert got is batch and want is batch
    assert (len(sizes) > 1) == (imgsz > 64)
    assert all(s % 64 == 0 and imgsz // 2 // 64 * 64 <= s <= imgsz * 3 // 2 for s in sizes)


# -- image cache -------------------------------------------------------------

@pytest.fixture(scope="module")
def shapes(tmp_path_factory):
    root = tmp_path_factory.mktemp("cache") / "ds"
    make_shapes_dataset(root, n_train=6, n_val=2, imgsz=96, seed=3, aspect_range=(0.6, 1.5))
    return root


HYP = {"mosaic": 1.0, "mixup": 0.3, "degrees": 5.0, "translate": 0.1, "scale": 0.5,
       "fliplr": 0.5, "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4}


@pytest.mark.parametrize("cache", ["ram", "disk", True])
@pytest.mark.parametrize("augment", [True, False])
def test_cached_samples_equal_jax_and_uncached(shapes, cache, augment, tmp_path):
    # private copies, one a side: disk sidecars are written beside the images
    for side in ("port", "jax"):
        for d in ("images", "labels"):
            (tmp_path / side / d).mkdir(parents=True)
            for f in (shapes / "train" / d).iterdir():
                (tmp_path / side / d / f.name).write_bytes(f.read_bytes())
    images = tmp_path / "port" / "images"
    kw = dict(imgsz=96, augment=augment, hyp=HYP, nc=3, max_boxes=16)
    cached = YOLODataset(images, cache_images=cache, **kw)
    plain = YOLODataset(shapes / "train" / "images", **kw)
    theirs = JaxDataset(tmp_path / "jax" / "images", cache_images=cache, **kw)
    for rounds in range(2):  # the first fills the cache, the second reads it
        for i in range(len(cached)):
            seed = 1000 * rounds + i
            got = cached.get_sample(i, np.random.default_rng(seed))
            want = theirs.get_sample(i, np.random.default_rng(seed))
            base = plain.get_sample(i, np.random.default_rng(seed))
            for s in (want, base):
                np.testing.assert_array_equal(got["img"], s["img"])
                np.testing.assert_array_equal(got["bboxes"], s["bboxes"])
    sidecars = sorted(p.name for p in images.glob("*.npz"))
    if cache == "disk":
        assert sidecars == sorted(p.with_suffix(".yat96.npz").name for p in images.glob("*.jpg"))
        assert sidecars == sorted(p.name for p in (tmp_path / "jax" / "images").glob("*.yat96.npz"))
    else:
        assert all(x is not None for x in cached._ram) and not sidecars


def test_cache_is_safe_from_callers_and_keyed_by_imgsz(shapes, tmp_path):
    src = shapes / "val" / "images"
    for f in src.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    ram = YOLODataset(tmp_path, imgsz=64, cache_images="ram")
    a, shape0 = ram.load_image(0)
    a[:] = 0  # a caller's change must not reach the cache
    b, _ = ram.load_image(0)
    assert b.any() and shape0 == cv2.imread(ram.im_files[0]).shape[:2]
    disk = YOLODataset(tmp_path, imgsz=64, cache_images="disk")
    c, _ = disk.load_image(1)
    c[:] = 0
    assert disk.load_image(1)[0].any() and len(list(tmp_path.glob("*.yat64.npz"))) == 1
    wider = YOLODataset(tmp_path, imgsz=96, cache_images="disk")
    assert max(wider.load_image(1)[0].shape[:2]) == 96  # not the 64 px sidecar
    with pytest.raises(ValueError, match="cache="):
        YOLODataset(tmp_path, imgsz=64, cache_images="gpu")


# -- rect validation ---------------------------------------------------------

@pytest.fixture(scope="module")
def rect_set(tmp_path_factory):
    root = tmp_path_factory.mktemp("rect")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    r = np.random.default_rng(3)
    hw = [(100, 400), (120, 300), (160, 240), (200, 200), (240, 160), (300, 120), (400, 100),
          (320, 320), (90, 160), (210, 190), (64, 320)]
    for i, (h, w) in enumerate(hw):
        img = r.integers(0, 255, (h, w, 3), dtype=np.uint8)
        cv2.rectangle(img, (w // 4, h // 4), (3 * w // 4, 3 * h // 4), (255, 0, 0), -1)
        cv2.imwrite(str(root / "images" / f"{i}.jpg"), img)
        (root / "labels" / f"{i}.txt").write_text("0 0.5 0.5 0.5 0.5\n1 0.3 0.6 0.2 0.3\n")
    return root


@pytest.mark.parametrize("imgsz,batch,nbuckets", [(320, 4, 3), (320, 2, 4), (256, 5, 1),
                                                  (128, 3, 11), (640, 4, 20)])
def test_set_rectangle_shapes_and_plan_equal_jax(rect_set, imgsz, batch, nbuckets):
    ours = YOLODataset(rect_set / "images", imgsz=imgsz)
    theirs = JaxDataset(rect_set / "images", imgsz=imgsz)
    plan, want = ours.set_rectangle(batch, nbuckets), theirs.set_rectangle(batch, nbuckets)
    np.testing.assert_array_equal(ours.rect_shapes, theirs.rect_shapes)
    assert ours.rect_shapes.dtype == theirs.rect_shapes.dtype
    assert [p.tolist() for p in plan] == [p.tolist() for p in want]


def test_rect_batches_equal_jax(rect_set):
    ours = YOLODataset(rect_set / "images", imgsz=320, max_boxes=8)
    theirs = JaxDataset(rect_set / "images", imgsz=320, max_boxes=8)
    got = list(DataLoader(ours, batch_size=4, shuffle=False,
                          batch_plan=ours.set_rectangle(4, 3)))
    want = list(JaxDataLoader(theirs, batch_size=4, shuffle=False,
                              batch_plan=theirs.set_rectangle(4, 3)))
    assert len(got) == len(want) == 3 and len({b["img"].shape for b in got}) == 3
    for g, w in zip(got, want):
        assert g["im_file"] == w["im_file"]
        for k in ("img", "bboxes", "cls", "mask"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["ratio_pad"] == w["ratio_pad"] and g["ori_shape"] == w["ori_shape"]


TINY = {"nc": 3,
        "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                     [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [64, 3, 2]],
                     [-1, 1, "Conv", [64, 3, 2]]],
        "head": [[[2, 3, 4], 1, "Detect", ["nc"]]]}


@pytest.fixture(scope="module")
def rect_val(tmp_path_factory):
    """Rect validation with save_json of one seeded small detector on both
    sides. The labels are the port's own top detections at imgsz 128, so
    the matching is not vacuous."""
    tmp = tmp_path_factory.mktemp("rect_val")
    data = make_shapes_dataset(tmp / "ds", n_train=1, n_val=10, imgsz=128, seed=8,
                               aspect_range=(0.45, 2.2))
    jm = JaxDetectionModel(TINY)
    jm.init(jax.random.PRNGKey(0), imgsz=64)
    variables = randomize(jm.variables, seed=12)
    jm.variables = jax.tree.map(jnp.asarray, variables)
    port = DetectionModel(TINY)
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    port.probe_strides(128)
    port.eval()
    val = tmp / "ds" / "val" / "images"
    files = sorted(val.glob("*.jpg"))
    imgs = [cv2.imread(str(f)) for f in files]
    results = DetectionPredictor({"imgsz": 128, "conf": 0.0, "batch": 5})(imgs, model=port)
    for f, im, r in zip(files, imgs, results):
        h, w = im.shape[:2]
        lines = [f"{int(c)} {(x1 + x2) / 2 / w:.6f} {(y1 + y2) / 2 / h:.6f} "
                 f"{(x2 - x1) / w:.6f} {(y2 - y1) / h:.6f}"
                 for x1, y1, x2, y2, _, c in r.boxes.data[:3]]
        (val.parent / "labels" / f"{f.stem}.txt").write_text("\n".join(lines) + "\n")
    args = {"imgsz": 128, "batch": 3, "conf": 0.001, "iou": 0.7, "max_det": 300,
            "max_boxes": 16, "data": data, "rect": True, "rect_buckets": 3, "save_json": True}
    want = JaxValidator(args={**args, "save_dir": str(tmp / "jax")})(model=jm)
    validator = DetectionValidator(args={**args, "save_dir": str(tmp / "port")})
    got = validator(model=port)
    square = DetectionValidator(args={**args, "rect": False, "save_dir": str(tmp / "square")})(
        model=port)
    return {"got": got, "want": want, "square": square, "tmp": tmp}


def test_rect_val_metrics_match_jax(rect_val):
    got, want = rect_val["got"], rect_val["want"]
    assert want["metrics/mAP50(B)"] > 0.2  # the labels are findable: the check is not vacuous
    for k in ("metrics/mAP50(B)", "metrics/mAP50-95(B)", "metrics/precision(B)",
              "metrics/recall(B)", "fitness"):
        assert abs(got[k] - want[k]) <= MAP_TOL, (k, got[k], want[k])
    # the buckets letterbox to other shapes than the square: other predictions
    rect, square = (json.loads((rect_val["tmp"] / d / "predictions.json").read_text())
                    for d in ("port", "square"))
    assert rect != square


def test_predictions_json_matches_jax(rect_val):
    def by_image(path):
        out = defaultdict(list)
        for e in json.loads(Path(path).read_text()):
            out[e["image_id"]].append(e)
        return out

    got = by_image(rect_val["tmp"] / "port" / "predictions.json")
    want = by_image(rect_val["tmp"] / "jax" / "predictions.json")
    assert sorted(got) == sorted(want) and len(want) == 10
    assert all(isinstance(k, int) for k in got)  # numeric stems become ints
    n = 0
    for image_id, es in want.items():
        gs = got[image_id]
        assert len(gs) == len(es), image_id
        for g, w in zip(gs, es):  # by rank
            assert set(g) == {"image_id", "category_id", "bbox", "score"}
            assert g["category_id"] == w["category_id"]
            np.testing.assert_allclose(g["bbox"], w["bbox"], atol=BOX_TOL)
            assert abs(g["score"] - w["score"]) <= SCORE_TOL
            n += 1
    assert n > 100


# -- autobatch ---------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(base=st.integers(0, 2 ** 36), slope=st.integers(1, 2 ** 32),
       fraction=st.floats(0.05, 0.95), limit=st.integers(2 ** 28, 2 ** 37),
       max_batch=st.sampled_from([1, 16, 1024]))
def test_autobatch_pick_equals_the_jax_loop(base, slope, fraction, limit, max_batch):
    """The JAX loop (its utils/autobatch.py autobatch) on peaks base + slope
    at batch 1 and base + 2 slope, its limit patched to ``limit``."""
    peaks = {1: base + slope, 2: base + 2 * slope}
    orig = jax_autobatch._program_peak_bytes, jax_autobatch.device_memory_limit
    jax_autobatch._program_peak_bytes = lambda fn, args: peaks[fn]
    jax_autobatch.device_memory_limit = lambda device=None: limit
    try:
        want = jax_autobatch.autobatch(lambda b: (b, ()), fraction=fraction, max_batch=max_batch)
    finally:
        jax_autobatch._program_peak_bytes, jax_autobatch.device_memory_limit = orig
    b0, s0 = fit_peaks(1, peaks[1], 2, peaks[2])
    assert (b0, s0) == (base, slope)
    assert pick_batch(b0, s0, limit, fraction, max_batch) == want


def test_fit_peaks_from_other_probes():
    base, slope = fit_peaks(8, 3e9 + 8 * 2.5e8, 16, 3e9 + 16 * 2.5e8)
    assert (base, slope) == (3e9, 2.5e8)
    assert pick_batch(base, slope, 80e9, 0.6) == 128  # 3 + 0.25 b <= 48 GB
    assert fit_peaks(8, 5e9, 16, 4e9) == (5e9 - 8, 1)  # a falling peak: the JAX floors


def test_batch_minus_one_raises_on_the_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="measures the card's memory"):
        DetectionTrainer({"data": "x.yaml", "batch": -1, "device": "cpu",
                          "project": str(tmp_path)})
    with pytest.raises(RuntimeError, match="measures the card's memory"):
        autobatch(lambda b: None, "cpu")
