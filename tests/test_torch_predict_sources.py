"""The predictor's sources and save outputs, JAX package against the port.

- ``data/loaders.py`` (``LoadImagesAndVideos``, ``load_inference_source``)
  against the JAX module on a directory of seeded JPEGs and an MJPG video,
  at ``vid_stride`` 1 and 3: the same paths, frames and metadata.
- ``Results.save_txt`` / ``save_crop`` / ``save`` against the JAX
  ``Results`` on the same boxes (and rotated boxes): label rows within 1e-6,
  the same crop files with the same pixels, the same drawing.
- ``YOLO(...).predict(source=<dir>, save_txt, save_conf, save_crop)`` on
  the CPU against the JAX ``DetectionPredictor`` with the same numpy-seeded
  weights (``load_jax_variables``): the same files, label rows within 1e-4
  (the two frameworks sum the convolutions in other orders; the images are
  at imgsz, so both letterboxes copy them unchanged).
- The port's own surface: a video's frames saved one file a frame, a mixed
  list of sources, ``vid_stride`` passed to the loader, a stream read to
  its end, and ``LoadImagesNative`` raising.

Everything is written under pytest's tmp_path.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest

from test_torch_weights import randomize
from yolo_ad_refine_tpu.data import loaders as jax_loaders
from yolo_ad_refine_tpu.engine.results import Results as JaxResults
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.data import loaders
from yolo_ad_refine_tpu_torch.engine.predictor import iter_sources, load_sources
from yolo_ad_refine_tpu_torch.engine.results import Results
from yolo_ad_refine_tpu_torch.utils import yaml_save
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

TINY = {  # tests/test_save_outputs.py's model: five convs and Detect
    "nc": 2,
    "backbone": [[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                 [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                 [-1, 1, "Conv", [16, 3, 2]]],
    "head": [[[2, 3, 4], 1, "Detect", ["nc"]]],
}
NAMES = {0: "cat", 1: "dog"}


def _write_video(path: Path, n: int, h: int, w: int, seed: int) -> list:
    """An MJPG .avi of n seeded frames; returns the frames as read back."""
    r = np.random.default_rng(seed)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 24, (w, h))
    for i in range(n):
        vw.write(cv2.GaussianBlur(r.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 0))
    vw.release()
    cap, frames = cv2.VideoCapture(str(path)), []
    while (got := cap.read())[0]:
        frames.append(got[1])
    cap.release()
    return frames


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """A directory of 5 seeded JPEGs (two sizes, one in a subdirectory) and
    a 24-frame MJPG video beside it."""
    root = tmp_path_factory.mktemp("media")
    r = np.random.default_rng(0)
    imgs = root / "imgs"
    (imgs / "sub").mkdir(parents=True)
    for i, (h, w) in enumerate([(64, 64), (64, 64), (48, 80), (64, 64), (64, 64)]):
        f = imgs / ("sub" if i == 2 else "") / f"im{i}.jpg"
        cv2.imwrite(str(f), cv2.GaussianBlur(r.integers(0, 256, (h, w, 3), dtype=np.uint8),
                                             (7, 7), 0))
    video = root / "clip.avi"
    frames = _write_video(video, 24, 72, 96, seed=1)
    return {"imgs": imgs, "video": video, "frames": frames}


def _same_items(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (gp, gf, gm), (wp, wf, wm) in zip(got, want):
        assert gp == wp and gm == wm
        np.testing.assert_array_equal(gf, wf)


@pytest.mark.parametrize("vid_stride", [1, 3])
@pytest.mark.parametrize("which", ["imgs", "video", "root"])
def test_loaders_match_jax(media, which, vid_stride):
    src = media["video"].parent if which == "root" else media[which]
    _same_items(loaders.LoadImagesAndVideos(src, vid_stride),
                jax_loaders.LoadImagesAndVideos(src, vid_stride))
    _same_items(loaders.load_inference_source(str(src), vid_stride),
                jax_loaders.load_inference_source(str(src), vid_stride))
    if which == "video":
        got = list(loaders.LoadImagesAndVideos(src, vid_stride))
        assert len(got) == 24 // vid_stride
        assert [m["frame"] for _, _, m in got] == list(range(vid_stride, 25, vid_stride))
        np.testing.assert_array_equal(got[-1][1], media["frames"][23])


def test_load_sources_matches_jax(media):
    from yolo_ad_refine_tpu.engine.predictor import load_sources as jax_load_sources

    arr = np.zeros((10, 12, 3), np.uint8)
    for src in (str(media["imgs"]), str(media["video"]), arr, [arr, str(media["imgs"]), arr]):
        got, want = load_sources(src), jax_load_sources(src)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
    names = [n for n, _ in load_sources(str(media["video"]))]
    assert names[:2] == [f"{media['video']}#1", f"{media['video']}#2"]


def _results(kind):
    r = np.random.default_rng(3)
    img = r.integers(0, 256, (80, 100, 3), dtype=np.uint8)
    boxes = np.asarray([[10.3, 10.7, 40.1, 50.9, 0.9, 0], [50, 20, 99.5, 79.8, 0.7, 1],
                        [0, 0, 4, 3, 0.4, 1]], np.float32)
    kw = {}
    if kind == "obb":
        kw["obb"] = np.asarray([[30, 30, 20, 10, 0.3, 0.8, 1], [60, 50, 30, 12, -0.6, 0.5, 0]],
                               np.float32)
        boxes = boxes[:2]
    return img, boxes, kw


def _rows(path: Path) -> np.ndarray:
    return np.asarray([[float(v) for v in ln.split()] for ln in path.read_text().splitlines()])


@pytest.mark.parametrize("kind", ["boxes", "obb"])
@pytest.mark.parametrize("save_conf", [False, True])
def test_results_save_surface_matches_jax(tmp_path, kind, save_conf):
    img, boxes, kw = _results(kind)
    ours = Results(img, "a.jpg", NAMES, boxes, **kw)
    ref = JaxResults(img, "a.jpg", NAMES, boxes, **kw)
    got = _rows(ours.save_txt(tmp_path / "ours" / "a.txt", save_conf=save_conf))
    want = _rows(ref.save_txt(tmp_path / "ref" / "a.txt", save_conf=save_conf))
    assert got.shape == want.shape == (len(boxes if kind == "boxes" else kw["obb"]),
                                       (5 if kind == "boxes" else 9) + save_conf)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    ours.save_crop(tmp_path / "ours" / "crops", "a.jpg")
    ref.save_crop(tmp_path / "ref" / "crops", "a.jpg")
    files = sorted(p.relative_to(tmp_path / "ours")
                   for p in (tmp_path / "ours" / "crops").rglob("*.jpg"))
    assert files == sorted(p.relative_to(tmp_path / "ref")
                           for p in (tmp_path / "ref" / "crops").rglob("*.jpg"))
    assert len(files) == len(boxes)
    for f in files:
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "ours" / f)),
                                      cv2.imread(str(tmp_path / "ref" / f)))
    np.testing.assert_array_equal(ours.plot(), ref.plot())
    ours.save(tmp_path / "ours" / "a.jpg")
    ref.save(tmp_path / "ref" / "a.jpg")
    assert (tmp_path / "ours" / "a.jpg").read_bytes() == (tmp_path / "ref" / "a.jpg").read_bytes()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(JAX model, seeded variables, port YOLO on the CPU with them)."""
    from yolo_ad_refine_tpu.models.model import build_detection_model

    jm = build_detection_model(TINY, imgsz=64)
    variables = randomize(jm.variables, seed=4)
    cfg = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    yaml_save(cfg, TINY)
    port = YOLO(str(cfg), device="cpu", imgsz=64)
    load_jax_variables(port.model, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    port.model.names = NAMES
    return jm, variables, port


def _outputs(run_dir: Path) -> list:
    return sorted(str(p.relative_to(run_dir)) for p in run_dir.rglob("*") if p.is_file())


def test_predict_save_outputs_match_jax(tiny, media, tmp_path):
    from yolo_ad_refine_tpu.engine.predictor import DetectionPredictor as JaxPredictor

    jm, variables, port = tiny
    src = tmp_path / "sq"  # the images at imgsz: both letterboxes copy them unchanged
    src.mkdir()
    for f in sorted(media["imgs"].glob("*.jpg")):
        (src / f.name).write_bytes(f.read_bytes())
    opts = dict(imgsz=64, conf=0.01, max_det=5, batch=3, save_txt=True, save_conf=True,
                save_crop=True)
    got = port.predict(source=str(src), project=str(tmp_path / "ours"), **opts)
    want = JaxPredictor(overrides={**opts, "variables": variables, "project":
                                   str(tmp_path / "ref")})(source=str(src), model=jm,
                                                                 names=NAMES)
    ours, ref = tmp_path / "ours" / "predict", tmp_path / "ref" / "predict"
    assert len(got) == len(want) == 4
    assert [r.path for r in got] == [r.path for r in want]
    assert _outputs(ours) == _outputs(ref)
    labels = sorted((ours / "labels").glob("*.txt"))
    assert [f.stem for f in labels] == sorted(f"im{i}" for i in (0, 1, 3, 4))
    for f, r in zip(labels, got):
        rows = _rows(f)
        assert len(rows) == len(r) > 0
        np.testing.assert_allclose(rows, _rows(ref / "labels" / f.name), atol=1e-4, rtol=0)
        np.testing.assert_allclose(rows[:, 1:5], r.boxes.xywhn, atol=1e-5)
    assert any((ours / "crops").rglob("*.jpg"))


def test_predict_video_and_mixed_sources(tiny, media, tmp_path):
    """A video's frames each get their own label file ``<stem>_<frame>``
    and annotated image; ``vid_stride`` reaches the loader; a list mixes
    numpy images, a directory and a video."""
    port = tiny[2]
    opts = dict(imgsz=64, conf=0.01, max_det=5, batch=4, save=True, save_txt=True)
    res = port.predict(source=str(media["video"]), project=str(tmp_path / "v"), **opts)
    run = tmp_path / "v" / "predict"
    assert [r.path for r in res] == [f"{media['video']}#{i}" for i in range(1, 25)]
    assert sorted(p.name for p in (run / "labels").glob("*.txt")) == sorted(
        f"clip_{i}.txt" for i in range(1, 25))
    assert len(list(run.glob("clip_*.jpg"))) == 24
    for i in (1, 24):
        np.testing.assert_allclose(_rows(run / "labels" / f"clip_{i}.txt")[:, 1:5],
                                   res[i - 1].boxes.xywhn, atol=1e-5)
    res3 = port.predict(source=str(media["video"]), vid_stride=3, **{**opts, "save": False,
                                                                      "save_txt": False})
    assert [r.path.rsplit("#", 1)[1] for r in res3] == [str(i) for i in range(3, 25, 3)]
    for a, b in zip(res3, res[2::3]):
        np.testing.assert_array_equal(a.boxes.data, b.boxes.data)
    arr = media["frames"][0]
    mixed = port.predict(source=[arr, str(media["imgs"]), str(media["video"])], vid_stride=3,
                         imgsz=64, conf=0.01, max_det=5, batch=4)
    assert len(mixed) == 1 + 5 + 8 and mixed[0].path == "image0.jpg"
    np.testing.assert_array_equal(mixed[0].boxes.data, res[0].boxes.data)


def test_stream_is_read_to_its_end(media):
    """``LoadStreams`` on a source that ends (a file opened as a stream):
    each kept frame is yielded once, and the iteration ends with it."""
    stream = loaders.LoadStreams(str(media["video"]), vid_stride=3)
    got = list(stream)
    assert 1 <= len(got) <= 8 and not stream.running
    assert [m["frame"] for _, _, m in got] == sorted({m["frame"] for _, _, m in got})
    assert all(f.shape == (72, 96, 3) for _, f, _ in got)


def test_stream_sources_dispatch(monkeypatch):
    opened = []
    monkeypatch.setattr(loaders, "LoadStreams", lambda s, v: opened.append((s, v)) or iter(()))
    for s in ("0", "rtsp://cam/1", "http://cam/2.mjpg"):
        assert list(iter_sources(s, 2)) == []
    assert opened == [("0", 2), ("rtsp://cam/1", 2), ("http://cam/2.mjpg", 2)]


def test_native_loader_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 15"):
        loaders.LoadImagesNative("x", 64)


def test_predict_without_save_writes_nothing(tiny, media, tmp_path):
    tiny[2].predict(source=str(media["imgs"]), project=str(tmp_path / "none"), imgsz=64)
    assert not (tmp_path / "none").exists()
