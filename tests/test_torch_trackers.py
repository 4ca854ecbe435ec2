"""The PyTorch port's trackers and ``YOLO.track`` against the JAX package,
on the CPU; the model for the cases is ``tests/test_trackers.py``.

- ``KalmanFilterXYAH``, ``BYTETracker`` and ``BOTSORT`` (with its GMC) fed
  the same detection sequences (and frames) give the JAX trackers' rows
  exactly: the same numpy, scipy and cv2 code on the same inputs. BOT-SORT's
  RANSAC draws from cv2's global generator, seeded (``cv2.setRNGSeed``)
  before each side. The cases of ``tests/test_trackers.py`` (stable
  identity, two objects, occlusion, the low-confidence BYTE step, camera
  motion) and a seeded crowd of drifting, flickering objects.
- ``YOLO.track`` / ``engine/track.py track`` on a synthetic MJPG video
  equals the JAX ``engine/track.py track`` on the same weights, for both
  trackers and for the detect, segment, pose and YOLO-World (after
  ``set_classes``) heads: the same frames, ids and classes, boxes within
  1e-3 px and scores within 1e-5. The weights are numpy-randomised with
  the box branch made local (``localise``), so that the detections differ.
- Results with 7-column track rows plot, and write JSON and txt, as the
  JAX Results do.
- The heads the JAX tracker misreads raise, naming their hazard.
"""

import json
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import jax_shapes, randomize
from yolo_ad_refine_tpu.engine.results import Results as JaxResults
from yolo_ad_refine_tpu.engine.track import track as jax_track
from yolo_ad_refine_tpu.trackers import TRACKER_MAP as JAX_TRACKERS
from yolo_ad_refine_tpu.trackers.byte_tracker import STrack as JaxSTrack
from yolo_ad_refine_tpu.trackers.kalman import KalmanFilterXYAH as JaxKalman
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.engine.results import Results
from yolo_ad_refine_tpu_torch.engine.track import track
from yolo_ad_refine_tpu_torch.models.model import DetectionModel
from yolo_ad_refine_tpu_torch.trackers import TRACKER_MAP, STrack
from yolo_ad_refine_tpu_torch.trackers.gmc import GMC
from yolo_ad_refine_tpu_torch.trackers.kalman import KalmanFilterXYAH
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

IMGSZ = 64
BACKBONE = [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
            [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [128, 3, 2]],
            [-1, 1, "Conv", [256, 3, 2]]]
HEADS = {  # tests/test_trackers.py's tiny backbone under each head
    "detect": {"nc": 3, "head": [[[2, 3, 4], 1, "Detect", ["nc"]]]},
    "segment": {"nc": 2, "head": [[[2, 3, 4], 1, "Segment", ["nc", 8, 32]]]},
    "pose": {"nc": 1, "head": [[[2, 3, 4], 1, "Pose", ["nc", [17, 3]]]]},
    "world": {"nc": 3, "head": [[[2, 3, 4], 1, "WorldDetect", ["nc", 24, True]]]},
}
LOW = {"new_track_thresh": 0.0, "track_high_thresh": 1e-6, "track_low_thresh": 1e-7}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_kalman_matches_jax():
    rng = np.random.default_rng(0)
    ours, ref = KalmanFilterXYAH(), JaxKalman()
    meas = np.array([10.0, 20.0, 0.5, 8.0])
    m, c = ours.initiate(meas)
    jm, jc = ref.initiate(meas)
    for _ in range(5):
        m, c = ours.predict(m, c)
        jm, jc = ref.predict(jm, jc)
        z = meas + rng.normal(0, 1, 4) * [2, 2, 0.01, 0.5]
        m, c = ours.update(m, c, z)
        jm, jc = ref.update(jm, jc, z)
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(c, jc)
    means, covs = np.stack([m, m * 1.1]), np.stack([c, c * 1.2])
    for a, b in zip(ours.multi_predict(means, covs), ref.multi_predict(means, covs)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.project(m, c), ref.project(m, c)):
        np.testing.assert_array_equal(a, b)


def _box(x, y, s=20.0):
    return [x, y, x + s, y + s]


def _sequences():
    """name -> (tracker kwargs, [(boxes (n, 4), scores (n,), classes (n,)), ...])."""
    def frames(positions, score=0.9):
        return [(np.array([_box(x, y) for x, y in pos], np.float32).reshape(-1, 4),
                 np.full(len(pos), score, np.float32), np.zeros(len(pos), np.float32))
                for pos in positions]

    occlusion = [[(50 + 2 * t, 50)] for t in range(5)] + [[]] * 3 + \
        [[(50 + 2 * t, 50)] for t in range(8, 12)]
    byte = [(np.array([_box(10, 10)], np.float32), np.array([0.9], np.float32),
             np.array([0.0], np.float32)),
            (np.array([_box(12, 11)], np.float32), np.array([0.3], np.float32),
             np.array([0.0], np.float32)),
            (np.array([_box(12, 11), _box(300, 300)], np.float32),
             np.array([0.3, 0.3], np.float32), np.array([0.0, 0.0], np.float32))]
    rng = np.random.default_rng(7)
    start = rng.uniform(0, 400, (12, 2))
    vel = rng.normal(0, 4, (12, 2))
    wh = rng.uniform(15, 60, (12, 2))
    crowd = []
    for t in range(40):
        keep = rng.random(12) > 0.15  # objects flicker out
        xy = start + vel * t + rng.normal(0, 1.5, (12, 2))
        b = np.concatenate([xy, xy + wh], 1)[keep].astype(np.float32)
        crowd.append((b, rng.uniform(0.05, 0.95, keep.sum()).astype(np.float32),
                      rng.integers(0, 3, keep.sum()).astype(np.float32)))
    return {
        "stable_identity": ({}, frames([[(10 + 3 * t, 10 + 2 * t)] for t in range(10)])),
        "two_objects": ({}, frames([[(10 + t, 10), (200 - t, 200)] for t in range(8)])),
        "occlusion": ({"track_buffer": 30}, frames(occlusion)),
        "low_conf_byte": ({"track_high_thresh": 0.5, "track_low_thresh": 0.1,
                           "new_track_thresh": 0.5}, byte),
        "crowd": ({"track_buffer": 5}, crowd),
    }


@pytest.mark.parametrize("tracker", ["bytetrack", "botsort"])
@pytest.mark.parametrize("case", ["stable_identity", "two_objects", "occlusion", "low_conf_byte",
                                  "crowd"])
def test_tracker_rows_match_jax(tracker, case):
    kwargs, seq = _sequences()[case]
    if tracker == "botsort":
        kwargs = {**kwargs, "gmc_method": "none"}
    ours, ref = TRACKER_MAP[tracker](**kwargs), JAX_TRACKERS[tracker](**kwargs)
    n = 0
    for boxes, scores, cls in seq:
        got = ours.update(boxes, scores, cls)
        want = ref.update(boxes, scores, cls)
        np.testing.assert_array_equal(got, want)
        n += len(got)
    assert n > 0
    if case == "stable_identity":
        assert set(got[:, 4]) == {1.0}
    if case == "low_conf_byte":
        assert len(got) == 1  # continued by the weak box; the far weak box starts nothing


def _pan_frames(n=8):
    """A textured frame panning right with a white square on it."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 120, (240, 320, 3), dtype=np.uint8)
    out = []
    for t in range(n):
        frame = np.roll(base, shift=2 * t, axis=1)
        x = 100 + 2 * t
        cv2.rectangle(frame, (x, 100), (x + 30, 130), (255, 255, 255), -1)
        out.append((frame, np.array([[x, 100, x + 30, 130]], np.float32)))
    return out


def test_botsort_with_camera_motion_matches_jax():
    frames = _pan_frames()
    rows = {}
    for side, make in (("port", TRACKER_MAP["botsort"]), ("jax", JAX_TRACKERS["botsort"])):
        cv2.setRNGSeed(0)
        tracker, rows[side] = make(), []
        for frame, b in frames:
            rows[side].append(tracker.update(b, np.array([0.9]), np.array([0.0]), img=frame))
    for g, w in zip(rows["port"], rows["jax"]):
        np.testing.assert_array_equal(g, w)
    assert len({int(r[0, 4]) for r in rows["port"] if len(r)}) == 1


def test_gmc_matches_jax():
    from yolo_ad_refine_tpu.trackers.gmc import GMC as JaxGMC

    frames = _pan_frames(4)
    ours, ref = GMC(), JaxGMC()
    for frame, _ in frames:
        cv2.setRNGSeed(1)
        h = ours.apply(frame)
        cv2.setRNGSeed(1)
        np.testing.assert_array_equal(h, ref.apply(frame))
    assert abs(h[0, 2] - 2.0) < 0.5  # the pan: 2 px a frame to the right


def test_zero_height_rows_are_dropped_where_the_jax_tracker_breaks():
    """Hazard (k): a row clipped to zero height starts a NaN track in the
    JAX tracker (a NaN row on frame 1, then a raise at the next association
    that meets it); ``trackable_rows`` drops it, and the port tracks the
    other rows as the JAX tracker tracks them alone."""
    from yolo_ad_refine_tpu_torch.engine.track import trackable_rows

    def rows(*boxes):
        return np.array([[*b, 0.9, 0.0] for b in boxes], np.float32).reshape(-1, 6)

    seq = [rows([10, 10, 50, 50], [100, 0, 160, 0]), rows([12, 11, 52, 51]),
           rows([14, 12, 54, 52], [300, 720, 380, 720])]
    ref = JAX_TRACKERS["bytetrack"]()
    first = ref.update(seq[0][:, :4], seq[0][:, 4], seq[0][:, 5])
    assert np.isnan(first[1, [0, 2]]).all()
    with pytest.raises(ValueError, match="invalid numeric entries"):
        ref.update(seq[1][:, :4], seq[1][:, 4], seq[1][:, 5])
    ours, ref = TRACKER_MAP["bytetrack"](), JAX_TRACKERS["bytetrack"]()
    for d in seq:
        kept = trackable_rows(d)
        assert len(kept) == 1
        got = ours.update(kept[:, :4], kept[:, 4], kept[:, 5])
        np.testing.assert_array_equal(got, ref.update(kept[:, :4], kept[:, 4], kept[:, 5]))
        assert np.isfinite(got).all()


def test_track_ids_come_from_the_ports_own_counter():
    STrack.reset_id()
    JaxSTrack.reset_id()
    assert STrack.next_id() == 1 and STrack.next_id() == 2
    assert JaxSTrack.next_id() == 1  # the two counters are apart
    STrack.reset_id()
    JaxSTrack.reset_id()


def _video(tmp_path, n=8):
    vid = tmp_path / "v.avi"
    w = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"MJPG"), 10, (160, 128))
    for t in range(n):
        frame = np.full((128, 160, 3), 30, np.uint8)
        cv2.rectangle(frame, (20 + 5 * t, 40), (60 + 5 * t, 80), (0, 0, 255), -1)
        cv2.circle(frame, (120 - 4 * t, 90), 12, (0, 255, 0), -1)
        w.write(frame)
    w.release()
    return vid


def localise(variables):
    """The box branch's last conv scaled by 0.1, its biases favouring the
    short DFL bins: random weights otherwise give every anchor a box over
    the whole frame (tests/test_torch_segment.py localise)."""
    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                if k.startswith("cv2_") and k.endswith("_2") and "kernel" in v:
                    v["kernel"] = v["kernel"] * 0.1
                    v["bias"] = np.tile(-0.5 * np.arange(16, dtype=np.float32), 4)
                else:
                    walk(v)
    walk(variables["params"])
    return variables


@pytest.fixture(scope="module")
def models():
    """head -> (JAX model, port model) with the same randomised weights."""
    cache = {}

    def get(head):
        if head not in cache:
            cfg = {**HEADS[head], "backbone": BACKBONE}
            jm, shapes = jax_shapes(cfg, IMGSZ)
            variables = localise(randomize(shapes, seed=9))
            jm.variables = jax.tree.map(jnp.asarray, variables)
            jm.strides = (8, 16, 32)
            port = DetectionModel(cfg)
            load_jax_variables(port, flatten_tree(variables["params"]),
                               flatten_tree(variables["batch_stats"]))
            port.strides = (8, 16, 32)
            if head == "world":
                from yolo_ad_refine_tpu.models.yolo import YOLO as JaxYOLO

                jy = JaxYOLO.__new__(JaxYOLO)
                jy.model, jy.overrides = jm, {}
                jy.set_classes(["person", "car"])
                py = YOLO.__new__(YOLO)
                py.model = port
                py.set_classes(["person", "car"])
            cache[head] = (jm, port.eval())
        return cache[head]

    return get


def _rows(results):
    return [np.asarray(r.boxes.data) for r in results]


@pytest.mark.parametrize("tracker", ["bytetrack", "botsort"])
@pytest.mark.parametrize("head", ["detect", "segment", "pose", "world"])
def test_track_matches_jax_track(models, tmp_path, tracker, head):
    jm, port = models(head)
    vid = _video(tmp_path)
    kw = dict(tracker=tracker, imgsz=IMGSZ, conf=1e-3, max_det=8, tracker_args=LOW)
    cv2.setRNGSeed(0)
    want = jax_track(jm, str(vid), **kw)
    cv2.setRNGSeed(0)
    got = track(port, str(vid), **kw)
    assert len(got) == len(want) == 8
    n = 0
    for g, w in zip(_rows(got), _rows(want)):
        assert g.shape == w.shape and g.shape[1] == 7
        np.testing.assert_array_equal(g[:, [4, 6]], w[:, [4, 6]])  # ids, classes
        np.testing.assert_allclose(g[:, :4], w[:, :4], atol=1e-3)
        np.testing.assert_allclose(g[:, 5], w[:, 5], atol=1e-5)
        n += len(g)
    assert n >= 8 and len({i for r in _rows(got) for i in r[:, 4]}) >= 2
    if head == "world":
        assert set(np.concatenate(_rows(got))[:, 6]) <= {0.0, 1.0}
    assert all({"preprocess", "inference", "track"} <= set(r.speed) for r in got)


def test_yolo_track_entry_point_and_persist(models, tmp_path):
    """``YOLO.track`` takes the JAX facade's arguments; ``persist`` does
    nothing (a fresh tracker, ids from 1, every call), as in JAX (hazard (i))."""
    _, port = models("detect")
    y = YOLO.__new__(YOLO)
    y.model = port
    vid = _video(tmp_path, n=4)
    a = y.track(str(vid), imgsz=IMGSZ, conf=1e-3, tracker_args=LOW)
    b = y.track(str(vid), tracker="bytetrack", imgsz=IMGSZ, conf=1e-3, tracker_args=LOW,
                persist=True, vid_stride=1, iou=0.7, max_det=300, names={0: "a", 1: "b", 2: "c"})
    for r, s in zip(a, b):
        np.testing.assert_array_equal(r.boxes.data, s.boxes.data)
    assert min(np.concatenate(_rows(a))[:, 4]) == 1.0
    assert b[0].names == {0: "a", 1: "b", 2: "c"}
    with pytest.raises(ValueError, match="tracker must be one of"):
        y.track(str(vid), tracker="sort")


def test_track_results_plot_and_write_as_jax(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
    rows = np.array([[10, 12, 50, 60, 3, 0.91, 1], [60, 20, 120, 90, 7, 0.42, 0]], np.float32)
    names = {0: "person", 1: "car"}
    ours, ref = Results(img, "f.jpg", names, rows), JaxResults(img, "f.jpg", names, rows)
    assert ours.boxes.is_track and ref.boxes.is_track
    np.testing.assert_array_equal(ours.boxes.id, [3, 7])
    np.testing.assert_array_equal(ours.boxes.conf, ref.boxes.conf)
    np.testing.assert_array_equal(ours.boxes.cls, ref.boxes.cls)
    np.testing.assert_array_equal(ours.plot(), ref.plot())
    assert not np.array_equal(ours.plot(), Results(img, "f.jpg", names, rows[:, [0, 1, 2, 3, 5, 6]]
                                                   ).plot())  # the id label is drawn
    got, want = json.loads(ours.tojson()), json.loads(ref.tojson())
    assert [e["track_id"] for e in got] == [3, 7]
    assert got == want
    ours.save_txt(tmp_path / "a.txt", save_conf=True)
    ref.save_txt(tmp_path / "b.txt", save_conf=True)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    assert Results(img, "f.jpg", names, rows[:, [0, 1, 2, 3, 5, 6]]).boxes.id is None
    with pytest.raises(ValueError, match="6 or 7 columns"):
        Results(img, "f.jpg", names, np.zeros((1, 5), np.float32))


@pytest.mark.parametrize("head,match", [
    ("v10Detect", "hazard \\(a\\)"), ("OBB", "hazard \\(j\\)"),
    ("RTDETRDecoder", "hazard \\(h\\)"), ("Classify", "no boxes")])
def test_heads_the_jax_tracker_misreads_raise(head, match, tmp_path):
    if head == "RTDETRDecoder":  # the JAX package's tiny decoder (tests/test_torch_rtdetr.py)
        cfg = {"nc": 3, "backbone": BACKBONE,
               "head": [[[2, 3, 4], 1, "RTDETRDecoder", [3, 64, 30, 2, 64]]]}
    elif head == "Classify":
        cfg = {"nc": 3, "backbone": BACKBONE, "head": [[-1, 1, "Classify", ["nc"]]]}
    else:
        args = ["nc", 1] if head == "OBB" else ["nc"]
        cfg = {"nc": 3, "backbone": BACKBONE, "head": [[[2, 3, 4], 1, head, args]]}
    with torch.device("meta"):
        model = DetectionModel(cfg)
    with pytest.raises(ValueError, match=match):
        track(model, str(Path(tmp_path) / "absent.avi"))
