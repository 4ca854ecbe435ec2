"""The port's solution apps (``yolo_ad_refine_tpu_torch/solutions``) against
the JAX package's, fed the same rows: per-frame ``Results`` built as in
``tests/test_solutions.py`` (rows of x1, y1, x2, y2, track id, conf, cls)
from one seeded scene of tracks crossing a 320x240 frame, with and without
track ids. Summaries, ``heat`` arrays, parking occupancy, AIGym counts,
stages and angles, chart frames and every rendered frame are equal
(``np.array_equal``; the apps are the same host code on numpy and cv2).
"""

import json

import numpy as np
import pytest
import torch

from yolo_ad_refine_tpu import solutions as jax_solutions
from yolo_ad_refine_tpu.engine.results import Results as JaxResults
from yolo_ad_refine_tpu.solutions import base as jax_base
from yolo_ad_refine_tpu_torch import solutions
from yolo_ad_refine_tpu_torch.engine.results import Results
from yolo_ad_refine_tpu_torch.solutions import base

H, W = 240, 320
NAMES = {0: "person", 1: "car", 2: "dog"}
FRAMES = 12


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def scene(seed: int = 0, tracks: int = 6) -> list[np.ndarray]:
    """FRAMES frames of (n, 7) rows: tracks on straight lines across the
    frame (some crossing x = 160 and the queue region), each with a class,
    a score, and a frame where it appears and one where it leaves."""
    r = np.random.default_rng(seed)
    start = r.uniform((10, 20), (300, 200), (tracks, 2))
    vel = r.uniform(-25, 25, (tracks, 2))
    size = r.uniform(12, 40, (tracks, 2))
    born = r.integers(0, 3, tracks)
    dies = r.integers(FRAMES - 3, FRAMES + 1, tracks)
    cls = r.integers(0, 3, tracks)
    conf = r.uniform(0.3, 0.95, tracks)
    frames = []
    for t in range(FRAMES):
        rows = []
        for k in range(tracks):
            if born[k] <= t < dies[k]:
                x, y = start[k] + vel[k] * t
                rows.append((x, y, x + size[k, 0], y + size[k, 1], k + 1, conf[k], cls[k]))
        frames.append(np.asarray(rows, np.float32).reshape(-1, 7))
    return frames


def results_pair(rows: np.ndarray, tracked: bool = True, keypoints=None):
    """(port Results, JAX Results) of one frame's rows; untracked rows drop
    the id column (6 columns)."""
    img = np.zeros((H, W, 3), np.uint8)
    data = rows if tracked else rows[:, [0, 1, 2, 3, 5, 6]]
    kw = {} if keypoints is None else {"keypoints": keypoints}
    return (Results(img, "f.jpg", NAMES, data.copy(), **kw),
            JaxResults(img.copy(), "f.jpg", NAMES, data.copy(), **kw))


def frame(seed: int):
    return np.random.default_rng(seed).integers(0, 256, (H, W, 3), np.uint8)


@pytest.mark.parametrize("region", [[(160, 0), (160, 240)], [(60, 40), (260, 40), (260, 200),
                                                             (60, 200)]])
@pytest.mark.parametrize("classes", [None, [0, 2]])
def test_object_counter_equals_jax(region, classes):
    ours = solutions.ObjectCounter(region, classes=classes, names=NAMES)
    ref = jax_solutions.ObjectCounter(region, classes=classes, names=NAMES)
    drawn = (solutions.ObjectCounter(region, classes=classes, names=NAMES),
             jax_solutions.ObjectCounter(region, classes=classes, names=NAMES))
    for t, rows in enumerate(scene()):
        p, j = results_pair(rows)
        assert ours.update(p) == ref.update(j)
        got, want = drawn[0].count(frame(t), p), drawn[1].count(frame(t), j)
        assert np.array_equal(got, want)
    assert ours.summary() == ref.summary() == drawn[0].summary() == drawn[1].summary()
    assert ours.summary()["in"] + ours.summary()["out"] > 0 or classes is not None


@pytest.mark.parametrize("mode", ["update", "generate", "generate_region", "render"])
def test_heatmap_equals_jax(mode):
    region = [(160, 0), (160, 240)] if mode == "generate_region" else None
    ours = solutions.Heatmap((H, W), decay=0.9, region=region, names=NAMES)
    ref = jax_solutions.Heatmap((H, W), decay=0.9, region=region, names=NAMES)
    for t, rows in enumerate(scene(1)):
        p, j = results_pair(rows, tracked=t % 4 != 3)  # some frames without ids
        if mode in ("update", "render"):
            ours.update(p)
            ref.update(j)
        else:
            assert np.array_equal(ours.generate_heatmap(frame(t), p),
                                  ref.generate_heatmap(frame(t), j))
        assert np.array_equal(ours.heat, ref.heat)
    if mode == "render":
        assert np.array_equal(ours.render(), ref.render())
        assert np.array_equal(ours.render(frame(99), alpha=0.3), ref.render(frame(99), alpha=0.3))
    if region is not None:
        assert ours.counter.summary() == ref.counter.summary()
    assert ours.heat.any()


@pytest.mark.parametrize("tracked", [True, False])
def test_speed_and_distance_equal_jax(tracked):
    ours_s, ref_s = solutions.SpeedEstimator(fps=24, pixels_per_meter=8), \
        jax_solutions.SpeedEstimator(fps=24, pixels_per_meter=8)
    ours_d, ref_d = solutions.DistanceCalculator(8.0), jax_solutions.DistanceCalculator(8.0)
    for rows in scene(2):
        p, j = results_pair(rows, tracked)
        assert ours_s.update(p) == ref_s.update(j)
        assert ours_d.update(p) == ref_d.update(j)
        assert ours_d.update(p, ids=(1, 2)) == ref_d.update(j, ids=(1, 2))
    assert bool(ours_s.speeds) == tracked


@pytest.mark.parametrize("classes", [None, [1]])
def test_queue_manager_equals_jax(classes):
    region = [(40, 30), (200, 30), (200, 210), (40, 210)]
    ours = solutions.QueueManager(region, classes=classes, names=NAMES)
    ref = jax_solutions.QueueManager(region, classes=classes, names=NAMES)
    drawn = (solutions.QueueManager(region, classes=classes, names=NAMES),
             jax_solutions.QueueManager(region, classes=classes, names=NAMES))
    for t, rows in enumerate(scene(3)):
        p, j = results_pair(rows)
        assert ours.update(p) == ref.update(j)
        assert np.array_equal(drawn[0].process_queue(frame(t), p),
                              drawn[1].process_queue(frame(t), j))
        assert drawn[0].count == drawn[1].count
    assert ours.history == ref.history and drawn[0].history == drawn[1].history


def test_parking_manager_equals_jax(tmp_path):
    slots = [{"points": [[x, 40], [x + 60, 40], [x + 60, 120], [x, 120]]}
             for x in range(0, 300, 70)] + [{"points": [[20, 150], [150, 150], [150, 230],
                                                        [20, 230]]}]
    path = tmp_path / "slots.json"
    path.write_text(json.dumps(slots))
    ours, ref = solutions.ParkingManager(path), jax_solutions.ParkingManager(path)
    occupied = 0
    for t, rows in enumerate(scene(4)):
        p, j = results_pair(rows)
        assert ours.update(p) == ref.update(j)
        assert np.array_equal(ours.annotate(frame(t)), ref.annotate(frame(t)))
        occupied += ours.summary()["Occupancy"]
    assert occupied > 0


def test_parking_manager_refuses_a_bad_file(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps([{"corners": []}]))
    with pytest.raises(ValueError):
        solutions.ParkingManager(path)


def pose_frames(seed: int = 5, people: int = 3):
    """Per frame (rows, keypoints (n, 17, 3)): each person's elbow (7)
    angle swings between 40 and 170 degrees at its own rate."""
    r = np.random.default_rng(seed)
    rate = r.uniform(0.5, 1.5, people)
    phase = r.uniform(0, np.pi, people)
    out = []
    for t in range(FRAMES * 2):
        rows, kps = [], []
        for k in range(people):
            ang = np.deg2rad(105 + 65 * np.sin(rate[k] * t + phase[k]))
            kp = r.uniform(0, 200, (17, 3)).astype(np.float32)
            shoulder, elbow = np.array([50.0 + 60 * k, 50.0]), np.array([50.0 + 60 * k, 100.0])
            wrist = elbow + 40 * np.array([np.sin(ang), -np.cos(ang)])
            kp[5, :2], kp[7, :2], kp[9, :2] = shoulder, elbow, wrist
            kps.append(kp)
            rows.append((shoulder[0] - 20, 30, shoulder[0] + 20, 160, k + 1, 0.9, 0))
        out.append((np.asarray(rows, np.float32), np.stack(kps)))
    return out


@pytest.mark.parametrize("kpts,up,down", [((5, 7, 9), 145.0, 90.0), ((6, 8, 10), 120.0, 60.0)])
def test_ai_gym_equals_jax(kpts, up, down):
    ours = solutions.AIGym(kpts=kpts, up_angle=up, down_angle=down)
    ref = jax_solutions.AIGym(kpts=kpts, up_angle=up, down_angle=down)
    for rows, kp in pose_frames():
        p, j = results_pair(rows, keypoints=kp)
        assert ours.update(p) == ref.update(j)
    s = ours.summary()
    assert s == ref.summary()
    if kpts == (5, 7, 9):
        assert sum(s["count"].values()) > 0 and set(s["stage"].values()) <= {"up", "down"}


@pytest.mark.parametrize("a,b,c", [((0, 0), (1, 0), (1, 1)), ((3, 4), (0, 0), (-4, 3)),
                                   ((1, 1), (0, 0), (2, 2))])
def test_pose_angle_equals_jax(a, b, c):
    from yolo_ad_refine_tpu.solutions.ai_gym import estimate_pose_angle as jax_angle
    from yolo_ad_refine_tpu_torch.solutions.ai_gym import estimate_pose_angle

    assert estimate_pose_angle(a, b, c) == jax_angle(a, b, c)


@pytest.mark.parametrize("chart", ["line", "area", "bar", "pie"])
def test_analytics_equals_jax(chart):
    pytest.importorskip("matplotlib")
    ours = solutions.Analytics(chart, names=NAMES, figsize=(3.2, 2.4))
    ref = jax_solutions.Analytics(chart, names=NAMES, figsize=(3.2, 2.4))
    for t, rows in enumerate(scene(6)[:6]):
        p, j = results_pair(rows)
        got, want = ours.update(t, p), ref.update(t, j)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.array_equal(got, want)
    assert ours.totals == ref.totals and ours.classwise == ref.classwise


def test_analytics_refuses_an_unknown_chart():
    with pytest.raises(ValueError, match="chart_type"):
        solutions.Analytics("radar")


@pytest.mark.parametrize("name,args", [
    ("point_in_polygon", ((5, 5), [(0, 0), (10, 0), (10, 10), (0, 10)])),
    ("point_in_polygon", ((15, 5), [(0, 0), (10, 0), (10, 10), (0, 10)])),
    ("segments_intersect", ((0, 0), (10, 10), (0, 10), (10, 0))),
    ("segments_intersect", ((0, 0), (1, 1), (2, 2), (3, 3))),
    ("segments_intersect", ((0, 0), (2, 2), (2, 2), (3, 0))),
    ("polygon_centroid", ([(0, 0), (4, 0), (4, 2)],)),
    ("track_color", (7,)),
])
def test_geometry_equals_jax(name, args):
    assert getattr(base, name)(*args) == getattr(jax_base, name)(*args)


def test_annotator_draws_as_jax():
    ours, ref = base.SolutionAnnotator(frame(1), 2), jax_base.SolutionAnnotator(frame(1), 2)
    for a in (ours, ref):
        a.draw_region([(10, 10), (100, 10), (100, 90)])
        a.draw_region([(10, 200), (300, 200)], color=(1, 2, 3), thickness=5)
        a.box_label((20, 30, 80, 90), "car", color=(0, 255, 0))
        a.draw_centroid_and_tracks([(50, 50), (60, 55), (70, 65)], color=(255, 0, 0))
        a.display_analytics({"Person": "IN 3 OUT 1", "Car": "IN 0 OUT 2"})
        a.queue_counts_display("Queue Counts : 4", points=[(10, 10), (100, 10), (100, 90)])
    assert np.array_equal(ours.im, ref.im)


def test_run_headless_yields_the_facade_predictions(tmp_path):
    """``run_headless`` walks ``model.predict(source=..., stream=True)``, which
    the port's predictor, like the JAX one, answers with the list of
    Results: frame by frame, up to max_frames."""
    from yolo_ad_refine_tpu_torch import YOLO

    tiny = {"nc": 3, "backbone": [[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                                  [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                                  [-1, 1, "Conv", [16, 3, 2]]],
            "head": [[[2, 3, 4], 1, "Detect", ["nc"]]]}
    model = YOLO(tiny, device="cpu", imgsz=64)
    imgs = [frame(i)[:64, :64] for i in range(3)]
    got = list(solutions.run_headless(model, imgs, conf=0.001, max_frames=2))
    want = model.predict(source=imgs, conf=0.001, iou=0.45)
    assert [i for i, _ in got] == [0, 1]
    for (_, r), w in zip(got, want):
        assert np.array_equal(r.boxes.data, w.boxes.data)


def test_inference_needs_streamlit():
    from yolo_ad_refine_tpu_torch.solutions.inference_app import inference

    try:
        import streamlit  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="streamlit"):
            inference()
    else:
        pytest.fail("this test image is expected to have no streamlit")
