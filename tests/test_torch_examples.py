"""The port's example scripts (``examples_torch/``) against the JAX
package's (``examples/``), on the CPU at imgsz 64, modelled on
``tests/test_examples.py``:

- ``tile_grid`` covers the image (the JAX test's cases);
- ``sliced_predict`` of the tiny 5-Conv + Detect model against the JAX
  function, with the JAX model's seeded weights carried over by
  ``load_jax_variables``: a 100 x 150 image, tile 64, overlap 0.25, conf
  1e-6; boxes within 1e-3 px, scores within 1e-4, in order;
- each script's ``main([..., "--device", "cpu"])`` on synthetic data:
  ``detect`` against the JAX facade's predict; ``region_counter``,
  ``action_recognition`` and ``check_ckpt`` against the JAX scripts'
  printed lines, both sides reading one JAX checkpoint (boxes set to
  their anchors and scores spread, so the 3-frame noise video has
  tracks); ``train11`` for one epoch,
  ``check_ckpt`` on its checkpoint (the total is the model's parameter
  count) and ``val`` on it.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from examples_torch import (action_recognition, check_ckpt, detect, region_counter,
                            sahi_tiled_inference, train11, val)

REPO = Path(__file__).resolve().parents[1]
IMGSZ = 64
TINY = {  # tests/test_examples.py's model
    "nc": 2,
    "backbone": [[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                 [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                 [-1, 1, "Conv", [16, 3, 2]]],
    "head": [[[2, 3, 4], 1, "Detect", ["nc"]]],
}
TINY_CLS = {"nc": 3, "backbone": [[-1, 1, "Conv", [8, 3, 2]]],
            "head": [[-1, 1, "Classify", ["nc"]]]}
CLS_GAIN = 1500.0  # the class convs' weights scaled up: scores spread over (0, 1) with the image
CROP = 32


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def jax_script(name: str):
    """The JAX package's ``examples/<name>.py`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax_main(module, argv: list[str], monkeypatch, capsys) -> list[str]:
    """A JAX script's ``main()`` on ``argv``; the lines it printed."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    module.main()
    return capsys.readouterr().out.splitlines()


def run_port_main(main, argv: list[str], capsys):
    """A port script's ``main(argv)``: (what it returned, the lines it printed)."""
    capsys.readouterr()
    out = main(argv)
    return out, capsys.readouterr().out.splitlines()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny detector built once by the JAX package (seed 0, imgsz 64),
    its boxes set to their anchors +- one stride and its class scores
    spread (CLS_GAIN), so the noise video has tracks that a float's last
    bit does not move, written as a JAX checkpoint;
    the tiny classifier the JAX action script builds from its yaml (seed 0,
    CROP), written as one too; and a 3-frame 64 x 64 noise video."""
    import cv2

    from yolo_ad_refine_tpu.engine.checkpoint import save_checkpoint as jax_save
    from yolo_ad_refine_tpu.models.model import build_detection_model as jax_build

    root = tmp_path_factory.mktemp("examples")
    jm = jax_build(TINY, imgsz=IMGSZ)
    variables = jax.tree.map(np.array, jm.variables)
    for i in range(3):
        box, score = (variables["params"]["modules_5"][f"cv{k}_{i}_2"] for k in (2, 3))
        box["kernel"][:] = 0  # every box its anchor +- one stride: a seeded box spans the image
        box["bias"][:] = np.tile(np.eye(box["bias"].size // 4)[1] * 10, 4)
        score["kernel"] *= CLS_GAIN
        score["bias"][:] = (-2.0, -10.0)  # class 0 first: the action script's person class
    jm.variables = jax.tree.map(jnp.asarray, variables)
    jax_save(root / "det", model=jm, train_args={"imgsz": IMGSZ})

    cls_yaml = root / "tiny-cls.yaml"
    cls_yaml.write_text(yaml.safe_dump(TINY_CLS, sort_keys=False))
    jax_save(root / "cls", model=jax_build(str(cls_yaml), imgsz=CROP),
             train_args={"imgsz": CROP})

    video = root / "v.avi"
    w = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"MJPG"), 5, (IMGSZ, IMGSZ))
    rng = np.random.default_rng(0)
    for _ in range(3):
        w.write(rng.integers(0, 255, (IMGSZ, IMGSZ, 3), np.uint8))
    w.release()
    return {"root": root, "jax_model": jm, "det": root / "det", "cls": root / "cls",
            "cls_yaml": cls_yaml, "video": video}


@pytest.mark.parametrize("h,w,t,ov", [(640, 640, 320, 0.2), (700, 500, 320, 0.25),
                                      (200, 900, 320, 0.0)])
def test_tile_grid_covers_image(h, w, t, ov):
    grid = sahi_tiled_inference.tile_grid(h, w, t, ov)
    assert grid == jax_script("sahi_tiled_inference").tile_grid(h, w, t, ov)
    cov = np.zeros((h, w), bool)
    for (y, x) in grid:
        cov[y : y + t, x : x + t] = True
    assert cov.all()


def test_sliced_predict_matches_jax(tiny):
    from yolo_ad_refine_tpu_torch.models.model import build_detection_model
    from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables

    jm = tiny["jax_model"]
    port = build_detection_model(TINY, imgsz=IMGSZ, device="cpu")
    variables = jax.tree.map(np.asarray, jm.variables)
    load_jax_variables(port, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    img = np.random.default_rng(0).integers(0, 255, (100, 150, 3), np.uint8)
    kw = dict(tile=64, overlap=0.25, conf=1e-6, max_det=50)
    want = jax_script("sahi_tiled_inference").sliced_predict(jm, img, **kw)
    got = sahi_tiled_inference.sliced_predict(port, img, **kw)
    assert len(got[0]) == len(want[0]) > 0  # the union of 6 tiles, merged
    assert got[0][:, 2].max() > 64  # full-image coordinates, not a tile's
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[2], want[2])


def test_detect_main_matches_the_jax_facade(tiny, tmp_path, capsys):
    import cv2

    from yolo_ad_refine_tpu import YOLO as JaxYOLO

    src = tmp_path / "images"
    src.mkdir()
    rng = np.random.default_rng(1)
    for i, (h, w) in enumerate(((64, 64), (48, 80), (90, 60))):
        cv2.imwrite(str(src / f"im{i}.jpg"), rng.integers(0, 256, (h, w, 3), np.uint8))
    printed, lines = run_port_main(detect.main, [
        "--weights", str(tiny["det"]), "--source", str(src), "--imgsz", str(IMGSZ),
        "--project", str(tmp_path / "runs"), "--device", "cpu"], capsys)
    want = JaxYOLO(str(tiny["det"])).predict(source=str(src), imgsz=IMGSZ, conf=0.25)
    assert printed == [(r.path, r.verbose()) for r in want]
    assert lines == [f"{p} {v}" for p, v in printed] and len(lines) == 3
    assert sorted(p.name for p in (tmp_path / "runs" / "predict").glob("*.jpg")) == \
        ["im0.jpg", "im1.jpg", "im2.jpg"]


def test_region_counter_main_matches_jax(tiny, monkeypatch, capsys):
    argv = [str(tiny["video"]), str(tiny["det"]), "--imgsz", str(IMGSZ)]
    want = run_jax_main(jax_script("region_counter"), argv, monkeypatch, capsys)
    out, got = run_port_main(region_counter.main, [*argv, "--device", "cpu"], capsys)
    assert got == want
    assert out["frames"] == 3 and set(out["regions"]) == {"left", "right"}
    assert got[-1] == "3 frames processed"


def test_action_recognition_main_matches_jax(tiny, monkeypatch, capsys):
    argv = [str(tiny["video"]), "--det-model", str(tiny["det"]), "--imgsz", str(IMGSZ),
            "--window", "2", "--crop-size", str(CROP)]
    want = run_jax_main(jax_script("action_recognition"),
                        [*argv, "--cls-model", str(tiny["cls_yaml"])], monkeypatch, capsys)
    out, got = run_port_main(action_recognition.main,
                             [*argv, "--cls-model", str(tiny["cls"]), "--device", "cpu"], capsys)
    assert got == want
    assert out["frames"] == 3 and out["labels"] and max(out["votes"].values()) == 2
    assert got[-1] == f"3 frames processed, {len(out['labels'])} tracks classified"


def test_letterbox_crop_and_crop_classifier_match_jax(tiny):
    jax_action = jax_script("action_recognition")
    img = np.random.default_rng(2).integers(0, 256, (60, 90, 3), np.uint8)
    for box in ((3.7, 5.2, 40.9, 30.1), (-4.0, 10.0, 20.0, 70.0), (50.0, 50.0, 50.0, 55.0)):
        np.testing.assert_array_equal(action_recognition.letterbox_crop(img, box, CROP),
                                      jax_action.letterbox_crop(img, box, CROP))
    crops = np.random.default_rng(3).integers(0, 256, (5, CROP, CROP, 3), np.uint8)
    want = jax_action.CropClassifier(str(tiny["cls_yaml"]), crop_size=CROP)(crops)
    got = action_recognition.CropClassifier(str(tiny["cls"]), crop_size=CROP, device="cpu")(crops)
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want], rtol=0, atol=1e-5)


def test_check_ckpt_main_matches_jax_on_a_jax_checkpoint(tiny, monkeypatch, capsys):
    want = run_jax_main(jax_script("check_ckpt"), [str(tiny["det"])], monkeypatch, capsys)
    out, got = run_port_main(check_ckpt.main, [str(tiny["det"]), "--device", "cpu"], capsys)
    assert got == want
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tiny["jax_model"].variables[
        "params"]))
    assert out["total"] == n_jax and out["head"] == "Detect" and out["strides"] == (8, 16, 32)
    needle = run_jax_main(jax_script("check_ckpt"), [str(tiny["det"]), "cv3_0"], monkeypatch,
                          capsys)
    out, got = run_port_main(check_ckpt.main, [str(tiny["det"]), "cv3_0", "--device", "cpu"],
                             capsys)
    assert got == needle and 0 < len(out["leaves"]) < 20


def test_train11_check_ckpt_and_val_mains(tmp_path, capsys):
    from yolo_ad_refine_tpu_torch import YOLO
    from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset

    data = make_shapes_dataset(tmp_path / "ds", n_train=4, n_val=2, imgsz=IMGSZ, seed=0)
    data_yaml = tmp_path / "data.yaml"
    data_yaml.write_text(yaml.safe_dump(data, sort_keys=False))
    model_yaml = tmp_path / "tiny.yaml"
    model_yaml.write_text(yaml.safe_dump({**TINY, "nc": len(data["names"])}, sort_keys=False))
    assert train11.TRAIN_ARGS["epochs"] == 220 and train11.TRAIN_ARGS["lrf"] == 0.001
    results = train11.main(["--model", str(model_yaml), "--device", "cpu", f"data={data_yaml}",
                            "epochs=1", f"imgsz={IMGSZ}", "batch=2", "plots=False",
                            f"project={tmp_path / 'runs'}", "name=t"])
    best = Path(results["save_dir"]) / "weights" / "best"
    assert best.is_dir()
    out, lines = run_port_main(check_ckpt.main, [str(best), "--device", "cpu"], capsys)
    assert out["total"] == YOLO(str(best), device="cpu").model.num_params()
    assert f"total parameters: {out['total']:,}" in lines
    report = tmp_path / "paper_data.txt"
    metrics = val.main(["--weights", str(best), "--device", "cpu", f"data={data_yaml}",
                        f"imgsz={IMGSZ}", "batch=2", f"save_path={report}"])
    assert "fitness" in metrics and report.read_text().startswith(f"model: {best}")
