"""The port's dataset tools against the JAX package's: ``data/converter.py``
(COCO json and DOTA txt to YOLO rows) and ``data/split_dota.py`` (windows,
intersection over foreground, tiles) write byte-equal files and give equal
arrays; ``data/annotator.py auto_annotate`` through the port's ``YOLO``
facade, with the JAX facade's numpy-seeded weights carried in
(``load_jax_variables``), writes the rows the JAX one writes within 1e-4
(box rows with a tiny detect yaml, polygon rows with a tiny segment yaml,
on images smaller than imgsz); rows whose scores tie within rounding may
swap places, as the two frameworks sum the convolutions in other orders.
"""

import json

import cv2
import numpy as np
import pytest
import torch

from test_torch_predict_sources import TINY as TINY_DET
from test_torch_segment import TINY_SEG, localise
from test_torch_weights import randomize
from yolo_ad_refine_tpu import YOLO as JaxYOLO
from yolo_ad_refine_tpu.data import annotator as jax_annotator
from yolo_ad_refine_tpu.data import converter as jax_converter
from yolo_ad_refine_tpu.data import split_dota as jax_split
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.data import annotator, converter, split_dota
from yolo_ad_refine_tpu_torch.utils import yaml_save
from yolo_ad_refine_tpu_torch.utils.jax_weights import flatten_tree, load_jax_variables


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def tree(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


COCO = {
    "images": [{"id": 1, "file_name": "train/a.jpg", "height": 100, "width": 200},
               {"id": 7, "file_name": "b.jpg", "height": 480, "width": 640}],
    "annotations": [
        {"image_id": 1, "category_id": 1, "bbox": [20, 10, 40, 30], "iscrowd": 0,
         "segmentation": [[20, 10, 60, 10, 60, 40, 20, 40]],
         "keypoints": [30, 20, 2, 50, 30, 1, 0, 0, 0]},
        {"image_id": 1, "category_id": 3, "bbox": [100, 50, 50, 40], "iscrowd": 0,
         "segmentation": [], "keypoints": [110, 60, 2, 0, 0, 0, 140, 80, 2]},
        {"image_id": 1, "category_id": 12, "bbox": [0, 0, 10, 10], "iscrowd": 0},  # no coco80
        {"image_id": 1, "category_id": 1, "bbox": [5, 5, 20, 20], "iscrowd": 1},
        {"image_id": 7, "category_id": 18, "bbox": [300.5, 200.25, 120.75, 90.5], "iscrowd": 0,
         "segmentation": [[300, 200, 420, 200, 420, 260], [330, 280, 400, 280, 400, 290, 330, 290]],
         "keypoints": [310, 210, 2, 320, 220, 2, 330, 230, 1]},
        {"image_id": 7, "category_id": 90, "bbox": [10, 10, 0, 5], "iscrowd": 0},  # empty box
        {"image_id": 7, "category_id": 90, "bbox": [10, 10, 30, 50], "iscrowd": 0,
         "segmentation": {"counts": [1, 2], "size": [480, 640]}},  # RLE
    ],
    "categories": [],
}


def keypoint_coco() -> dict:
    """COCO's person-keypoints layout: every kept annotation has keypoints."""
    anns = [a for a in COCO["annotations"] if "keypoints" in a or a.get("iscrowd")]
    return {**COCO, "annotations": anns}


@pytest.mark.parametrize("segments,keypoints,cls91to80", [
    (False, False, True), (True, False, True), (False, True, True), (True, False, False)])
def test_convert_coco_writes_jax_bytes(tmp_path, segments, keypoints, cls91to80):
    (tmp_path / "in").mkdir()
    coco = keypoint_coco() if keypoints else COCO
    (tmp_path / "in" / "instances_val2017.json").write_text(json.dumps(coco))
    (tmp_path / "in" / "person_keypoints_train.json").write_text(json.dumps(coco))
    kw = dict(use_segments=segments, use_keypoints=keypoints, cls91to80=cls91to80)
    converter.convert_coco(tmp_path / "in", tmp_path / "ours", **kw)
    jax_converter.convert_coco(tmp_path / "in", tmp_path / "ref", **kw)
    got, want = tree(tmp_path / "ours"), tree(tmp_path / "ref")
    assert got == want and len(got) == 4


def test_convert_coco_keypoints_with_a_box_lacking_them_raises_as_jax(tmp_path):
    """A kept box without keypoints shifts the keypoint rows against the box
    rows, and the write indexes past them: the JAX converter's fault
    (``data/converter.py:146``), kept for parity (ROADMAP Queue 3)."""
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "instances_val.json").write_text(json.dumps(COCO))
    for convert in (converter.convert_coco, jax_converter.convert_coco):
        with pytest.raises(IndexError):
            convert(tmp_path / "in", tmp_path / "out", use_keypoints=True)


def test_coco91_map_and_merge_multi_segment_equal_jax():
    assert converter.coco91_to_coco80_class() == jax_converter.coco91_to_coco80_class()
    r = np.random.default_rng(0)
    parts = [r.uniform(0, 100, 2 * n).tolist() for n in (4, 6, 3, 5)]
    got, want = converter.merge_multi_segment(parts), jax_converter.merge_multi_segment(parts)
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


def test_convert_dota_to_yolo_obb_writes_jax_bytes(tmp_path):
    r = np.random.default_rng(1)
    names = ["plane", "ship", "storage tank", "small vehicle"]
    for phase in ("train", "val"):
        (tmp_path / "images" / phase).mkdir(parents=True)
        (tmp_path / "labels" / f"{phase}_original").mkdir(parents=True)
        for i in range(3):
            h, w = int(r.integers(200, 400)), int(r.integers(200, 400))
            cv2.imwrite(str(tmp_path / "images" / phase / f"P{i}.png"),
                        r.integers(0, 255, (h, w, 3), np.uint8))
            rows = [" ".join(f"{v:.1f}" for v in r.uniform(0, min(h, w), 8))
                    + f" {names[int(r.integers(0, 4))]} {int(r.integers(0, 2))}" for _ in range(4)]
            rows += ["1 2 3", "1 2 3 4 5 6 7 8 helipad 0"]  # short, unknown class
            (tmp_path / "labels" / f"{phase}_original" / f"P{i}.txt").write_text("\n".join(rows))
    ref = tmp_path.parent / f"{tmp_path.name}_ref"
    ref.mkdir()
    for p in tmp_path.rglob("*"):
        if p.is_file():
            (ref / p.relative_to(tmp_path)).parent.mkdir(parents=True, exist_ok=True)
            (ref / p.relative_to(tmp_path)).write_bytes(p.read_bytes())
    converter.convert_dota_to_yolo_obb(tmp_path)
    jax_converter.convert_dota_to_yolo_obb(ref)
    got, want = tree(tmp_path / "labels"), tree(ref / "labels")
    assert got == want and len([k for k in got if "original" not in k]) == 6


@pytest.mark.parametrize("size,crops,gaps", [((1500, 2000), (1024,), (200,)),
                                             ((3000, 4000), (1024, 512), (200, 100)),
                                             ((300, 500), (1024,), (200,))])
def test_get_windows_equal_jax(size, crops, gaps):
    got = split_dota.get_windows(size, crops, gaps)
    assert np.array_equal(got, jax_split.get_windows(size, crops, gaps)) and len(got)


def test_bbox_iof_equals_jax():
    r = np.random.default_rng(2)
    polys = r.uniform(0, 2000, (30, 8))
    wins = split_dota.get_windows((1500, 2000)).astype(np.float64)
    np.testing.assert_array_equal(split_dota.bbox_iof(polys, wins), jax_split.bbox_iof(polys, wins))


def test_get_windows_refuses_a_gap_as_wide_as_the_crop():
    with pytest.raises(ValueError, match="crop_size gap"):
        split_dota.get_windows((100, 100), (200,), (200,))


@pytest.fixture(scope="module")
def dota_root(tmp_path_factory):
    """One 1200 x 1600 image with 20 rotated labels (normalised corners) and
    one image without labels, in the DOTA layout."""
    root = tmp_path_factory.mktemp("dota")
    r = np.random.default_rng(3)
    for d in ("images/train", "labels/train"):
        (root / d).mkdir(parents=True)
    h, w = 1200, 1600
    cv2.imwrite(str(root / "images/train/big.jpg"), r.integers(0, 255, (h, w, 3), np.uint8))
    cv2.imwrite(str(root / "images/train/empty.png"), r.integers(0, 255, (300, 200, 3), np.uint8))
    rows = []
    for _ in range(20):
        cx, cy = r.uniform(50, w - 50), r.uniform(50, h - 50)
        bw, bh, a = r.uniform(10, 120), r.uniform(10, 60), r.uniform(0, np.pi)
        c, s = np.cos(a), np.sin(a)
        pts = np.array([[-bw, -bh], [bw, -bh], [bw, bh], [-bw, bh]]) / 2 @ np.array([[c, s], [-s, c]])
        pts = (pts + [cx, cy]) / [w, h]
        rows.append(f"{int(r.integers(0, 15))} " + " ".join(f"{v:.6g}" for v in pts.ravel()))
    (root / "labels/train/big.txt").write_text("\n".join(rows) + "\n")
    return root


@pytest.mark.parametrize("crops,gaps,iof", [((512,), (128,), 0.7), ((640, 320), (100, 50), 0.5)])
def test_split_images_and_labels_writes_jax_tiles(dota_root, tmp_path, crops, gaps, iof):
    split_dota.split_images_and_labels(dota_root, tmp_path / "ours", "train", crops, gaps, iof)
    jax_split.split_images_and_labels(dota_root, tmp_path / "ref", "train", crops, gaps, iof)
    got, want = tree(tmp_path / "ours"), tree(tmp_path / "ref")
    assert got == want
    labels = [k for k, v in got.items() if k.startswith("labels") and v.strip()]
    assert len(got) > 8 and labels


def test_load_yolo_dota_and_split_trainval_equal_jax(dota_root, tmp_path):
    got, want = split_dota.load_yolo_dota(dota_root), jax_split.load_yolo_dota(dota_root)
    assert [(a["filepath"], a["ori_size"]) for a in got] == \
        [(a["filepath"], a["ori_size"]) for a in want]
    assert all(np.array_equal(a["label"], b["label"]) for a, b in zip(got, want))
    val = dota_root / "images" / "val"
    if not val.exists():
        (dota_root / "labels" / "val").mkdir()
        val.mkdir()
        (val / "v.jpg").write_bytes((dota_root / "images/train/big.jpg").read_bytes())
    split_dota.split_trainval(dota_root, tmp_path / "ours", crop_size=800, gap=200,
                              rates=(1.0, 2.0))
    jax_split.split_trainval(dota_root, tmp_path / "ref", crop_size=800, gap=200,
                             rates=(1.0, 2.0))
    assert tree(tmp_path / "ours") == tree(tmp_path / "ref")


def _rows(path):
    return [np.asarray(line.split(), np.float64) for line in path.read_text().splitlines()
            if line.strip()]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """5 seeded images of 96 x 128 and 128 x 80 (imgsz 128 letterboxes them)
    with filled shapes, and a file that is not an image."""
    root = tmp_path_factory.mktemp("annotate")
    r = np.random.default_rng(4)
    for i in range(5):
        h, w = (96, 128) if i % 2 else (128, 80)
        img = cv2.GaussianBlur(r.integers(0, 255, (h, w, 3), np.uint8), (5, 5), 0)
        for _ in range(3):
            x, y = int(r.integers(0, w - 20)), int(r.integers(0, h - 20))
            cv2.rectangle(img, (x, y), (x + 20, y + 16), tuple(int(v) for v in r.integers(0, 255, 3)),
                          -1)
        cv2.imwrite(str(root / f"im{i}.jpg"), img)
    (root / "notes.txt").write_text("not an image")
    return root


def facades(tmp_path, cfg: dict, variables):
    yaml_save(tmp_path / "model.yaml", cfg)
    jy = JaxYOLO(str(tmp_path / "model.yaml"))
    jy.model.variables = variables
    py = YOLO(str(tmp_path / "model.yaml"), device="cpu", imgsz=128)
    load_jax_variables(py.model, flatten_tree(variables["params"]),
                       flatten_tree(variables["batch_stats"]))
    return py, jy


@pytest.mark.parametrize("kind", ["detect", "segment"])
def test_auto_annotate_writes_jax_rows(images, tmp_path, kind):
    import jax
    import jax.numpy as jnp
    from yolo_ad_refine_tpu.models.model import build_detection_model as jax_build

    cfg = TINY_DET if kind == "detect" else TINY_SEG
    jm = jax_build(cfg, imgsz=128)
    variables = randomize(jm.variables, seed=4)
    if kind == "segment":
        variables = localise(variables, mask_bias=2.0)
    py, jy = facades(tmp_path, cfg, jax.tree.map(jnp.asarray, variables))
    conf = 0.01 if kind == "detect" else 0.05
    ours = annotator.auto_annotate(images, py, tmp_path / "ours", conf=conf, imgsz=128)
    ref = jax_annotator.auto_annotate(images, jy, tmp_path / "ref", conf=conf, imgsz=128)
    files = sorted(p.name for p in ours.glob("*.txt"))
    assert files == sorted(p.name for p in ref.glob("*.txt")) == [f"im{i}.txt" for i in range(5)]
    n = swapped = 0
    for f in files:
        got, want = _rows(ours / f), _rows(ref / f)
        assert len(got) == len(want)
        free = list(range(len(want)))
        for i, g in enumerate(got):  # rows whose scores tie within rounding may swap places
            j = next((j for j in free if len(want[j]) == len(g) and g[0] == want[j][0]
                      and np.abs(g - want[j]).max() <= 1e-4), None)
            assert j is not None, f"{f} row {i}: {g} has no JAX row within 1e-4"
            free.remove(j)
            swapped += j != i
            assert len(g) == 5 or kind == "segment"
            assert ((g[1:] >= 0) & (g[1:] <= 1)).all() or kind == "detect"
        n += len(got)
    assert n > 0 and swapped <= n // 20


def test_auto_annotate_default_output_dir(images, tmp_path):
    """Without output_dir the labels go beside ``data`` as the JAX package
    puts them: <data>_auto_annotate_labels."""
    (tmp_path / "imgs").mkdir()
    (tmp_path / "imgs" / "a.jpg").write_bytes((images / "im0.jpg").read_bytes())
    model = YOLO(TINY_DET, device="cpu", imgsz=64)
    out = annotator.auto_annotate(tmp_path / "imgs", model, imgsz=64)
    assert out == tmp_path / "imgs_auto_annotate_labels" and (out / "a.txt").exists()
