"""The public helpers the port gained to keep the JAX package's surface,
against the JAX ones: the six box conversions and ``box_iou`` (torch
tensors and numpy arrays, seeded inputs, within 1e-6), the package
re-exports, ``check_imgsz`` / ``check_version``, ``get_default_callbacks``,
``Profile``, ``IterableSimpleNamespace``, ``emojis``, ``yaml_print``,
``get_cfg``, ``build_dataloader`` and ``DetectionModel.info`` / ``.profile``.
"""

import numpy as np
import pytest
import torch

from yolo_ad_refine_tpu import ops as jax_ops
from yolo_ad_refine_tpu import utils as jax_utils
from yolo_ad_refine_tpu.utils import checks as jax_checks
from yolo_ad_refine_tpu_torch import ops, utils
from yolo_ad_refine_tpu_torch.utils import checks

CONVERSIONS = ["xywhn2xyxy", "xyxy2xywhn", "xywh2ltwh", "xyxy2ltwh", "ltwh2xywh", "ltwh2xyxy",
               "xywh2xyxy", "xyxy2xywh"]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def boxes(seed: int, shape=(7, 4)) -> np.ndarray:
    r = np.random.default_rng(seed)
    xy = r.uniform(0, 500, (*shape[:-1], 2))
    return np.concatenate([xy, xy + r.uniform(1, 200, (*shape[:-1], 2))], -1).astype(np.float32)


@pytest.mark.parametrize("name", CONVERSIONS)
@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("shape", [(7, 4), (2, 5, 4)])
def test_box_conversion_equals_jax(name, kind, shape):
    x = boxes(len(name), shape)
    if name == "xywhn2xyxy":
        x = x / 700.0
    kw = {"xywhn2xyxy": dict(w=640, h=480, padw=3.5, padh=-2.0),
          "xyxy2xywhn": dict(w=640, h=480)}.get(name, {})
    want = np.asarray(getattr(jax_ops, name)(x, **kw))
    got = getattr(ops, name)(torch.from_numpy(x) if kind == "torch" else x, **kw)
    assert isinstance(got, torch.Tensor if kind == "torch" else np.ndarray)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-6 * max(1.0, np.abs(want).max()),
                               rtol=0)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_xyxy2xywhn_clip_equals_jax(kind):
    x = boxes(3) - 100.0
    want = np.asarray(jax_ops.xyxy2xywhn(x, w=300, h=200, clip=True, eps=1e-3))
    got = ops.xyxy2xywhn(torch.from_numpy(x) if kind == "torch" else x, w=300, h=200, clip=True,
                         eps=1e-3)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("n,m", [(7, 5), (1, 9), (0, 3)])
def test_box_iou_equals_jax(kind, n, m):
    a, b = boxes(n, (n, 4)), boxes(m + 10, (m, 4))
    b[: min(n, m)] = a[: min(n, m)] + 5.0  # overlapping pairs
    want = np.asarray(jax_ops.box_iou(a, b))
    conv = torch.from_numpy if kind == "torch" else np.asarray
    got = ops.box_iou(conv(a), conv(b))
    assert tuple(got.shape) == (n, m)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("package", ["ops", "nn", "models", "data"])
def test_package_reexports_match_jax(package):
    import importlib

    jax_mod = importlib.import_module(f"yolo_ad_refine_tpu.{package}")
    mod = importlib.import_module(f"yolo_ad_refine_tpu_torch.{package}")
    public = [n for n in vars(jax_mod) if not n.startswith("_")
              and getattr(getattr(jax_mod, n), "__module__", "").startswith("yolo_ad_refine_tpu")]
    assert public and all(hasattr(mod, n) for n in public)
    if package == "ops":
        assert sorted(mod.__all__) == sorted(jax_mod.__all__)


@pytest.mark.parametrize("imgsz,stride,floor", [(640, 32, 0), (641, 32, 0), (100, 64, 0),
                                                (30, 32, 64), (1, 1, 0)])
def test_check_imgsz_equals_jax(imgsz, stride, floor):
    assert checks.check_imgsz(imgsz, stride, floor=floor) == \
        jax_checks.check_imgsz(imgsz, stride, floor=floor)


@pytest.mark.parametrize("current,required", [
    ("2.11.0", ">=2.0"), ("2.11.0", "<2.0"), ("1.2.3", "==1.2.3"), ("1.2.3", "!=1.2.3"),
    ("0.9.0", "0.10"), ("3.12.3", ">3.12"), ("1.0", ""), ("2.0", "<=2.0")])
def test_check_version_equals_jax(current, required):
    assert checks.check_version(current, required) == \
        jax_checks.check_version(current, required)


def test_default_callbacks_equal_jax():
    from yolo_ad_refine_tpu.utils.callbacks import get_default_callbacks as jax_default
    from yolo_ad_refine_tpu_torch.utils.callbacks import Callbacks, get_default_callbacks

    got, want = get_default_callbacks(), jax_default()
    assert sorted(got) == sorted(want) and all(v == [] for v in got.values())
    assert got["no_such_hook"] == []  # a defaultdict, as in JAX
    cb = Callbacks()
    with pytest.raises(KeyError):
        cb.add("no_such_hook", print)


def test_namespace_emojis_and_profile_behave_as_jax():
    kw = dict(a=1, b="x", c=[2])
    ours, ref = utils.IterableSimpleNamespace(**kw), jax_utils.IterableSimpleNamespace(**kw)
    assert list(ours) == list(ref) and str(ours) == str(ref)
    assert ours.get("b") == ref.get("b") and ours.get("z", 5) == ref.get("z", 5) == 5
    assert utils.emojis("ok ✅") == jax_utils.emojis("ok ✅")
    p = utils.Profile(t=1.0)
    with p:
        sum(range(1000))
    assert p.dt > 0 and p.t == pytest.approx(1.0 + p.dt) and str(p).startswith("Elapsed time")


def test_yaml_print_logs_the_yaml(tmp_path, monkeypatch):
    msgs = []
    monkeypatch.setattr(utils.LOGGER, "info", lambda m: msgs.append(m))
    utils.yaml_save(tmp_path / "a.yaml", {"lr0": 0.01, "name": "x"})
    utils.yaml_print(tmp_path / "a.yaml")
    utils.yaml_print({"k": [1, 2]})
    assert msgs == ["lr0: 0.01\nname: x\n", "k:\n- 1\n- 2\n"]


def test_trainer_get_cfg_equals_jax():
    from yolo_ad_refine_tpu.train.trainer import get_cfg as jax_get_cfg
    from yolo_ad_refine_tpu_torch.train.trainer import get_cfg

    over = {"epochs": 3, "lr0": 0.02, "imgsz": 320}
    assert get_cfg(over) == jax_get_cfg(over)
    with pytest.raises(SyntaxError):  # an unknown key, as in JAX (with a suggestion)
        get_cfg({"epochz": 3})


def test_build_dataloader_yields_the_jax_batches(tmp_path):
    from yolo_ad_refine_tpu.data import YOLODataset as JaxDataset
    from yolo_ad_refine_tpu.data import build_dataloader as jax_build_dataloader
    from yolo_ad_refine_tpu_torch.data import YOLODataset, build_dataloader, check_det_dataset
    from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset

    data = check_det_dataset(make_shapes_dataset(tmp_path / "ds", n_train=5, n_val=2, imgsz=64,
                                                 seed=2))
    got = list(build_dataloader(YOLODataset(data["val"], imgsz=64), batch_size=2, shuffle=False,
                                workers=2, max_boxes=8))
    want = list(jax_build_dataloader(JaxDataset(data["val"], imgsz=64), batch_size=2,
                                     shuffle=False, workers=2, max_boxes=8))
    assert len(got) == len(want) == 1
    for k in ("img", "cls", "bboxes", "mask"):
        np.testing.assert_array_equal(got[0][k], want[0][k])


def test_detection_model_info_and_profile(caplog):
    from yolo_ad_refine_tpu_torch.models import build_detection_model

    tiny = {"nc": 2, "backbone": [[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                                  [-1, 1, "C3k2", [16, False]], [-1, 1, "Conv", [16, 3, 2]],
                                  [-1, 1, "Conv", [16, 3, 2]]],
            "head": [[[2, 3, 4], 1, "Detect", ["nc"]]]}
    m = build_detection_model(tiny, device="cpu", imgsz=64)
    info = m.info()
    assert info == {"layers": 6, "parameters": m.num_params(), "strides": (4, 8, 16)}
    m.train()
    rows = m.profile(imgsz=64, batch=2, iters=2, verbose=False)
    assert m.training  # the mode is restored
    assert sorted(r[0] for r in rows) == list(range(6))
    assert [r[2] for r in rows] == sorted((r[2] for r in rows), reverse=True)
    assert all(r[2] > 0 for r in rows) and sum(r[3] for r in rows) == m.num_params()
    assert [r[1] for r in sorted(rows)] == [s.name for s in m.specs]
