"""The PyTorch port's train data pipeline against the JAX package: with the
same seeds, samples (mosaic on and off, mixup, close_mosaic, val letterbox)
are bit-equal images with boxes within 1e-6, the loaders give the same
batches in the same order, and the synthetic generator writes the same
files."""

import numpy as np
import pytest

from yolo_ad_refine_tpu.data.build import DataLoader as JaxDataLoader
from yolo_ad_refine_tpu.data.dataset import YOLODataset as JaxDataset
from yolo_ad_refine_tpu.data.dataset import check_det_dataset as jax_check
from yolo_ad_refine_tpu.data.synthetic import make_shapes_dataset as jax_make
from yolo_ad_refine_tpu_torch.data.build import DataLoader
from yolo_ad_refine_tpu_torch.data.dataset import YOLODataset, check_det_dataset
from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset

HYP = {"hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4, "degrees": 5.0, "translate": 0.1,
       "scale": 0.5, "shear": 2.0, "perspective": 0.0, "flipud": 0.2, "fliplr": 0.5,
       "mosaic": 1.0, "mixup": 0.0, "copy_paste": 0.0}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("shapes")
    return make_shapes_dataset(root / "ds", n_train=10, n_val=4, imgsz=96, seed=3,
                               aspect_range=(0.6, 1.6))


def _pair(data, split="train", augment=True, **hyp):
    d = check_det_dataset(data)
    assert d == jax_check(data)
    h = {**HYP, **hyp}
    kw = dict(imgsz=64, augment=augment, hyp=h if augment else None, nc=d["nc"], max_boxes=16)
    return YOLODataset(d[split], **kw), JaxDataset(d[split], cache=False, **kw)


def _assert_sample_equal(a, b):
    np.testing.assert_array_equal(a["img"], b["img"])
    np.testing.assert_allclose(a["bboxes"], b["bboxes"], atol=1e-6)
    np.testing.assert_array_equal(a["cls"], b["cls"])
    assert a["ori_shape"] == b["ori_shape"] and a["im_file"] == b["im_file"]
    np.testing.assert_allclose(np.asarray(a["ratio_pad"], dtype=object).astype(float),
                               np.asarray(b["ratio_pad"], dtype=object).astype(float), atol=1e-9)


@pytest.mark.parametrize("case", ["mosaic", "no_mosaic", "mixup", "close_mosaic", "val"])
def test_get_sample_bit_equal(data, case):
    ours, ref = _pair(data, augment=case != "val", mixup=1.0 if case == "mixup" else 0.0)
    if case == "close_mosaic":
        for ds in (ours, ref):
            ds.mosaic_enabled = False
            ds.hyp = {**ds.hyp, "mosaic": 0.0, "mixup": 0.0}
    for i in range(len(ours)):
        kw = {"mosaic": False} if case == "no_mosaic" else {}
        a = ours.get_sample(i, np.random.default_rng(100 + i), **kw)
        b = ref.get_sample(i, np.random.default_rng(100 + i), **kw)
        _assert_sample_equal(a, b)


@pytest.mark.parametrize("shuffle,close", [(True, False), (True, True), (False, False)])
def test_dataloader_batches_equal(data, shuffle, close):
    ours, ref = _pair(data)
    loaders = [DataLoader(ours, batch_size=4, shuffle=shuffle, seed=5, drop_last=shuffle,
                          workers=2),
               JaxDataLoader(ref, batch_size=4, shuffle=shuffle, seed=5, drop_last=shuffle,
                             workers=3)]
    assert len(loaders[0]) == len(loaders[1])
    for epoch in (0, 1):
        for ld in loaders:
            ld.set_epoch(epoch)
            if close:
                ld.close_mosaic()
        got, want = list(loaders[0]), list(loaders[1])
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a["im_file"] == b["im_file"]
            for k in ("img", "cls", "mask"):
                np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_allclose(a["bboxes"], b["bboxes"], atol=1e-6)


def test_make_shapes_dataset_writes_the_same_files(tmp_path):
    d1 = make_shapes_dataset(tmp_path / "a", n_train=3, n_val=2, imgsz=64, seed=9)
    d2 = jax_make(tmp_path / "b", n_train=3, n_val=2, imgsz=64, seed=9)
    assert {k: v for k, v in d1.items() if k != "path"} == {k: v for k, v in d2.items()
                                                            if k != "path"}
    files = sorted(p.relative_to(tmp_path / "a") for p in (tmp_path / "a").rglob("*")
                   if p.is_file())
    assert len(files) == 10
    for f in files:
        assert (tmp_path / "a" / f).read_bytes() == (tmp_path / "b" / f).read_bytes(), f
