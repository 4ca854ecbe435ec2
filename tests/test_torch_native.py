"""The port's native host ops (``yolo_ad_refine_tpu_torch/ops/native.py``
over its own ``csrc/yat_ops.cpp`` and ``csrc/yat_loader.cpp``) against the
JAX package's ``ops/native.py``: the same C++ under the same g++, built into
separate directories, so every output is byte-equal. The NMS also holds
against the port's plain suppression (``ops/nms.py suppress_plain``), and
the loader against cv2 within the JAX test's limits (mean |diff| < 2, p99 <=
12 grey levels; ratio and pads within 1e-6). A build that fails raises
with its cause; without libjpeg the loader is built with nvJPEG (card only:
``tests/test_torch_cuda.py``); ``yat-torch checks`` prints the build state.
"""

import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from yolo_ad_refine_tpu.ops import native as jax_native
from yolo_ad_refine_tpu.data.loaders import LoadImagesNative as JaxLoadImagesNative
from yolo_ad_refine_tpu_torch.cfg import cli
from yolo_ad_refine_tpu_torch.data.augment import letterbox_np
from yolo_ad_refine_tpu_torch.data.loaders import LoadImagesNative
from yolo_ad_refine_tpu_torch.ops import native
from yolo_ad_refine_tpu_torch.ops.nms import suppress_plain

SHAPES = [(97, 143), (200, 100), (64, 64), (480, 640)]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Seeded, blurred JPEGs (quality 95) of SHAPES, as the JAX test writes them."""
    root = tmp_path_factory.mktemp("jpegs")
    r = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate(SHAPES):
        img = cv2.GaussianBlur(r.integers(0, 255, (h, w, 3), np.uint8), (7, 7), 3)
        p = root / f"im{i}.jpg"
        cv2.imwrite(str(p), img, [cv2.IMWRITE_JPEG_QUALITY, 95])
        paths.append(p)
    return paths


def candidates(seed: int, n: int = 400, nc: int = 4):
    r = np.random.default_rng(seed)
    xy = r.uniform(0, 100, (n, 2))
    wh = r.uniform(5, 25, (n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    return boxes, r.uniform(0, 1, n).astype(np.float32), r.integers(0, nc, n).astype(np.float32)


def plain_nms(boxes, scores, cls, iou, conf, max_det, agnostic):
    """The port's plain greedy suppression over the score-sorted,
    class-offset candidates: kept indices, score-descending."""
    order = np.argsort(-scores, kind="stable")
    off = 0.0 if agnostic else (cls * 7680.0)[:, None]
    bx = torch.from_numpy((boxes + off)[order])[None]
    keep = suppress_plain(bx, torch.from_numpy(scores[order])[None], iou, conf)[0].numpy()
    return order[keep][:max_det]


@pytest.mark.parametrize("iou,conf,max_det,agnostic", [
    (0.45, 0.25, 300, False), (0.7, 0.001, 300, False), (0.45, 0.25, 300, True),
    (0.5, 0.1, 7, False)])
def test_nms_native_equals_jax_and_the_plain_suppression(iou, conf, max_det, agnostic):
    boxes, scores, cls = candidates(int(iou * 100) + max_det)
    got = native.nms_native(boxes, scores, cls, iou, conf, max_det, agnostic=agnostic)
    want = jax_native.nms_native(boxes, scores, cls, iou, conf, max_det, agnostic=agnostic)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got, plain_nms(boxes, scores, cls, iou, conf, max_det, agnostic))
    assert 0 < len(got) <= max_det


def test_nms_native_of_no_candidates():
    e = np.zeros((0, 4), np.float32)
    assert native.nms_native(e, e[:, 0], e[:, 0]).shape == (0,)


@pytest.mark.parametrize("shape", [(100, 200), (333, 77), (64, 64), (720, 1280)])
@pytest.mark.parametrize("scaleup", [True, False])
def test_letterbox_native_is_byte_equal_to_jax(shape, scaleup):
    img = np.random.default_rng(shape[0]).integers(0, 255, (*shape, 3), dtype=np.uint8)
    got = native.letterbox_native(img, 128, scaleup=scaleup)
    want = jax_native.letterbox_native(img, 128, scaleup=scaleup)
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]


def test_letterbox_native_near_cv2():
    """The JAX test's case (tests/test_native.py): 1 LSB from the cv2
    letterbox. (Where w * r is not whole, csrc/yat_ops.cpp samples at
    (x + 0.5) / r - 0.5, not at cv2's w / new_w scale: ROADMAP Queue 3.)"""
    img = np.random.default_rng(1).integers(0, 255, (100, 200, 3), dtype=np.uint8)
    out, ratio, pad = native.letterbox_native(img, 64)
    ref, ratio_p, pad_p = letterbox_np(img, (64, 64))
    assert ratio[0] == pytest.approx(ratio_p[0], abs=1e-5)
    assert pad == pytest.approx(pad_p, abs=0.5)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_load_image_native_is_byte_equal_to_jax_and_near_cv2(jpegs, i):
    img, hw, r, pad = native.load_image_native(jpegs[i], 96)
    want = jax_native.load_image_native(jpegs[i], 96)
    assert np.array_equal(img, want[0]) and (hw, r, pad) == want[1:]
    ref = cv2.imread(str(jpegs[i]))
    assert hw == ref.shape[:2]
    ref_lb, (rp, _), (dwp, dhp) = letterbox_np(ref, (96, 96))
    assert abs(r - rp) < 1e-6 and abs(pad[0] - dwp) < 1e-6 and abs(pad[1] - dhp) < 1e-6
    diff = np.abs(img.astype(int) - ref_lb.astype(int))
    assert diff.mean() < 2.0 and np.percentile(diff, 99) <= 12


def test_batch_loader_order_and_meta_equal_jax(jpegs):
    got = list(native.NativeBatchLoader(jpegs, imgsz=64, batch=3, threads=3))
    jl = jax_native.NativeBatchLoader(jpegs, imgsz=64, batch=3, threads=3)
    want = list(jl)
    jl.close()
    assert [b[0].shape[0] for b in got] == [3, 1]
    for (gi, gm), (wi, wm) in zip(got, want):
        assert np.array_equal(gi, wi) and np.array_equal(gm, wm)
    meta = np.concatenate([b[1] for b in got])
    assert meta[:, :2].tolist() == [list(s) for s in SHAPES]
    assert meta[2, 2] == 1.0  # 64 -> 64: ratio 1


def test_unreadable_file_is_skipped(jpegs, tmp_path):
    bad = tmp_path / "missing.jpg"
    noise = tmp_path / "noise.jpg"
    noise.write_bytes(b"not a jpeg at all")
    files = [jpegs[0], bad, noise, jpegs[2]]
    assert native.load_image_native(bad, 64) is None
    assert native.load_image_native(noise, 64) is None
    loader = native.NativeBatchLoader(files, imgsz=64, batch=4, threads=2)
    batches = list(loader)
    loader.close()
    assert sum(len(b[0]) for b in batches) == 2
    assert loader.indices.tolist() == [0, 3]


def test_load_images_native_over_a_folder_yields_jax_batches(jpegs):
    got = list(LoadImagesNative(jpegs[0].parent, imgsz=64, batch=3, threads=2))
    want = list(JaxLoadImagesNative(jpegs[0].parent, imgsz=64, batch=3, threads=2))
    assert len(got) == len(want) == 2
    for (gp, gi, gm), (wp, wi, wm) in zip(got, want):
        assert [Path(p) for p in gp] == [Path(p) for p in wp]
        assert np.array_equal(gi, wi) and np.array_equal(gm, wm)
    assert [Path(p).name for b in got for p in b[0]] == [f"im{i}.jpg" for i in range(4)]


def test_load_images_native_names_the_decoded_files_after_a_skip(jpegs, tmp_path):
    folder = tmp_path / "mixed"
    folder.mkdir()
    for name, src in (("a.jpg", jpegs[0]), ("c.jpg", jpegs[1]), ("d.jpg", jpegs[2])):
        (folder / name).write_bytes(src.read_bytes())
    (folder / "b.jpg").write_bytes(b"broken")
    got = list(LoadImagesNative(folder, imgsz=64, batch=2))
    assert [[Path(p).name for p in b[0]] for b in got] == [["a.jpg", "c.jpg"], ["d.jpg"]]
    assert got[0][2][1, :2].tolist() == list(SHAPES[1])  # c.jpg's meta beside its name


@pytest.fixture()
def fresh_build(monkeypatch):
    """The native module with no library loaded, so the next call builds,
    and no nvcc (as on this test image), so the nvJPEG loader cannot build."""
    monkeypatch.setattr(native, "_libs", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")

    monkeypatch.setattr(native.kernels, "nvcc_path", no_nvcc)
    return monkeypatch


@pytest.mark.parametrize("case,match", [
    ("compiler", "the C\\+\\+ compiler 'no-such-g\\+\\+' was not found"),
    ("header", "the libjpeg header jpeglib.h is missing"),
    ("library", "the libjpeg library \\(libjpeg.so\\) is missing"),
])
def test_a_failed_build_raises_with_its_cause(fresh_build, tmp_path, case, match):
    if case == "compiler":
        fresh_build.setattr(native, "CXX", "no-such-g++")
    elif case == "header":  # a copy of the loader whose header is not installed
        src = (native.CSRC / "yat_loader.cpp").read_text().replace(
            "#include <jpeglib.h>", "#include <no_such_dir/jpeglib.h>")
        (tmp_path / "yat_loader.cpp").write_text(src)
        fresh_build.setattr(native, "CSRC", tmp_path)
        fresh_build.setattr(native, "BUILD", tmp_path / "build")
    else:
        src, kind, pre, _ = native.BUILDS["yat_loader"]
        fresh_build.setattr(native, "BUILDS", {**native.BUILDS,
                                               "yat_loader": (src, kind, pre, ["-ljpeg_no_such"])})
    with pytest.raises(RuntimeError, match=match) as e:
        native.get_loader_lib()
    if case != "compiler":  # the compiler's log comes with it, and nvJPEG's cause
        assert "error" in str(e.value)
        assert "neither decoder builds" in str(e.value) and "nvcc not found" in str(e.value)
    with pytest.raises(RuntimeError, match=match):
        LoadImagesNative(tmp_path, imgsz=64)


def test_without_libjpeg_the_loader_is_built_with_nvjpeg(fresh_build, tmp_path):
    """Where libjpeg's header is missing, the loader's source is compiled
    again by nvcc with -DYAT_NVJPEG and -lnvjpeg; a failure there raises with
    both causes (no cv2 fallback)."""
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        log = "fatal error: jpeglib.h: No such file or directory" if len(calls) == 1 else \
            "fatal error: nvjpeg.h: No such file or directory"
        return subprocess.CompletedProcess(cmd, 1, "", log)

    fresh_build.setattr(native, "BUILD", tmp_path / "build")
    fresh_build.setattr(native.kernels, "nvcc_path", lambda: "fake-nvcc")
    fresh_build.setattr(native.subprocess, "run", run)
    with pytest.raises(RuntimeError, match="neither decoder builds") as e:
        native.get_loader_lib()
    assert calls[0][0] == native.CXX and calls[0][-1] == "-ljpeg"
    nv = calls[1]
    assert nv[0] == "fake-nvcc" and nv[-1] == "-lnvjpeg"
    assert nv[nv.index("-x") + 1] == "cu" and "-DYAT_NVJPEG" in nv
    assert nv[nv.index("-DYAT_NVJPEG") + 1].endswith("csrc/yat_loader.cpp")
    assert "jpeglib.h is missing" in str(e.value) and "nvJPEG (nvjpeg.h" in str(e.value)


def test_library_path_follows_source_compiler_and_flags(fresh_build):
    base = native.library_path("yat_loader")
    assert base.parent == native.BUILD and base.name.startswith("libyat_loader-")
    fresh_build.setattr(native, "CXX", "clang++")
    assert native.library_path("yat_loader") != base


def test_checks_print_the_native_lines(capsys):
    cli.checks()
    out = capsys.readouterr().out.splitlines()
    assert "native ops    ok" in out and "native loader ok (libjpeg)" in out


def test_checks_print_a_failed_build(fresh_build, capsys):
    fresh_build.setattr(native, "CXX", "no-such-g++")
    cli.checks()
    out = capsys.readouterr().out
    assert "native ops    unavailable: native yat_ops: the C++ compiler 'no-such-g++' was not " \
           "found" in out
    assert "native loader unavailable: native yat_loader:" in out
