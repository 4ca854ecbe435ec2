"""The port's public functions called as the JAX package's are, with JAX's
positional arguments, against the JAX functions on the CPU: the values
behind the signature walk of ``tests/test_torch_api_surface.py``.

- ``increment_path`` numbers a file before its suffix (with and without
  ``sep``) and a directory after its name; ``yaml_save`` writes its header
  first; both give JAX's files byte for byte.
- ``letterbox`` with JAX's eight positional arguments and a tuple colour is
  within one grey level of JAX's (cv2 rounds its resize in fixed point);
  ``scale_fill=True`` stretches with no pad, as the reference's LetterBox
  does, where the JAX function ignores the argument, and an int colour
  pads every channel, where cv2 pads (v, 0, 0) (ROADMAP hazard (w)).
- ``modulated_deform_conv2d`` with a bias, and at k = 5 on the plain path,
  within 1e-5 of JAX's (NHWC -> NCHW, HWIO -> OIHW); an even k raises.
- ``YOLODataset``, ``YOLO``, ``sync_hosts`` and
  ``maybe_initialize_distributed`` bind JAX's positional calls.
"""

import inspect

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_ad_refine_tpu import utils as jax_utils
from yolo_ad_refine_tpu.data.augment import letterbox as jax_letterbox
from yolo_ad_refine_tpu.data.dataset import YOLODataset as JaxDataset
from yolo_ad_refine_tpu.ops.deform import modulated_deform_conv2d as jax_dcn
from yolo_ad_refine_tpu_torch import utils
from yolo_ad_refine_tpu_torch.data.augment import letterbox
from yolo_ad_refine_tpu_torch.data.dataset import YOLODataset
from yolo_ad_refine_tpu_torch.ops.deform import modulated_deform_conv2d
from yolo_ad_refine_tpu_torch.parallel import multihost


@pytest.mark.parametrize("sep", ["", "_"])
def test_increment_path_numbers_a_file_before_its_suffix(tmp_path, sep):
    for root, mod in (("jax", jax_utils), ("port", utils)):
        d = tmp_path / root
        d.mkdir()
        (d / "results.csv").write_text("x")
        first = mod.increment_path(d / "results.csv", sep=sep)
        assert first == d / f"results{sep}2.csv"
        first.write_text("y")
        assert mod.increment_path(d / "results.csv", False, sep) == d / f"results{sep}3.csv"
        assert mod.increment_path(d / "results.csv", exist_ok=True) == d / "results.csv"
        (d / "exp").mkdir()
        assert mod.increment_path(d / "exp", False, sep, True) == d / f"exp{sep}2"
        assert (d / f"exp{sep}2").is_dir()
        assert mod.increment_path(d / "new.csv", sep=sep) == d / "new.csv"


def test_yaml_save_writes_the_header_first(tmp_path):
    data = {"lr0": 0.01, "path": tmp_path / "x", "n": np.int64(3)}
    header = "# written by the trainer\n"
    jax_utils.yaml_save(tmp_path / "jax.yaml", data, header)
    utils.yaml_save(tmp_path / "port.yaml", data, header)
    text = (tmp_path / "port.yaml").read_text()
    assert text == (tmp_path / "jax.yaml").read_text()
    assert text.startswith(header) and utils.yaml_load(tmp_path / "port.yaml")["n"] == 3


def _image(h=50, w=83, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("args", [
    ((64, 96), (1, 2, 3), False, False, True, True, 32),
    (64, (114, 114, 114), True, False, False, True, 16),
    ((96, 64), (7, 7, 7), False, False, True, False, 32),
])
def test_letterbox_takes_jax_positional_arguments(args):
    img = _image()
    want, wr, wp = jax_letterbox(img, *args)
    got, gr, gp = letterbox(img, *args)
    assert got.shape == want.shape and gr == wr and gp == wp
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


def test_letterbox_int_color_pads_every_channel():
    """An int colour is that grey in every channel (hazard (w): the JAX
    letterbox hands it to cv2, which pads (v, 0, 0))."""
    img = _image()
    got, _, _ = letterbox(img, (96, 64), 7)
    want, _, _ = letterbox(img, (96, 64), (7, 7, 7))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got[0] == 7).all()
    jax_int, _, _ = jax_letterbox(img, (96, 64), 7)
    assert tuple(jax_int[0, 0]) == (7, 0, 0)


@pytest.mark.parametrize("new_shape", [(64, 64), (48, 100)])
def test_letterbox_scale_fill_stretches_without_pad(new_shape):
    img = _image()
    got, ratio, pad = letterbox(img, new_shape, (1, 2, 3), False, True)
    want = cv2.resize(img, new_shape[::-1], interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape and pad == (0.0, 0.0)
    assert ratio == (new_shape[1] / img.shape[1], new_shape[0] / img.shape[0])
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    # hazard (w): the JAX letterbox takes scale_fill and pads as without it
    jax_fill, jax_ratio, _ = jax_letterbox(img, new_shape, (1, 2, 3), False, True)
    plain, plain_ratio, _ = jax_letterbox(img, new_shape, (1, 2, 3), False, False)
    np.testing.assert_array_equal(jax_fill, plain)
    assert jax_ratio == plain_ratio


def _dcn_inputs(k, b=2, h=7, w=9, c=8, cout=6, seed=0):
    r = np.random.default_rng(seed)
    kk = k * k
    x = r.normal(0, 1, (b, h, w, c)).astype(np.float32)
    off = r.normal(0, 1.5, (b, h, w, 2 * kk)).astype(np.float32)
    mask = r.random((b, h, w, kk)).astype(np.float32)
    weight = r.normal(0, 0.2, (k, k, c, cout)).astype(np.float32)
    bias = r.normal(0, 1, (cout,)).astype(np.float32)
    return x, off, mask, weight, bias


def _port_dcn(x, off, mask, weight, *rest, **kw):
    nchw = [torch.from_numpy(a).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            for a in (x, off, mask)]
    y = modulated_deform_conv2d(*nchw, torch.from_numpy(weight).permute(3, 2, 0, 1),
                                *(None if a is None else torch.from_numpy(a)
                                  if isinstance(a, np.ndarray) else a for a in rest), **kw)
    return y.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("k,with_bias", [(3, True), (5, False), (5, True), (1, True)])
def test_modulated_deform_conv2d_bias_and_k_match_jax(k, with_bias):
    x, off, mask, weight, bias = _dcn_inputs(k, seed=k)
    bias = bias if with_bias else None
    want = np.asarray(jax_dcn(*(jnp.asarray(a) for a in (x, off, mask, weight)),
                              None if bias is None else jnp.asarray(bias), k))
    got = _port_dcn(x, off, mask, weight, bias, k)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_modulated_deform_conv2d_k5_is_differentiable_and_even_k_raises():
    x, off, mask, weight, bias = _dcn_inputs(5)
    ins = [torch.from_numpy(a).permute(0, 3, 1, 2).requires_grad_() for a in (x, off, mask)]
    w = torch.from_numpy(weight).permute(3, 2, 0, 1).detach().requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    y = modulated_deform_conv2d(*ins, w, b, 5)
    assert y.is_contiguous(memory_format=torch.channels_last)
    y.square().sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in (*ins, w, b))
    with pytest.raises(ValueError, match="k=4"):
        modulated_deform_conv2d(*ins, w[..., :4, :4], None, 4)
    with pytest.raises(ValueError, match="not"):
        modulated_deform_conv2d(*ins, w, None, 3)


def test_modulated_deform_conv2d_radius_is_keyword_only():
    x, off, mask, weight, _ = _dcn_inputs(3, seed=9)
    params = inspect.signature(modulated_deform_conv2d).parameters
    assert list(params) == ["x", "offset", "mask", "weight", "bias", "k", "radius"]
    assert params["radius"].kind is inspect.Parameter.KEYWORD_ONLY
    clipped = _port_dcn(x, off * 3, mask, weight, radius=1)
    unbounded = _port_dcn(x, off * 3, mask, weight)
    assert np.abs(clipped - unbounded).max() > 1e-3


def test_yolo_dataset_binds_jax_positional_arguments(tmp_path):
    from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset

    data = make_shapes_dataset(tmp_path / "ds", n_train=2, n_val=3, imgsz=64, seed=1)
    val = f"{data['path']}/{data['val']}" if "path" in data else data["val"]
    args = (val, 64, False, None, 8, 3, 1.0, False, "detect", None, None, False)
    ours, ref = YOLODataset(*args), JaxDataset(*args)
    assert ours.im_files == ref.im_files and ours.max_boxes == ref.max_boxes == 8
    assert ours.nc == ref.nc == 3 and ours.cache_images is ref.cache_images is False
    for i in range(len(ours)):
        a, b = ours.get_sample(i, np.random.default_rng(i)), ref.get_sample(
            i, np.random.default_rng(i))
        np.testing.assert_array_equal(a["img"], b["img"])
        np.testing.assert_allclose(a["bboxes"], b["bboxes"], atol=1e-6)
    # cache=True is accepted; the port parses the labels anyway and writes no cache file
    YOLODataset(val, 64, cache=True)
    assert not list((tmp_path / "ds").rglob(".yat_labels_*"))


def test_yolo_binds_jax_positional_arguments():
    from yolo_ad_refine_tpu.models.yolo import YOLO as JaxYOLO
    from yolo_ad_refine_tpu_torch import YOLO

    jax_params = list(inspect.signature(JaxYOLO.__init__).parameters)
    assert list(inspect.signature(YOLO.__init__).parameters)[:len(jax_params)] == jax_params
    cfg = {"nc": 2, "backbone": [[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                                 [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                                 [-1, 1, "Conv", [16, 3, 2]]],
           "head": [[[2, 3, 4], 1, "Detect", ["nc"]]]}
    m = YOLO(cfg, "detect", 5, torch.float32, 0, 64, False, device="cpu")
    assert m.model.nc == 5 and m.imgsz == 64


def test_sync_hosts_and_initialize_take_jax_calls(monkeypatch):
    for v in ("RANK", "WORLD_SIZE", "YAT_COORDINATOR", "YAT_NUM_PROCESSES"):
        monkeypatch.delenv(v, raising=False)
    assert multihost.maybe_initialize_distributed() is False
    assert multihost.sync_hosts("checkpoint") is None
    assert multihost.sync_hosts() is None
