"""The frozen reference against the port at a tiny size on the CPU: the
same weights give the same head output, rows and loss."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference.loss import detection_loss
from portbench.reference.model import build
from portbench.reference.postprocess import nms, preprocess
from portbench.serve import model_dict
from portbench.weights import make_state

from conftest import tiny_train


@pytest.fixture(scope="module")
def pair():
    from yolo_ad_refine_tpu_torch import YOLO

    cfg = tiny_train()["config"]  # scale n, 256 px, the training prior of class 0
    state = make_state(cfg, 12345, "cpu")
    prog = YOLO(model_dict(cfg), device="cpu", imgsz=cfg["imgsz"])
    prog.model.load_state_dict(state)
    ref = build(cfg["yaml_path"], cfg["scale"])
    ref.load_state_dict(state)
    return cfg, prog, ref


def test_eval_output_and_rows(pair):
    from yolo_ad_refine_tpu_torch.engine.predictor import preprocess as port_preprocess
    from yolo_ad_refine_tpu_torch.ops.nms import non_max_suppression

    cfg, prog, ref = pair
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, s, dtype=np.uint8) for s in ((200, 300, 3), (300, 250, 3))]
    x, metas = preprocess(imgs, cfg["imgsz"], "cpu")
    xp, metas_p = port_preprocess(imgs, cfg["imgsz"], 2, torch.device("cpu"), torch.float32)
    assert torch.equal(x, xp)
    assert [(r, pad) for r, pad in metas] == [(r[0], pad) for r, pad in metas_p]
    with torch.no_grad():
        y_ref = ref.eval()(x)[0]
        y = prog.model.eval()(xp)[0]
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-4)
    rows, counts, valid = nms(y, 0.1, 0.7, 300)
    det, cnt, _ = non_max_suppression(y, conf_thres=0.1, iou_thres=0.7, max_det=300, nc=80)
    assert torch.equal(counts.int(), cnt) and int(cnt.sum()) > 0
    assert torch.equal(rows, det)
    assert (valid >= counts).all()


def test_loss_matches_the_port(pair):
    from yolo_ad_refine_tpu_torch.train.loss import DetectionLoss

    cfg, prog, ref = pair
    torch.manual_seed(0)
    x = torch.rand(2, 3, cfg["imgsz"], cfg["imgsz"])
    cls = torch.tensor([[[3.0], [0.0]], [[7.0], [0.0]]])
    boxes = torch.tensor([[[10.0, 20, 60, 90], [0, 0, 0, 0]], [[100.0, 40, 140, 70], [0, 0, 0, 0]]])
    mask = torch.tensor([[[1.0], [0.0]], [[1.0], [0.0]]])
    with torch.no_grad():
        maps = ref.train()(x)
        maps_p = prog.model.train()(x)
    for a, b in zip(maps, maps_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
    comps, total = detection_loss(maps, cls, boxes, mask, 80)
    out = DetectionLoss(80, (8, 16, 32))(maps, cls, boxes, mask)
    torch.testing.assert_close(comps, out.components, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(total, out.total, rtol=1e-5, atol=1e-5)
