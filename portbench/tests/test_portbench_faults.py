"""A whole run of each runner on the CPU, the look for a card skipped: sound,
it comes out correct; with the timed path broken underneath, in each way
the cell can break, it comes out not correct. The serving control, the
reference in bf16 in the program's place, comes out not correct too, and
so does the training control, the reference with fp8 products."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import correct, measure, tiny_serve, tiny_train


def program_with(predict_fault):
    """The program's YOLO with what its predict returns broken."""
    from yolo_ad_refine_tpu_torch import YOLO

    class Broken(YOLO):
        def predict(self, source=None, **kw):
            return predict_fault(super().predict(source, **kw))

    return Broken


def test_serve_sound_run_is_correct():
    out = measure(tiny_serve())
    assert correct(out), out["checks"]
    assert out["batches"] >= 2 and out["attempted"] == 2 * out["batches"]


def half_batch(res):
    return res[: len(res) // 2]


def altered_box(res):
    for r in res:
        if len(r.boxes):
            r.boxes.data[0, 0] += 3.0
            break
    return res


@pytest.mark.parametrize("fault", [half_batch, altered_box], ids=["half_batch", "altered_row"])
def test_serve_broken_answers_are_not_correct(fault):
    out = measure(tiny_serve(), program=program_with(fault))
    assert not correct(out), out["checks"]


def test_serve_altered_head_output_is_not_correct(monkeypatch):
    import yolo_ad_refine_tpu_torch.nn.head as head

    real = head.decode_detections

    def shifted(*a, **k):
        y = real(*a, **k)
        y[..., 0] += 8.0  # every produced box moved 8 px
        return y

    monkeypatch.setattr(head, "decode_detections", shifted)
    assert not correct(measure(tiny_serve()))


def test_serve_control_is_not_correct():
    from portbench.harness import held
    from portbench.limits import serve_control

    c = tiny_serve()
    checks = held(serve_control(c, 2 ** 33 + 7, 1.0, "cpu"), c["config"]["limits"]["serve"])
    assert not all(v <= lim for _, v, lim in checks), checks


def test_train_sound_run_is_correct():
    out = measure(tiny_train())
    assert correct(out), out["checks"]
    assert out["steps"] >= 1 and out["attempted"] == 2 * out["steps"]


def test_train_state_left_unchanged_is_not_correct(monkeypatch):
    from yolo_ad_refine_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "step", lambda self: False)
    out = measure(tiny_train())
    checks = dict((n, v) for n, v, _ in out["checks"])
    assert not correct(out) and checks["change_leaf"] > 0.9, out["checks"]


def test_train_half_batch_is_not_correct():
    """The loss leaves out half of a full forward's batch and takes the mean
    over the rest: the loss stage, held on the program's own head maps,
    fails."""
    from portbench.limits import half_batch_in_loss

    undo = half_batch_in_loss()
    try:
        out = measure(tiny_train())
    finally:
        undo()
    assert not correct(out) and out["numbers"]["loss_stage_rel"] > 0.1, out["checks"]


def test_train_control_is_not_correct():
    """The fp8 control, in the program's place on the program's batches,
    fails the cell's limits (row 1's output, where it parts from the
    reference and the program does not)."""
    from portbench import train
    from portbench.harness import held
    from portbench.limits import train_control

    kept = {}
    real = train.check

    def keep(cfg, tr, seed, nb, k, device):
        kept.update(k, nb=nb)
        return real(cfg, tr, seed, nb, k, device)

    train.check = keep
    try:
        c = tiny_train()
        program = measure(c)["numbers"]
    finally:
        train.check = real
    control = train_control(c, 2 ** 33 + 7, kept["batches"], kept["nb"], "cpu")
    checks = held(control, c["config"]["limits"]["train"])
    assert not all(v <= lim for _, v, lim in checks), checks
    assert control["row1_rel"] >= 3 * program["row1_rel"], (program, control)
