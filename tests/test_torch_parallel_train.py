"""The PyTorch port's trainer on two gloo ranks on the CPU (``YOLO.train``
under torchrun's environment, ``tests/torch_parallel_worker.py``), against
the same run in one process.

The model is five convs and the flagship's AYHead (its DCN records
dcn_offset_max), at imgsz 64 on a seeded shapes set (8 train, 4 val
images), global batch 4 with nbs 16: gradients of 4 batches are summed
before a step, so the first epoch's 2 batches end with a summed gradient
and no step, and the ``last`` written after it holds that gradient (FSDP2's
sharded one gathered, DDP's local ones averaged).

Held: the two-rank FSDP2 epoch's results.csv row equals the one-process
row (the losses, the validation, the learning rates and dcn_offset_max,
1e-5 relative, as the step tests hold the parameters); both ranks share one
save_dir; the two-rank ``last`` (written by rank 0, the one-process
layout) loads in ``YOLO(dir)`` and holds the one-process ``last``'s
weights, optimizer state and summed gradient; resumed for a second epoch
in one process it gives the one-process resume's row, and the
one-process ``last`` resumed on two DDP ranks gives it too. ``fsdp=True``
without a launcher trains as the plain run, as a one-device mesh does in
JAX.
"""

import csv

import pytest
import torch
import yaml

from torch_parallel_worker import run_ranks
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset

TINY_AY = {  # tests/test_torch_checkpoint.py's: five convs and the flagship's head
    "nc": 3,
    "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [128, 3, 2]],
                 [-1, 1, "Conv", [256, 3, 2]]],
    "head": [[[2, 3, 4], 1, "AYHead", ["nc"]]],
}
ARGS = dict(epochs=1, batch=4, imgsz=64, plots=False, optimizer="SGD", warmup_epochs=0.0,
            close_mosaic=0, nbs=16, workers=2, device="cpu", exist_ok=True)
TIMEOUT_S = 150


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def rows(save_dir) -> list[dict]:
    with open(f"{save_dir}/results.csv") as f:
        return [{k: float(v) for k, v in r.items() if k != "time"} for r in csv.DictReader(f)]


def hold_row(got: dict, want: dict, tol: float = 1e-5) -> None:
    bad = {k: (got[k], v) for k, v in want.items() if abs(got[k] - v) > tol * max(abs(v), 1e-6)}
    assert not bad, bad


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks_train")
    cfg = tmp / "tiny_ay.yaml"
    cfg.write_text(yaml.safe_dump(TINY_AY))
    data = make_shapes_dataset(tmp / "ds", n_train=8, n_val=4, imgsz=64, seed=3)

    def one(name, **kw):
        model = YOLO(str(cfg), device="cpu", imgsz=64, seed=1)
        return model.train(data=data, project=str(tmp / "one"), name=name, **{**ARGS, **kw})

    out = {"one": one("a"), "one_fsdp": one("fsdp", fsdp=True)}
    one_last, two_last = tmp / "one" / "a" / "weights" / "last", tmp / "two" / "a" / "weights" / "last"
    # one start-up of two ranks for both of their runs: FSDP2 from the start,
    # and DDP resuming the one-process last
    out["two"], out["one_resumed_on_two"] = run_ranks({
        "scenario": "train", "out": str(tmp / "ranks"), "timeout_s": TIMEOUT_S, "device": "cpu",
        "cfg": str(cfg), "seed": 1, "threads": 1,
        "runs": [{"out": str(tmp / f"ranks_{name}"),
                  "train": {"data": data, "project": str(tmp / "two"), "name": name, **ARGS, **kw}}
                 for name, kw in (("a", {"fsdp": True}),
                                  ("resumed", {"epochs": 2, "resume": str(one_last)}))]},
        world=2)
    out["one_resumed"] = one("resumed", epochs=2, resume=str(one_last))
    out["two_resumed_in_one"] = one("resumed_two", epochs=2, resume=str(two_last))
    out.update(one_last=one_last, two_last=two_last)
    return out


def test_two_rank_fsdp_epoch_matches_one_process(runs):
    (want,), (got,) = rows(runs["one"]["save_dir"]), rows(runs["two"][0]["results"]["save_dir"])
    hold_row(got, want)
    assert want["train/dcn_offset_max"] > 0
    assert runs["two"][0]["results"]["save_dir"] == runs["two"][1]["results"]["save_dir"]
    assert [r["backend"] for r in runs["two"]] == ["gloo", "gloo"]


def test_fsdp_without_a_launcher_is_the_plain_run(runs):
    assert rows(runs["one_fsdp"]["save_dir"]) == rows(runs["one"]["save_dir"])


def test_two_rank_last_loads_and_holds_the_one_process_state(runs):
    got, want = YOLO(str(runs["two_last"]), device="cpu"), YOLO(str(runs["one_last"]), device="cpu")
    ref = want.model.state_dict()
    for k, v in got.model.state_dict().items():
        torch.testing.assert_close(v, ref[k], rtol=1e-5, atol=1e-6)
    g, w = (torch.load(p / "train.pt") for p in (runs["two_last"], runs["one_last"]))
    assert g["optimizer"]["batches"] == w["optimizer"]["batches"] == 2
    assert g["optimizer"]["steps"] == w["optimizer"]["steps"] == 0
    acc = [(a, b) for a, b in zip(g["optimizer"]["acc_grads"], w["optimizer"]["acc_grads"])]
    assert acc and all(b is not None for _, b in acc)  # a summed gradient waits for its step
    # as one vector: leaves whose sums cancel (a conv bias ahead of a BatchNorm)
    # carry fp32 noise of their own size. One process's own summed gradient
    # moves by 2.7e-5 of its norm with the count of intra-op threads; a
    # gradient left local or a shard left out moves it by more than 1e-1
    a, b = (torch.cat([t.flatten() for t in ts]) for ts in zip(*acc))
    assert ((a - b).norm() / b.norm()).item() <= 1e-4
    for k, v in w["model"].items():
        torch.testing.assert_close(g["model"][k], v, rtol=1e-5, atol=1e-6)


def test_resumes_cross_between_two_ranks_and_one_process(runs):
    (want,) = rows(runs["one_resumed"]["save_dir"])
    assert want["epoch"] == 1
    (in_one,) = rows(runs["two_resumed_in_one"]["save_dir"])
    hold_row(in_one, want)
    (on_two,) = rows(runs["one_resumed_on_two"][0]["results"]["save_dir"])
    hold_row(on_two, want)
