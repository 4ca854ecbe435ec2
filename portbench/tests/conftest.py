"""Fixtures of the benchmark's CPU tests: the cells cut to a size the CPU
holds (the flagship at scale n, 256 px, batch 2), each held to its own
cell's limits."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness


@pytest.fixture(scope="session", autouse=True)
def few_threads():
    torch.set_num_threads(4)


def tiny_serve():
    c = harness.cell("ad-refine-n.serve-b32")
    c["config"]["imgsz"] = 256
    c["traffic"].update(batch=2, pool=4, shapes=[[200, 300], [300, 200]], warmup_batches=1,
                        check_batches=1, check_within=2, trace_batches=2, probe_images=2)
    return c


def tiny_train():
    c = harness.cell("ad-refine-x.train-b48")
    n = tiny_serve()["config"]  # scale n at 256 px; the x configuration's limits and prior
    c["config"].update(scale=n["scale"], scales=n["scales"], imgsz=n["imgsz"])
    c["traffic"].update(batch=2, image_size=[256, 192], objects=[3, 8], radius=[4, 10],
                        max_images_per_s=4, warmup_steps=3, trace_steps=1)
    c["traffic"]["settings"]["nbs"] = 2
    return c


def measure(c, program=None, seed=2 ** 33 + 7):
    from portbench.run import measure as m

    kw = {"program": program} if program is not None else {}
    return m(c, seed, 1.0, False, time.perf_counter(), device="cpu", **kw)


def correct(out) -> bool:
    return all(v <= lim for _, v, lim in out["checks"])
