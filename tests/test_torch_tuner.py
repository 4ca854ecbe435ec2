"""The PyTorch port's Tuner (``engine/tuner.py``) against the JAX package's:
``_mutate`` gives the same hyperparameters, bit for bit, for the same
tune_results.csv history and generator seed (single and weighted parents,
one to seven rows of history, and none), within the search space's bounds;
and ``YOLO.tune`` for two iterations of a small model at imgsz 64 on the
CPU writes the CSV, best_hyperparameters.yaml and the best weights, its
second iteration drawing what the JAX ``_mutate`` draws from the first
row. Everything is written under pytest's tmp_path."""

import numpy as np
import pytest
import torch
import yaml

from yolo_ad_refine_tpu.engine.tuner import DEFAULT_SPACE as JAX_SPACE
from yolo_ad_refine_tpu.engine.tuner import Tuner as JaxTuner
from yolo_ad_refine_tpu_torch import YOLO
from yolo_ad_refine_tpu_torch.data.synthetic import make_shapes_dataset
from yolo_ad_refine_tpu_torch.engine.tuner import DEFAULT_SPACE, Tuner
from yolo_ad_refine_tpu_torch.utils import yaml_save

TINY = {
    "nc": 3,
    "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                 [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [64, 3, 2]],
                 [-1, 1, "Conv", [64, 3, 2]]],
    "head": [[[2, 3, 4], 1, "Detect", ["nc"]]],
}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this file's torch work: the suite runs six
    workers on the host's cores, where more threads a worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def history(rows: int, seed: int) -> str:
    """A tune_results.csv: random fitness and values inside the bounds."""
    r = np.random.default_rng(seed)
    lines = [",".join(["fitness", *DEFAULT_SPACE])]
    for _ in range(rows):
        vals = [round(float(r.uniform(lo, hi)), 5) for lo, hi, *_ in DEFAULT_SPACE.values()]
        lines.append(",".join(map(str, [round(float(r.uniform(0, 0.6)), 5), *vals])))
    return "\n".join(lines) + "\n"


def test_search_space_is_the_jax_packages():
    assert DEFAULT_SPACE == JAX_SPACE and list(DEFAULT_SPACE) == list(JAX_SPACE)


@pytest.mark.parametrize("rows", [0, 1, 3, 7])
@pytest.mark.parametrize("parent", ["single", "weighted"])
def test_mutate_is_the_jax_packages_bit_for_bit(tmp_path, rows, parent):
    args = {"lr0": 0.02, "box": 9.0, "seed": 3}
    port = Tuner({**args, "project": str(tmp_path / "port")})
    jax_t = JaxTuner({**args, "project": str(tmp_path / "jax")})
    if rows:
        text = history(rows, seed=rows)
        port.tune_csv.write_text(text)
        jax_t.tune_csv.write_text(text)
    for seed in range(6):
        got = port._mutate(np.random.default_rng(seed), parent=parent)
        want = jax_t._mutate(np.random.default_rng(seed), parent=parent)
        assert list(got) == list(want) and got == want  # floats compared exactly
        for k, (lo, hi, *_) in DEFAULT_SPACE.items():
            assert lo <= got[k] <= hi, k
    if not rows:
        assert got["lr0"] == 0.02 and got["box"] == 9.0


def test_two_iteration_tune_writes_its_results(tmp_path):
    yaml_save(tmp_path / "tiny.yaml", TINY)
    data = make_shapes_dataset(tmp_path / "ds", n_train=4, n_val=2, imgsz=64, seed=5)
    model = YOLO(str(tmp_path / "tiny.yaml"), device="cpu", imgsz=64)
    best = model.tune(iterations=2, data=data, epochs=1, batch=2, imgsz=64, workers=2,
                      project=str(tmp_path / "runs"), seed=7)
    tune = tmp_path / "runs" / "tune"
    csv = (tune / "tune_results.csv").read_text().splitlines()
    assert len(csv) == 3 and csv[0] == ",".join(["fitness", *DEFAULT_SPACE])
    assert yaml.safe_load((tune / "best_hyperparameters.yaml").read_text()) == best
    assert set(best) == set(DEFAULT_SPACE)
    assert (tune / "weights" / "best" / "weights.pt").exists()
    assert (tune / "weights" / "last" / "train.pt").exists()

    # the second iteration drew from the first row, as the JAX tuner would
    jax_t = JaxTuner({"project": str(tmp_path / "jax")})
    jax_t.tune_csv.write_text("\n".join(csv[:2]) + "\n")
    want = jax_t._mutate(np.random.default_rng(7 + 1))
    assert [float(v) for v in csv[2].split(",")[1:]] == [want[k] for k in DEFAULT_SPACE]
